// DIA SpMV kernels for Hopper (sm_90a), vanilla and symmetric storage.
//
// Replaces the Pallas TPU kernels of spmv_tpu/ops/spmv_dia_pallas.py:
//   dia_spmv      <- _dia_kernel      (:191, wrapper _spmv_dia_pallas_2d :602)
//   dia_sym_spmv  <- _dia_sym_kernel  (:265, wrapper _spmv_dia_sym_pallas_2d :498)
//
// Layout (spmv_torch/formats/dia.py): D shards stacked, each shard's data
// is (npad/128, K*128) with data[s, r, k*128 + l] = A_s[128r+l, 128r+l+off_k];
// x and y are (D, npad). x~[s, j] = x[s, j] for 0 <= j < npad and 0 otherwise:
// a shard never reads its neighbour's entries (the remote ELL term of the
// distributed operator already adds those).
//
// Bound: bytes. One apply moves (K+2)*npad*itemsize per shard for vanilla
// storage, and (K_sym+2)*npad*itemsize plus cache-served shifted reads for
// symmetric storage; arithmetic is 2 flops per stored element.
// Design: one thread per output row, blockIdx.y = shard, so D shards take
// one launch. The warp's 32 neighbouring rows read 32 contiguous elements of
// each diagonal: one coalesced pass over `data`. The shifted x reads (and the
// transpose term's shifted data reads) touch lines that neighbouring warps
// read too, and are served from L1/L2. Accumulation is in the storage type
// (fp32 for fp32, as the TPU kernel does; fp64 for fp64); index math is
// 64-bit. wgmma/TMA and tuning are later work.
//
// The symmetric kernel stores offsets <= 0 only and computes the transpose
// term y[i] += d_o[i-o] * x~[i-o] as a gather: no atomics, no carry, no
// delayed write (the TPU's one-tile carry exists only because its grid runs
// in order).
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#define SPMV_DIA_MAX_DIAGS 64

struct DiaOffsets {
  long long off[SPMV_DIA_MAX_DIAGS];
};

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long npad, int ndiags, DiaOffsets offs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const long long row_stride = (long long)ndiags * 128;
  const T* xs = x + shard * npad;
  const T* drow = data + shard * npad * ndiags + (i >> 7) * row_stride + (i & 127);
  T acc = T(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long j = i + offs.off[k];
    const T xv = (j >= 0 && j < npad) ? xs[j] : T(0);
    acc += drow[(long long)k * 128] * xv;
  }
  y[shard * npad + i] = acc;
}

template <typename T>
__global__ void dia_sym_spmv_kernel(const T* __restrict__ data,
                                    const T* __restrict__ x, T* __restrict__ y,
                                    long long npad, int ndiags, DiaOffsets offs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const long long row_stride = (long long)ndiags * 128;
  const T* xs = x + shard * npad;
  const T* ds = data + shard * npad * ndiags;
  const T* drow = ds + (i >> 7) * row_stride + (i & 127);
  T acc = T(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long o = offs.off[k];  // o <= 0
    const long long j = i + o;
    const T xv = (j >= 0) ? xs[j] : T(0);
    acc += drow[(long long)k * 128] * xv;
    if (o < 0) {
      // transpose of the stored entry A[t, t+o] at t = i-o lands on row i
      const long long t = i - o;
      if (t < npad) {
        acc += ds[(t >> 7) * row_stride + (long long)k * 128 + (t & 127)] * xs[t];
      }
    }
  }
  y[shard * npad + i] = acc;
}

template <typename T, bool kSymmetric>
static int launch(const void* data, const void* x, void* y, long long npad,
                  int ndiags, const long long* offsets, int nshards,
                  void* stream) {
  if (ndiags < 1 || ndiags > SPMV_DIA_MAX_DIAGS || npad < 1 || nshards < 1 ||
      nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  DiaOffsets offs = {};
  for (int k = 0; k < ndiags; ++k) offs.off[k] = offsets[k];
  const int threads = 256;
  const dim3 grid((unsigned)((npad + threads - 1) / threads), (unsigned)nshards);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kSymmetric) {
    dia_sym_spmv_kernel<T><<<grid, threads, 0, s>>>(
        static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), npad, ndiags, offs);
  } else {
    dia_spmv_kernel<T><<<grid, threads, 0, s>>>(
        static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), npad, ndiags, offs);
  }
  return (int)cudaGetLastError();
}

extern "C" {

int dia_spmv_f32(const void* data, const void* x, void* y, long long npad,
                 int ndiags, const long long* offsets, int nshards, void* stream) {
  return launch<float, false>(data, x, y, npad, ndiags, offsets, nshards, stream);
}

int dia_spmv_f64(const void* data, const void* x, void* y, long long npad,
                 int ndiags, const long long* offsets, int nshards, void* stream) {
  return launch<double, false>(data, x, y, npad, ndiags, offsets, nshards, stream);
}

int dia_sym_spmv_f32(const void* data, const void* x, void* y, long long npad,
                     int ndiags, const long long* offsets, int nshards,
                     void* stream) {
  return launch<float, true>(data, x, y, npad, ndiags, offsets, nshards, stream);
}

int dia_sym_spmv_f64(const void* data, const void* x, void* y, long long npad,
                     int ndiags, const long long* offsets, int nshards,
                     void* stream) {
  return launch<double, true>(data, x, y, npad, ndiags, offsets, nshards, stream);
}

}  // extern "C"
