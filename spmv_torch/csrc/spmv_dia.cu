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
// read too, and are served from L1/L2. Accumulation is in fp32 for fp32 and
// bf16 storage (as the TPU kernel does; bf16 y is rounded once, at the
// store) and in fp64 for fp64; index math is 64-bit. wgmma/TMA and tuning
// are later work.
//
// The offsets are read from device memory (a K-long int64 array the
// wrapper keeps on the card), so K has no cap: the Galerkin coarse levels
// of AMG's 1-D interval aggregation store hundreds of diagonals. Every
// thread of the grid reads the same offset at step k, a broadcast served
// from L1.
//
// The symmetric kernel stores offsets <= 0 only and computes the transpose
// term y[i] += d_o[i-o] * x~[i-o] as a gather: no atomics, no carry, no
// delayed write (the TPU's one-tile carry exists only because its grid runs
// in order).
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// storage type -> accumulation type, and the conversions between them
template <typename T> struct DiaAcc { typedef T type; };
template <> struct DiaAcc<__nv_bfloat16> { typedef float type; };
__device__ __forceinline__ float dia_load(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float dia_load(float v) { return v; }
__device__ __forceinline__ double dia_load(double v) { return v; }
template <typename T> __device__ __forceinline__ T dia_store(typename DiaAcc<T>::type v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 dia_store<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long npad, int ndiags,
                                const long long* __restrict__ offs) {
  typedef typename DiaAcc<T>::type Acc;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const long long row_stride = (long long)ndiags * 128;
  const T* xs = x + shard * npad;
  const T* drow = data + shard * npad * ndiags + (i >> 7) * row_stride + (i & 127);
  Acc acc = Acc(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long j = i + __ldg(offs + k);
    const Acc xv = (j >= 0 && j < npad) ? dia_load(xs[j]) : Acc(0);
    acc += dia_load(drow[(long long)k * 128]) * xv;
  }
  y[shard * npad + i] = dia_store<T>(acc);
}

template <typename T>
__global__ void dia_sym_spmv_kernel(const T* __restrict__ data,
                                    const T* __restrict__ x, T* __restrict__ y,
                                    long long npad, int ndiags,
                                    const long long* __restrict__ offs) {
  typedef typename DiaAcc<T>::type Acc;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const long long row_stride = (long long)ndiags * 128;
  const T* xs = x + shard * npad;
  const T* ds = data + shard * npad * ndiags;
  const T* drow = ds + (i >> 7) * row_stride + (i & 127);
  Acc acc = Acc(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long o = __ldg(offs + k);  // o <= 0
    const long long j = i + o;
    const Acc xv = (j >= 0) ? dia_load(xs[j]) : Acc(0);
    acc += dia_load(drow[(long long)k * 128]) * xv;
    if (o < 0) {
      // transpose of the stored entry A[t, t+o] at t = i-o lands on row i
      const long long t = i - o;
      if (t < npad) {
        acc += dia_load(ds[(t >> 7) * row_stride + (long long)k * 128 + (t & 127)]) *
               dia_load(xs[t]);
      }
    }
  }
  y[shard * npad + i] = dia_store<T>(acc);
}

template <typename T, bool kSymmetric>
static int launch(const void* data, const void* x, void* y, long long npad,
                  int ndiags, const long long* offsets, int nshards,
                  void* stream) {
  if (ndiags < 1 || npad < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const dim3 grid((unsigned)((npad + threads - 1) / threads), (unsigned)nshards);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kSymmetric) {
    dia_sym_spmv_kernel<T><<<grid, threads, 0, s>>>(
        static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), npad, ndiags, offsets);
  } else {
    dia_spmv_kernel<T><<<grid, threads, 0, s>>>(
        static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), npad, ndiags, offsets);
  }
  return (int)cudaGetLastError();
}

#define DIA_SPMV_ENTRY(NAME, T, SYM)                                        \
  int NAME(const void* data, const void* x, void* y, long long npad,        \
           int ndiags, const long long* offsets, int nshards, void* stream) { \
    return launch<T, SYM>(data, x, y, npad, ndiags, offsets, nshards,       \
                          stream);                                          \
  }

// `offsets`: a device pointer to ndiags int64 offsets
extern "C" {
DIA_SPMV_ENTRY(dia_spmv_f32, float, false)
DIA_SPMV_ENTRY(dia_spmv_f64, double, false)
DIA_SPMV_ENTRY(dia_spmv_bf16, __nv_bfloat16, false)
DIA_SPMV_ENTRY(dia_sym_spmv_f32, float, true)
DIA_SPMV_ENTRY(dia_sym_spmv_f64, double, true)
DIA_SPMV_ENTRY(dia_sym_spmv_bf16, __nv_bfloat16, true)
}  // extern "C"
