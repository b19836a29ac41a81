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
// Bound: bytes. One apply moves (K+2)*npad*itemsize per shard (K_sym
// stored diagonals in symmetric storage); arithmetic is 2 flops per stored
// element (4 for a symmetric off-diagonal).
//
// dia_spmv: one thread per output row, blockIdx.y = shard, so D shards take
// one launch. The warp's 32 neighbouring rows read 32 contiguous elements of
// each diagonal: one coalesced pass over `data`; the shifted x reads touch
// lines that neighbouring warps read too, and are served from L1/L2. The
// offsets are read from device memory (a K-long int64 array the wrapper
// keeps on the card), so K has no cap: the Galerkin coarse levels of AMG's
// 1-D interval aggregation store hundreds of diagonals. Accumulation is in
// fp32 for fp32 and bf16 storage (bf16 y is rounded once, at the store)
// and in fp64 for fp64; index math is 64-bit.
//
// dia_sym_spmv is the tile kernel of dia_window.cuh: a CTA stages its x
// windows and its rows of each diagonal (the transpose term's rows too) in
// shared memory with bulk copies of the Tensor Memory Accelerator, as a
// plan made once per operator lays them out, and sums from there. Run on
// the card, the one-thread-a-row symmetric kernel it replaces kept too few
// bytes in flight (a runtime loop of 2- to 8-byte loads, two gathers a
// stored diagonal): 1.7x its bound in fp32, 3.1x in bf16 (PERF.md). It
// stores offsets <= 0 only and computes the transpose term y[i] += d_o[i-o] *
// x~[i-o] as a gather: no atomics, no carry, no delayed write (the TPU's
// one-tile carry exists only because its grid runs in order).
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_window.cuh"

template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long npad, int ndiags,
                                const long long* __restrict__ offs) {
  typedef typename dia_window::Acc<T>::type Acc;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const long long row_stride = (long long)ndiags * 128;
  const T* xs = x + shard * npad;
  const T* drow = data + shard * npad * ndiags + (i >> 7) * row_stride + (i & 127);
  Acc acc = Acc(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long j = i + __ldg(offs + k);
    const Acc xv = (j >= 0 && j < npad) ? dia_window::load(xs[j]) : Acc(0);
    acc += dia_window::load(drow[(long long)k * 128]) * xv;
  }
  y[shard * npad + i] = dia_window::store<T>(acc);
}

template <typename T>
static int launch(const void* data, const void* x, void* y, long long npad,
                  int ndiags, const long long* offsets, int nshards,
                  void* stream) {
  if (ndiags < 1 || npad < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const dim3 grid((unsigned)((npad + threads - 1) / threads), (unsigned)nshards);
  dia_spmv_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y),
      npad, ndiags, offsets);
  return (int)cudaGetLastError();
}

#define DIA_SPMV_ENTRY(NAME, T)                                             \
  int NAME(const void* data, const void* x, void* y, long long npad,        \
           int ndiags, const long long* offsets, int nshards, void* stream) { \
    return launch<T>(data, x, y, npad, ndiags, offsets, nshards, stream);   \
  }

template <typename T>
static int launch_sym(const void* data, const void* x, void* y, long long npad,
                      int ndiags, const int* plan, int rows, int smem_bytes,
                      int nshards, void* stream) {
  if (ndiags < 1 || npad < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return dia_window::launch<T, 1, true>(data, x, y, npad, 1, nshards, plan, rows,
                                        smem_bytes, static_cast<cudaStream_t>(stream));
}

#define DIA_SYM_SPMV_ENTRY(NAME, T)                                            \
  int NAME(const void* data, const void* x, void* y, long long npad,           \
           int ndiags, const int* plan, int rows, int smem_bytes, int nshards, \
           void* stream) {                                                     \
    return launch_sym<T>(data, x, y, npad, ndiags, plan, rows, smem_bytes,    \
                         nshards, stream);                                     \
  }

// dia_spmv's `offsets`: a device pointer to ndiags int64 offsets;
// dia_sym_spmv's `plan`: the device int32 words of its window plan, with its
// tile rows and shared-memory bytes
extern "C" {
DIA_SPMV_ENTRY(dia_spmv_f32, float)
DIA_SPMV_ENTRY(dia_spmv_f64, double)
DIA_SPMV_ENTRY(dia_spmv_bf16, __nv_bfloat16)
DIA_SYM_SPMV_ENTRY(dia_sym_spmv_f32, float)
DIA_SYM_SPMV_ENTRY(dia_sym_spmv_f64, double)
DIA_SYM_SPMV_ENTRY(dia_sym_spmv_bf16, __nv_bfloat16)
}  // extern "C"
