// Double-single DIA SpMV kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of spmv_tpu/ops/spmv_dia_ds_pallas.py:
//   dia_ds_spmv  <- _dia_ds_kernel  (:164, pallas_call :247,
//                                    wrapper _spmv_dia_ds_2d :233)
// It computes what that kernel computes: (yh, yl) = A (xh, xl) with the
// matrix and the vectors as hi/lo float32 planes, each diagonal's term
// formed with ds_mul_f32 and accumulated with ds_add in offset order
// (csrc/ds.cuh). The TPU kernel's two-leg double-buffered window DMA and
// its lane rolls do not carry over: on the card a thread reads x at
// row + offset directly.
//
// Layout (spmv_torch/ops/spmv_dia_ds.py): D shards stacked; each shard's hi
// and lo data are (npad/128, K*128) with data[s, r, k*128 + l] =
// A_s[128r+l, 128r+l+off_k] (the DiaMatrix layout), x and y hi/lo are
// (D, npad). x is zero outside [0, npad) of its own shard.
//
// Bound: bytes. One apply moves (2K + 4) * npad * 4 bytes per shard (both
// data planes once, x and y in both planes once); the arithmetic is about
// 30 float32 operations per stored element, far below the card's rate.
// Design: one thread per output row, blockIdx.y = shard, as dia_spmv. A
// warp's 32 neighbouring rows read 32 contiguous elements of each diagonal
// in both planes (coalesced); the shifted x reads are served from L1/L2.
// Index math is 64-bit. Shared-memory staging and vector loads are later
// work.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_dia_ds_cuda.py). The entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "ds.cuh"

#define SPMV_DIA_DS_MAX_DIAGS 64

struct DiaDsOffsets {
  long long off[SPMV_DIA_DS_MAX_DIAGS];
};

__global__ void dia_ds_spmv_kernel(const float* __restrict__ data_hi,
                                   const float* __restrict__ data_lo,
                                   const float* __restrict__ xh,
                                   const float* __restrict__ xl,
                                   float* __restrict__ yh,
                                   float* __restrict__ yl, long long npad,
                                   int ndiags, DiaDsOffsets offs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const long long row_stride = (long long)ndiags * 128;
  const long long drow = shard * npad * ndiags + (i >> 7) * row_stride + (i & 127);
  const float* xhs = xh + shard * npad;
  const float* xls = xl + shard * npad;
  Ds acc = {0.0f, 0.0f};
  for (int k = 0; k < ndiags; ++k) {
    const long long j = i + offs.off[k];
    const bool in = j >= 0 && j < npad;
    const Ds x = {in ? xhs[j] : 0.0f, in ? xls[j] : 0.0f};
    const long long d = drow + (long long)k * 128;
    acc = ds_add(acc, ds_mul_f32({data_hi[d], data_lo[d]}, x));
  }
  yh[shard * npad + i] = acc.hi;
  yl[shard * npad + i] = acc.lo;
}

extern "C" int dia_ds_spmv(const void* data_hi, const void* data_lo,
                           const void* xh, const void* xl, void* yh, void* yl,
                           long long npad, int ndiags,
                           const long long* offsets, int nshards,
                           void* stream) {
  if (ndiags < 1 || ndiags > SPMV_DIA_DS_MAX_DIAGS || npad < 1 || nshards < 1 ||
      nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  DiaDsOffsets offs = {};
  for (int k = 0; k < ndiags; ++k) offs.off[k] = offsets[k];
  const int threads = 256;
  const dim3 grid((unsigned)((npad + threads - 1) / threads), (unsigned)nshards);
  dia_ds_spmv_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data_hi), static_cast<const float*>(data_lo),
      static_cast<const float*>(xh), static_cast<const float*>(xl),
      static_cast<float*>(yh), static_cast<float*>(yl), npad, ndiags, offs);
  return (int)cudaGetLastError();
}
