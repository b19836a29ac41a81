// Double-single DIA block SpMM kernel (Y = A X for nrhs columns) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of spmv_tpu/ops/spmv_dia_ds_pallas.py:
//   dia_ds_spmm  <- _dia_ds_mrhs_kernel  (:377, pallas_call :471,
//                                         wrapper _spmm_dia_ds_2d :457)
// It computes what that kernel computes: (Yh, Yl) = A (Xh, Xl) with the
// matrix and the vectors as hi/lo float32 planes, each diagonal's term
// formed with ds_mul_f32 and accumulated with ds_add in offset order
// (csrc/ds.cuh), column by column. The TPU kernel's two-plane window DMA and
// lane rolls do not carry over.
//
// Layout (spmv_torch/ops/spmv_dia_ds.py): D shards stacked; each shard's hi
// and lo data are (npad/128, K*128) in the DiaMatrix layout; X and Y hi/lo
// are in the SpMM lane layout, per shard (npad/128, nrhs*128) with element
// (q, c*128 + l) row 128q+l of column c. x is zero outside [0, npad) of its
// own shard.
//
// Design: one thread per output row, blockIdx.y = shard, blockIdx.z = a
// chunk of at most NR = 8 columns (NR = min(nrhs, 8), a template
// parameter). The thread reads each stored element of both planes once per
// chunk and applies it to each of its columns, with NR (hi, lo)
// accumulators in registers; a block of more than 8 columns re-reads the
// matrix once per chunk. Column c takes exactly dia_ds_spmv's chain on it,
// so it equals that kernel's result bit for bit (and the plain version's).
//
// Bound: bytes. One apply moves (2K + 4 nrhs) * npad * 4 bytes per shard
// (both data planes once, X and Y in both planes once); with chunks the
// matrix moves ceil(nrhs/8) times. About 30 float32 operations per stored
// element and column, far below the card's rate. Shifted x reads are served
// from L1/L2.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_dia_ds_cuda.py). The entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "ds.cuh"

#define SPMM_DIA_DS_MAX_DIAGS 64
#define SPMM_DS_MAX_NR 8

struct SpmmDiaDsOffsets {
  long long off[SPMM_DIA_DS_MAX_DIAGS];
};

template <int NR>
__global__ void dia_ds_spmm_kernel(const float* __restrict__ data_hi,
                                   const float* __restrict__ data_lo,
                                   const float* __restrict__ xh,
                                   const float* __restrict__ xl,
                                   float* __restrict__ yh,
                                   float* __restrict__ yl, long long npad,
                                   int ndiags, int nrhs, SpmmDiaDsOffsets offs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long row_stride = (long long)ndiags * 128;
  const long long lanes = (long long)nrhs * 128;
  const long long drow = shard * npad * ndiags + (i >> 7) * row_stride + (i & 127);
  const long long xbase = shard * npad * nrhs + c0 * 128;
  Ds acc[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = {0.0f, 0.0f};
  for (int k = 0; k < ndiags; ++k) {
    const long long j = i + offs.off[k];
    const bool in = j >= 0 && j < npad;
    const long long jo = xbase + (in ? (j >> 7) * lanes + (j & 127) : 0);
    const long long d = drow + (long long)k * 128;
    const Ds a = {data_hi[d], data_lo[d]};
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < nc) {
        const Ds xv = {in ? xh[jo + c * 128] : 0.0f, in ? xl[jo + c * 128] : 0.0f};
        acc[c] = ds_add(acc[c], ds_mul_f32(a, xv));
      }
    }
  }
  const long long yo = shard * npad * nrhs + (i >> 7) * lanes + c0 * 128 + (i & 127);
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < nc) {
      yh[yo + c * 128] = acc[c].hi;
      yl[yo + c * 128] = acc[c].lo;
    }
  }
}

template <int NR>
static void launch_nr(dim3 grid, int threads, cudaStream_t s, const void* dh,
                      const void* dl, const void* xh, const void* xl, void* yh,
                      void* yl, long long npad, int ndiags, int nrhs,
                      const SpmmDiaDsOffsets& offs) {
  dia_ds_spmm_kernel<NR><<<grid, threads, 0, s>>>(
      static_cast<const float*>(dh), static_cast<const float*>(dl),
      static_cast<const float*>(xh), static_cast<const float*>(xl),
      static_cast<float*>(yh), static_cast<float*>(yl), npad, ndiags, nrhs, offs);
}

extern "C" int dia_ds_spmm(const void* data_hi, const void* data_lo,
                           const void* xh, const void* xl, void* yh, void* yl,
                           long long npad, int ndiags,
                           const long long* offsets, int nrhs, int nshards,
                           void* stream) {
  if (ndiags < 1 || ndiags > SPMM_DIA_DS_MAX_DIAGS || npad < 1 || nrhs < 1 ||
      nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  SpmmDiaDsOffsets offs = {};
  for (int k = 0; k < ndiags; ++k) offs.off[k] = offsets[k];
  const int nr = nrhs < SPMM_DS_MAX_NR ? nrhs : SPMM_DS_MAX_NR;
  const int threads = 256;
  const dim3 grid((unsigned)((npad + threads - 1) / threads), (unsigned)nshards,
                  (unsigned)((nrhs + nr - 1) / nr));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_ARGS grid, threads, s, data_hi, data_lo, xh, xl, yh, yl, npad, ndiags, nrhs, offs
  switch (nr) {
    case 1: launch_nr<1>(DS_ARGS); break;
    case 2: launch_nr<2>(DS_ARGS); break;
    case 3: launch_nr<3>(DS_ARGS); break;
    case 4: launch_nr<4>(DS_ARGS); break;
    case 5: launch_nr<5>(DS_ARGS); break;
    case 6: launch_nr<6>(DS_ARGS); break;
    case 7: launch_nr<7>(DS_ARGS); break;
    default: launch_nr<8>(DS_ARGS); break;
  }
#undef DS_ARGS
  return (int)cudaGetLastError();
}
