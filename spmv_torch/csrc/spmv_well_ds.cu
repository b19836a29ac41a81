// Double-single WELL (windowed sliced-ELL) SpMV kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of spmv_tpu/ops/spmv_well_pallas.py:
//   well_ds_spmv  <- _well_ds_kernel  (:407, pallas_call :539,
//                                      wrapper spmv_well_ds_pallas_2d :553)
// It computes what that kernel computes: (yh, yl) = A (xh, xl), the values
// and the vectors as hi/lo float32 planes, each slot's term formed with
// ds_mul_f32 and accumulated with ds_add for k = 0..K-1 in order
// (csrc/ds.cuh). The TPU kernel's one-hot MXU gather with its 3-term bf16
// split and its double-buffered two-leg window DMA do not carry over: on
// the card the gather is a plain load.
//
// Layout (spmv_torch/ops/spmv_well_ds.py, formats/well.py): D shards
// stacked; per shard values hi/lo (K, G, 128) float32, pos (K, G, 128)
// int16/int32 (window-relative flat column), w0 (G / tile_groups) int32,
// x hi/lo (col_pad) and y hi/lo (G*128). One thread owns output row
// r = 128g + j of shard s (blockIdx.y = s) and reads
// x[s, w0[s, g / tg]*128 + pos[s, k, g, j]] from both planes. That one
// formula covers unpaired and paired slots: every entry's own pos carries
// its segment. A read outside [0, col_pad) contributes (0, 0), so a shard
// never reads its neighbour's x.
//
// Bound: bytes. One apply must move the two value planes and pos of the
// stored slots, w0, and x and y in both planes once; the arithmetic is
// about 30 float32 operations per slot. Neighbouring threads are
// neighbouring lanes, so each slot's value and pos reads are coalesced;
// within one slot a warp's x reads fall in one or two 128-wide segments and
// are served from L1/L2. Index math is 64-bit.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_well_ds_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "ds.cuh"

template <typename P>
__global__ void well_ds_spmv_kernel(const float* __restrict__ vh,
                                    const float* __restrict__ vl,
                                    const P* __restrict__ pos,
                                    const int* __restrict__ w0,
                                    const float* __restrict__ xh,
                                    const float* __restrict__ xl,
                                    float* __restrict__ yh,
                                    float* __restrict__ yl, long long ngroups,
                                    int k, int tile_groups, long long col_pad) {
  const long long plane = ngroups * 128;  // rows of one shard
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= plane) return;
  const long long shard = blockIdx.y;
  const long long ntiles = ngroups / tile_groups;
  const long long base =
      (long long)w0[shard * ntiles + (r >> 7) / tile_groups] * 128;
  const float* xhs = xh + shard * col_pad;
  const float* xls = xl + shard * col_pad;
  const long long v0 = shard * k * plane + r;
  Ds acc = {0.0f, 0.0f};
  for (int kk = 0; kk < k; ++kk) {
    const long long at = v0 + kk * plane;
    const long long j = base + (long long)pos[at];
    const bool in = j >= 0 && j < col_pad;
    const Ds x = {in ? xhs[j] : 0.0f, in ? xls[j] : 0.0f};
    acc = ds_add(acc, ds_mul_f32({vh[at], vl[at]}, x));
  }
  yh[shard * plane + r] = acc.hi;
  yl[shard * plane + r] = acc.lo;
}

template <typename P>
static int launch(const void* vh, const void* vl, const void* pos,
                  const void* w0, const void* xh, const void* xl, void* yh,
                  void* yl, long long ngroups, int k, int tile_groups,
                  long long col_pad, int nshards, void* stream) {
  if (ngroups < 1 || k < 1 || tile_groups < 1 || ngroups % tile_groups ||
      col_pad < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const long long rows = ngroups * 128;
  const dim3 grid((unsigned)((rows + threads - 1) / threads), (unsigned)nshards);
  well_ds_spmv_kernel<P><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vh), static_cast<const float*>(vl),
      static_cast<const P*>(pos), static_cast<const int*>(w0),
      static_cast<const float*>(xh), static_cast<const float*>(xl),
      static_cast<float*>(yh), static_cast<float*>(yl), ngroups, k,
      tile_groups, col_pad);
  return (int)cudaGetLastError();
}

#define WELL_DS_ENTRY(NAME, P)                                                \
  int NAME(const void* vh, const void* vl, const void* pos, const void* w0,  \
           const void* xh, const void* xl, void* yh, void* yl,               \
           long long ngroups, int k, int tile_groups, long long col_pad,     \
           int nshards, void* stream) {                                      \
    return launch<P>(vh, vl, pos, w0, xh, xl, yh, yl, ngroups, k,            \
                     tile_groups, col_pad, nshards, stream);                 \
  }

extern "C" {
WELL_DS_ENTRY(well_ds_spmv_i16, short)
WELL_DS_ENTRY(well_ds_spmv_i32, int)
}  // extern "C"
