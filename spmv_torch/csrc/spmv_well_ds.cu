// Double-single WELL (windowed sliced-ELL) SpMV kernel for Hopper (sm_90a),
// over the stack's warp-sliced row lists.
//
// Replaces the Pallas TPU kernel of spmv_tpu/ops/spmv_well_pallas.py:
//   well_ds_spmv  <- _well_ds_kernel  (:407, pallas_call :539,
//                                      wrapper spmv_well_ds_pallas_2d :553)
// It computes what that kernel computes: (yh, yl) = A (xh, xl), the values
// and the vectors as hi/lo float32 planes, each stored entry's term formed
// with ds_mul_f32 and accumulated with ds_add in the row's slot order
// (csrc/ds.cuh). The TPU kernel's one-hot MXU gather with its 3-term bf16
// split and its double-buffered two-leg window DMA do not carry over: on
// the card the gather is a plain load.
//
// Layout (spmv_torch/formats/well.py, pack_rows; the same row lists as
// csrc/spmv_well.cu with two value planes): D shards stacked; per shard
// values hi/lo (E) float32 and pos (E) int16/int32 (window-relative flat
// column) hold entry j of row 32s + l at slice_ptr[s] + 32*j + l,
// slice_ptr (S+1) int64, w0 (G / tile_groups) int32 with G = S/4, x hi/lo
// (col_pad) and y hi/lo (S*32). One warp owns slice s of shard blockIdx.y,
// one thread row r = 32s + l, looping to the slice's width and reading
// x[w0[(r / 128) / tile_groups]*128 + pos] from both planes. Each row holds
// its WELL slots in WELL slot order and a padded entry adds an exact (0, 0),
// so the result equals the WELL formula's bit for bit. A read outside
// [0, col_pad) contributes (0, 0), so a shard never reads its neighbour's x.
//
// Bound: bytes. One apply must move the two value planes and pos of the
// stored entries, slice_ptr and w0, and x and y in both planes once; the
// arithmetic is about 30 float32 operations an entry. A warp's load of one
// slot is 32 contiguous entries of each plane, read with streaming loads
// (__ldcs) so the matrix stream leaves x in L2; the x gathers of a slice
// fall in a few segments of its window and are served from L1/L2. As in
// csrc/spmv_well.cu, staging the tile's x window in shared memory would
// load several times the x bytes a block gathers; the bound is the matrix
// bytes, which the row lists cut to the real entries plus the slice
// padding. Index math is 64-bit.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_well_ds_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "ds.cuh"

static constexpr int kSlice = 32;    // rows per slice: one warp
static constexpr int kThreads = 256;  // 8 slices per block

template <typename P>
__global__ void well_ds_spmv_kernel(const float* __restrict__ vh,
                                    const float* __restrict__ vl,
                                    const P* __restrict__ pos,
                                    const long long* __restrict__ slice_ptr,
                                    const int* __restrict__ w0,
                                    const float* __restrict__ xh,
                                    const float* __restrict__ xl,
                                    float* __restrict__ yh,
                                    float* __restrict__ yl, long long nslices,
                                    long long entries, int tile_groups,
                                    long long col_pad) {
  const long long s =
      (long long)blockIdx.x * (kThreads / kSlice) + threadIdx.x / kSlice;
  if (s >= nslices) return;
  const long long shard = blockIdx.y;
  const long long r = s * kSlice + threadIdx.x % kSlice;  // row in the shard
  const long long* sp = slice_ptr + shard * (nslices + 1);
  const long long end = sp[s + 1];
  const long long ntiles = nslices / 4 / tile_groups;
  const long long base =
      (long long)w0[shard * ntiles + (r >> 7) / tile_groups] * 128;
  const float* xhs = xh + shard * col_pad;
  const float* xls = xl + shard * col_pad;
  const float* h = vh + shard * entries;
  const float* l = vl + shard * entries;
  const P* p = pos + shard * entries;
  Ds acc = {0.0f, 0.0f};
#pragma unroll 4
  for (long long e = sp[s] + threadIdx.x % kSlice; e < end; e += kSlice) {
    const long long j = base + (long long)__ldcs(p + e);
    const bool in = j >= 0 && j < col_pad;
    const Ds x = {in ? xhs[j] : 0.0f, in ? xls[j] : 0.0f};
    acc = ds_add(acc, ds_mul_f32({__ldcs(h + e), __ldcs(l + e)}, x));
  }
  const long long out = shard * nslices * kSlice + r;
  yh[out] = acc.hi;
  yl[out] = acc.lo;
}

template <typename P>
static int launch(const void* vh, const void* vl, const void* pos,
                  const void* slice_ptr, const void* w0, const void* xh,
                  const void* xl, void* yh, void* yl, long long nslices,
                  long long entries, int tile_groups, long long col_pad,
                  int nshards, void* stream) {
  if (nslices < 4 || nslices % 4 || entries < 1 || tile_groups < 1 ||
      (nslices / 4) % tile_groups || col_pad < 1 || nshards < 1 ||
      nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_block = kThreads / kSlice;
  const dim3 grid((unsigned)((nslices + per_block - 1) / per_block),
                  (unsigned)nshards);
  well_ds_spmv_kernel<P><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vh), static_cast<const float*>(vl),
      static_cast<const P*>(pos), static_cast<const long long*>(slice_ptr),
      static_cast<const int*>(w0), static_cast<const float*>(xh),
      static_cast<const float*>(xl), static_cast<float*>(yh),
      static_cast<float*>(yl), nslices, entries, tile_groups, col_pad);
  return (int)cudaGetLastError();
}

#define WELL_DS_ENTRY(NAME, P)                                                \
  int NAME(const void* vh, const void* vl, const void* pos,                  \
           const void* slice_ptr, const void* w0, const void* xh,            \
           const void* xl, void* yh, void* yl, long long nslices,            \
           long long entries, int tile_groups, long long col_pad,            \
           int nshards, void* stream) {                                      \
    return launch<P>(vh, vl, pos, slice_ptr, w0, xh, xl, yh, yl, nslices,    \
                     entries, tile_groups, col_pad, nshards, stream);        \
  }

extern "C" {
WELL_DS_ENTRY(well_ds_spmv_i16, short)
WELL_DS_ENTRY(well_ds_spmv_i32, int)
}  // extern "C"
