// WELL (windowed sliced-ELL) block SpMM kernels (Y = A X for nrhs columns)
// for Hopper (sm_90a), plain and double-single, over the stack's
// warp-sliced row lists.
//
// Replaces the Pallas TPU kernels of spmv_tpu/ops/spmm_well_pallas.py:
//   well_spmm     <- _well_mrhs_kernel     (:38, pallas_call :181,
//                                           wrapper _spmm_well_2d :142)
//   well_ds_spmm  <- _well_ds_mrhs_kernel  (:240, pallas_call :374,
//                                           wrapper _spmm_well_ds_2d :335)
// They compute what those kernels compute, not how: the one-hot MXU row
// gather with its 3-term bf16 split and the double-buffered window DMA work
// around Mosaic's lack of a multi-row gather; on the card the gather is a
// plain load.
//
// Layout (spmv_torch/formats/well.py, pack_rows; the row lists of
// csrc/spmv_well.cu and csrc/spmv_well_ds.cu): D shards stacked; per shard
// values (E) float32/float64 (hi/lo float32 planes for the DS kernel) and
// pos (E) int16/int32 (window-relative flat column) hold entry j of row
// 32s + l at slice_ptr[s] + 32*j + l, slice_ptr (S+1) int64, w0
// (G / tile_groups) int32 with G = S/4. X (col_pad/128, nrhs*128) and
// Y (G, nrhs*128) per shard are in the SpMM lane layout: element
// (q, c*128 + l) is row 128q+l of column c.
//
// Design: one warp owns slice s of shard blockIdx.y, one thread row
// r = 32s + l, for a chunk of at most NR = 8 columns (blockIdx.z;
// NR = min(nrhs, 8), a template parameter). The thread loops to its
// slice's width, reads each entry's value and pos once per chunk, decodes
// the column once, and applies the entry to each column of the chunk:
//   y[r, c] = sum_j values[e_j] * x[w0[(r / 128) / tg]*128 + pos[e_j], c]
// with NR accumulators in registers (NR (hi, lo) pairs for DS); a block of
// more than 8 columns re-reads the lists once per chunk. A read outside
// [0, col_pad) contributes 0, so a shard never reads its neighbour's X.
// Column c takes the same entries in the same order as well_spmv (or
// well_ds_spmv) does on column c, with the same acc += v*x that nvcc
// contracts into one fma (ds_add / ds_mul_f32 of ds.cuh for DS), so it
// equals the single-RHS kernel's result bit for bit.
//
// Bound: bytes. One apply must move values + pos of the stored entries,
// slice_ptr and w0 once per chunk, and X and Y once (2 nrhs vector planes;
// 4 for DS). A warp's load of one slot is 32 contiguous values and
// positions, read with streaming loads (__ldcs) so the matrix stream does
// not push X out of L2 (X of the 640k-node circuit at nrhs 8 is 20 MB, the
// L2 50 MB); the X gathers go through L1/L2. A shared-memory X window
// still does not pay at nrhs 8: a window is wseg*128*nrhs*4 B, 256 KB at
// wseg 64, more than a block's 227 KB of shared memory, and a block of 8
// slices gathers a small part of it. The entry loop is not unrolled: each
// entry already puts NR gathers in flight. Index math is 64-bit.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmm_well_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "ds.cuh"

static constexpr int kSlice = 32;     // rows per slice: one warp
static constexpr int kThreads = 256;  // 8 slices per block
static constexpr int kMaxNr = 8;      // columns per chunk

template <typename T, typename P, int NR>
__global__ void well_spmm_kernel(const T* __restrict__ values,
                                 const P* __restrict__ pos,
                                 const long long* __restrict__ slice_ptr,
                                 const int* __restrict__ w0,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 long long nslices, long long entries,
                                 int tile_groups, long long col_pad, int nrhs) {
  const long long s =
      (long long)blockIdx.x * (kThreads / kSlice) + threadIdx.x / kSlice;
  if (s >= nslices) return;
  const long long shard = blockIdx.y;
  const long long r = s * kSlice + threadIdx.x % kSlice;  // row in the shard
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long lanes = (long long)nrhs * 128;
  const long long* sp = slice_ptr + shard * (nslices + 1);
  const long long end = sp[s + 1];
  const long long ntiles = nslices / 4 / tile_groups;
  const long long base =
      (long long)w0[shard * ntiles + (r >> 7) / tile_groups] * 128;
  const T* xs = x + shard * col_pad * nrhs + c0 * 128;
  const T* v = values + shard * entries;
  const P* p = pos + shard * entries;
  T acc[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = T(0);
#pragma unroll 1
  for (long long e = sp[s] + threadIdx.x % kSlice; e < end; e += kSlice) {
    const long long j = base + (long long)__ldcs(p + e);
    const bool in = j >= 0 && j < col_pad;
    const long long jo = in ? (j >> 7) * lanes + (j & 127) : 0;
    const T vv = __ldcs(v + e);
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < nc) {
        const T xv = in ? xs[jo + c * 128] : T(0);
        acc[c] += vv * xv;
      }
    }
  }
  T* ys = y + shard * nslices * kSlice * nrhs + (r >> 7) * lanes + c0 * 128 +
          (r & 127);
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < nc) ys[c * 128] = acc[c];
  }
}

template <typename P, int NR>
__global__ void well_ds_spmm_kernel(const float* __restrict__ vh,
                                    const float* __restrict__ vl,
                                    const P* __restrict__ pos,
                                    const long long* __restrict__ slice_ptr,
                                    const int* __restrict__ w0,
                                    const float* __restrict__ xh,
                                    const float* __restrict__ xl,
                                    float* __restrict__ yh,
                                    float* __restrict__ yl, long long nslices,
                                    long long entries, int tile_groups,
                                    long long col_pad, int nrhs) {
  const long long s =
      (long long)blockIdx.x * (kThreads / kSlice) + threadIdx.x / kSlice;
  if (s >= nslices) return;
  const long long shard = blockIdx.y;
  const long long r = s * kSlice + threadIdx.x % kSlice;  // row in the shard
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long lanes = (long long)nrhs * 128;
  const long long* sp = slice_ptr + shard * (nslices + 1);
  const long long end = sp[s + 1];
  const long long ntiles = nslices / 4 / tile_groups;
  const long long base =
      (long long)w0[shard * ntiles + (r >> 7) / tile_groups] * 128;
  const long long xbase = shard * col_pad * nrhs + c0 * 128;
  const float* h = vh + shard * entries;
  const float* l = vl + shard * entries;
  const P* p = pos + shard * entries;
  Ds acc[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = {0.0f, 0.0f};
#pragma unroll 1
  for (long long e = sp[s] + threadIdx.x % kSlice; e < end; e += kSlice) {
    const long long j = base + (long long)__ldcs(p + e);
    const bool in = j >= 0 && j < col_pad;
    const long long jo = xbase + (in ? (j >> 7) * lanes + (j & 127) : 0);
    const Ds a = {__ldcs(h + e), __ldcs(l + e)};
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < nc) {
        const Ds xv = {in ? xh[jo + c * 128] : 0.0f, in ? xl[jo + c * 128] : 0.0f};
        acc[c] = ds_add(acc[c], ds_mul_f32(a, xv));
      }
    }
  }
  const long long yo = shard * nslices * kSlice * nrhs + (r >> 7) * lanes +
                       c0 * 128 + (r & 127);
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < nc) {
      yh[yo + c * 128] = acc[c].hi;
      yl[yo + c * 128] = acc[c].lo;
    }
  }
}

// The launch geometry, or false when the shapes are not a row-list stack:
// x blocks of 8 slices, y shards, z column chunks of *nr columns.
static bool geometry(long long nslices, long long entries, int tile_groups,
                     long long col_pad, int nrhs, int nshards, dim3* grid,
                     int* nr) {
  if (nslices < 4 || nslices % 4 || entries < 1 || tile_groups < 1 ||
      (nslices / 4) % tile_groups || col_pad < 1 || nrhs < 1 || nshards < 1 ||
      nshards > 65535) {
    return false;
  }
  *nr = nrhs < kMaxNr ? nrhs : kMaxNr;
  const long long per_block = kThreads / kSlice;
  *grid = dim3((unsigned)((nslices + per_block - 1) / per_block),
               (unsigned)nshards, (unsigned)((nrhs + *nr - 1) / *nr));
  return true;
}

template <typename T, typename P>
static int launch(const void* values, const void* pos, const void* slice_ptr,
                  const void* w0, const void* x, void* y, long long nslices,
                  long long entries, int tile_groups, long long col_pad,
                  int nrhs, int nshards, void* stream) {
  dim3 grid;
  int nr = 0;
  if (!geometry(nslices, entries, tile_groups, col_pad, nrhs, nshards, &grid,
                &nr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WELL_CASE(NR)                                                          \
  case NR:                                                                     \
    well_spmm_kernel<T, P, NR><<<grid, kThreads, 0, st>>>(                     \
        static_cast<const T*>(values), static_cast<const P*>(pos),             \
        static_cast<const long long*>(slice_ptr), static_cast<const int*>(w0), \
        static_cast<const T*>(x), static_cast<T*>(y), nslices, entries,        \
        tile_groups, col_pad, nrhs);                                           \
    break;
  switch (nr) {
    WELL_CASE(1) WELL_CASE(2) WELL_CASE(3) WELL_CASE(4)
    WELL_CASE(5) WELL_CASE(6) WELL_CASE(7) WELL_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WELL_CASE
  return (int)cudaGetLastError();
}

template <typename P>
static int launch_ds(const void* vh, const void* vl, const void* pos,
                     const void* slice_ptr, const void* w0, const void* xh,
                     const void* xl, void* yh, void* yl, long long nslices,
                     long long entries, int tile_groups, long long col_pad,
                     int nrhs, int nshards, void* stream) {
  dim3 grid;
  int nr = 0;
  if (!geometry(nslices, entries, tile_groups, col_pad, nrhs, nshards, &grid,
                &nr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WELL_DS_CASE(NR)                                                       \
  case NR:                                                                     \
    well_ds_spmm_kernel<P, NR><<<grid, kThreads, 0, st>>>(                     \
        static_cast<const float*>(vh), static_cast<const float*>(vl),          \
        static_cast<const P*>(pos), static_cast<const long long*>(slice_ptr),  \
        static_cast<const int*>(w0), static_cast<const float*>(xh),            \
        static_cast<const float*>(xl), static_cast<float*>(yh),                \
        static_cast<float*>(yl), nslices, entries, tile_groups, col_pad,       \
        nrhs);                                                                 \
    break;
  switch (nr) {
    WELL_DS_CASE(1) WELL_DS_CASE(2) WELL_DS_CASE(3) WELL_DS_CASE(4)
    WELL_DS_CASE(5) WELL_DS_CASE(6) WELL_DS_CASE(7) WELL_DS_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WELL_DS_CASE
  return (int)cudaGetLastError();
}

#define WELL_SPMM_ENTRY(NAME, T, P)                                           \
  int NAME(const void* values, const void* pos, const void* slice_ptr,       \
           const void* w0, const void* x, void* y, long long nslices,        \
           long long entries, int tile_groups, long long col_pad, int nrhs,  \
           int nshards, void* stream) {                                      \
    return launch<T, P>(values, pos, slice_ptr, w0, x, y, nslices, entries,  \
                        tile_groups, col_pad, nrhs, nshards, stream);        \
  }

#define WELL_DS_SPMM_ENTRY(NAME, P)                                           \
  int NAME(const void* vh, const void* vl, const void* pos,                  \
           const void* slice_ptr, const void* w0, const void* xh,            \
           const void* xl, void* yh, void* yl, long long nslices,            \
           long long entries, int tile_groups, long long col_pad, int nrhs,  \
           int nshards, void* stream) {                                      \
    return launch_ds<P>(vh, vl, pos, slice_ptr, w0, xh, xl, yh, yl, nslices, \
                        entries, tile_groups, col_pad, nrhs, nshards,        \
                        stream);                                             \
  }

extern "C" {
WELL_SPMM_ENTRY(well_spmm_f32_i16, float, short)
WELL_SPMM_ENTRY(well_spmm_f32_i32, float, int)
WELL_SPMM_ENTRY(well_spmm_f64_i16, double, short)
WELL_SPMM_ENTRY(well_spmm_f64_i32, double, int)
WELL_DS_SPMM_ENTRY(well_ds_spmm_i16, short)
WELL_DS_SPMM_ENTRY(well_ds_spmm_i32, int)
}  // extern "C"
