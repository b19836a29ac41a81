// WELL (windowed sliced-ELL) block SpMM kernels (Y = A X for nrhs columns)
// for Hopper (sm_90a), plain and double-single.
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
// Layout (spmv_torch/formats/well.py, ops/spmm_well.py): D shards stacked;
// per shard values (K, G, 128) (float32/float64, or hi/lo float32 planes
// for the DS kernel), pos (K, G, 128) int16/int32 (window-relative flat
// column), w0 (G / tile_groups) int32. X (col_pad/128, nrhs*128) and
// Y (G, nrhs*128) per shard are in the SpMM lane layout: element
// (q, c*128 + l) is row 128q+l of column c.
//
// Design: one thread owns output row r = 128g + j of shard s (blockIdx.y =
// s) for a chunk of at most NR = 8 columns (blockIdx.z; NR = min(nrhs, 8),
// a template parameter). It reads each slot's value and pos once per chunk,
// decodes the column once, and applies the slot to each of its columns:
//   y[s, r, c] = sum_k values[s, k, g, j] * x[s, w0[s, g/tg]*128 + pos[s, k, g, j], c]
// with NR accumulators in registers (NR (hi, lo) pairs for DS); a block of
// more than 8 columns re-reads the matrix once per chunk. A read outside
// [0, col_pad) contributes 0. Column c takes the same terms in the same
// order as well_spmv (or well_ds_spmv) does on the stack's row lists, and
// the padding either one adds is an exact zero, so it equals the
// single-RHS kernel's result bit for bit.
//
// Bound: bytes. One apply must move the stored values + pos + w0 once and X
// and Y once (2 nrhs vector planes; 4 for DS); with chunks the matrix moves
// ceil(nrhs/8) times. Each slot's value and pos reads are one coalesced pass;
// within one slot a warp's x reads of a column fall in one or two 128-wide
// segments and are served from L1/L2. Shared-memory windows are later work.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmm_well_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "ds.cuh"

#define SPMM_WELL_MAX_NR 8

template <typename T, typename P, int NR>
__global__ void well_spmm_kernel(const T* __restrict__ values,
                                 const P* __restrict__ pos,
                                 const int* __restrict__ w0,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 long long ngroups, int k, int tile_groups,
                                 long long col_pad, int nrhs) {
  const long long plane = ngroups * 128;  // rows of one shard
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= plane) return;
  const long long shard = blockIdx.y;
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long lanes = (long long)nrhs * 128;
  const long long ntiles = ngroups / tile_groups;
  const long long base =
      (long long)w0[shard * ntiles + (r >> 7) / tile_groups] * 128;
  const T* xs = x + shard * col_pad * nrhs + c0 * 128;
  const T* v = values + shard * k * plane + r;
  const P* p = pos + shard * k * plane + r;
  T acc[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = T(0);
  for (int kk = 0; kk < k; ++kk) {
    const long long j = base + (long long)p[kk * plane];
    const bool in = j >= 0 && j < col_pad;
    const long long jo = in ? (j >> 7) * lanes + (j & 127) : 0;
    const T vv = v[kk * plane];
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < nc) {
        const T xv = in ? xs[jo + c * 128] : T(0);
        acc[c] += vv * xv;
      }
    }
  }
  T* ys = y + shard * plane * nrhs + (r >> 7) * lanes + c0 * 128 + (r & 127);
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < nc) ys[c * 128] = acc[c];
  }
}

template <typename P, int NR>
__global__ void well_ds_spmm_kernel(const float* __restrict__ vh,
                                    const float* __restrict__ vl,
                                    const P* __restrict__ pos,
                                    const int* __restrict__ w0,
                                    const float* __restrict__ xh,
                                    const float* __restrict__ xl,
                                    float* __restrict__ yh,
                                    float* __restrict__ yl, long long ngroups,
                                    int k, int tile_groups, long long col_pad,
                                    int nrhs) {
  const long long plane = ngroups * 128;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= plane) return;
  const long long shard = blockIdx.y;
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long lanes = (long long)nrhs * 128;
  const long long ntiles = ngroups / tile_groups;
  const long long base =
      (long long)w0[shard * ntiles + (r >> 7) / tile_groups] * 128;
  const long long xbase = shard * col_pad * nrhs + c0 * 128;
  const long long v0 = shard * k * plane + r;
  Ds acc[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = {0.0f, 0.0f};
  for (int kk = 0; kk < k; ++kk) {
    const long long at = v0 + kk * plane;
    const long long j = base + (long long)pos[at];
    const bool in = j >= 0 && j < col_pad;
    const long long jo = xbase + (in ? (j >> 7) * lanes + (j & 127) : 0);
    const Ds a = {vh[at], vl[at]};
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < nc) {
        const Ds xv = {in ? xh[jo + c * 128] : 0.0f, in ? xl[jo + c * 128] : 0.0f};
        acc[c] = ds_add(acc[c], ds_mul_f32(a, xv));
      }
    }
  }
  const long long yo = shard * plane * nrhs + (r >> 7) * lanes + c0 * 128 + (r & 127);
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < nc) {
      yh[yo + c * 128] = acc[c].hi;
      yl[yo + c * 128] = acc[c].lo;
    }
  }
}

static bool bad_shape(long long ngroups, int k, int tile_groups,
                      long long col_pad, int nrhs, int nshards) {
  return ngroups < 1 || k < 1 || tile_groups < 1 || ngroups % tile_groups ||
         col_pad < 1 || nrhs < 1 || nshards < 1 || nshards > 65535;
}

static dim3 grid_of(long long ngroups, int nrhs, int nshards, int threads, int* nr) {
  *nr = nrhs < SPMM_WELL_MAX_NR ? nrhs : SPMM_WELL_MAX_NR;
  return dim3((unsigned)((ngroups * 128 + threads - 1) / threads),
              (unsigned)nshards, (unsigned)((nrhs + *nr - 1) / *nr));
}

template <typename T, typename P>
static int launch(const void* values, const void* pos, const void* w0,
                  const void* x, void* y, long long ngroups, int k,
                  int tile_groups, long long col_pad, int nrhs, int nshards,
                  void* stream) {
  if (bad_shape(ngroups, k, tile_groups, col_pad, nrhs, nshards)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  int nr = 0;
  const dim3 grid = grid_of(ngroups, nrhs, nshards, threads, &nr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WELL_CASE(NR)                                                          \
  case NR:                                                                     \
    well_spmm_kernel<T, P, NR><<<grid, threads, 0, s>>>(                       \
        static_cast<const T*>(values), static_cast<const P*>(pos),             \
        static_cast<const int*>(w0), static_cast<const T*>(x),                 \
        static_cast<T*>(y), ngroups, k, tile_groups, col_pad, nrhs);           \
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
                     const void* w0, const void* xh, const void* xl, void* yh,
                     void* yl, long long ngroups, int k, int tile_groups,
                     long long col_pad, int nrhs, int nshards, void* stream) {
  if (bad_shape(ngroups, k, tile_groups, col_pad, nrhs, nshards)) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  int nr = 0;
  const dim3 grid = grid_of(ngroups, nrhs, nshards, threads, &nr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WELL_DS_CASE(NR)                                                       \
  case NR:                                                                     \
    well_ds_spmm_kernel<P, NR><<<grid, threads, 0, s>>>(                       \
        static_cast<const float*>(vh), static_cast<const float*>(vl),          \
        static_cast<const P*>(pos), static_cast<const int*>(w0),               \
        static_cast<const float*>(xh), static_cast<const float*>(xl),          \
        static_cast<float*>(yh), static_cast<float*>(yl), ngroups, k,          \
        tile_groups, col_pad, nrhs);                                           \
    break;
  switch (nr) {
    WELL_DS_CASE(1) WELL_DS_CASE(2) WELL_DS_CASE(3) WELL_DS_CASE(4)
    WELL_DS_CASE(5) WELL_DS_CASE(6) WELL_DS_CASE(7) WELL_DS_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WELL_DS_CASE
  return (int)cudaGetLastError();
}

#define WELL_SPMM_ENTRY(NAME, T, P)                                             \
  int NAME(const void* values, const void* pos, const void* w0,               \
           const void* x, void* y, long long ngroups, int k, int tile_groups, \
           long long col_pad, int nrhs, int nshards, void* stream) {          \
    return launch<T, P>(values, pos, w0, x, y, ngroups, k, tile_groups,       \
                        col_pad, nrhs, nshards, stream);                      \
  }

#define WELL_DS_SPMM_ENTRY(NAME, P)                                             \
  int NAME(const void* vh, const void* vl, const void* pos, const void* w0,   \
           const void* xh, const void* xl, void* yh, void* yl,                \
           long long ngroups, int k, int tile_groups, long long col_pad,      \
           int nrhs, int nshards, void* stream) {                             \
    return launch_ds<P>(vh, vl, pos, w0, xh, xl, yh, yl, ngroups, k,          \
                        tile_groups, col_pad, nrhs, nshards, stream);         \
  }

extern "C" {
WELL_SPMM_ENTRY(well_spmm_f32_i16, float, short)
WELL_SPMM_ENTRY(well_spmm_f32_i32, float, int)
WELL_SPMM_ENTRY(well_spmm_f64_i16, double, short)
WELL_SPMM_ENTRY(well_spmm_f64_i32, double, int)
WELL_DS_SPMM_ENTRY(well_ds_spmm_i16, short)
WELL_DS_SPMM_ENTRY(well_ds_spmm_i32, int)
}  // extern "C"
