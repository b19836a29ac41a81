// WELL (windowed sliced-ELL) SpMV kernel for Hopper (sm_90a), over the
// stack's warp-sliced row lists.
//
// Replaces the Pallas TPU kernel of spmv_tpu/ops/spmv_well_pallas.py:
//   well_spmv  <- _well_kernel  (:43, pallas_call :237,
//                                wrapper spmv_well_pallas_2d :268)
// It computes what that kernel computes, not how: the TPU kernel exists
// to work around Mosaic's lack of a multi-row gather (one-hot MXU row
// gather, a 3-term bf16 split to keep that gather exact, a double-buffered
// window DMA). On the card the work is a plain gather.
//
// Layout (spmv_torch/formats/well.py, pack_rows): D shards stacked; per
// shard the rows are cut into slices of 32 (one warp), each slice as wide
// as its longest row. values (E) f32/f64 and pos (E) int16/int32 (window-
// relative flat column) hold entry j of row 32s + l at
// slice_ptr[s] + 32*j + l, slice_ptr (S+1) int64; w0 (G / tile_groups)
// int32 is the WELL stack's window start segment of each tile (G = S/4
// groups of 128 rows; a slice lies inside one group). x (col_pad), y (S*32).
// One warp owns slice s of shard blockIdx.y, one thread row r = 32s + l:
//   y[r] = sum_j values[slice_ptr[s] + 32j + l]
//                * x[w0[(r / 128) / tile_groups]*128 + pos[slice_ptr[s] + 32j + l]]
// for j below the slice's width. Each row holds its WELL slots in WELL
// slot order and a padded entry (value 0 at a position inside the window)
// adds an exact zero, so y equals the WELL formula's sum bit for bit,
// padding and all. A read outside [0, col_pad) contributes 0, so a shard
// never reads its neighbour's x.
//
// Bound: bytes. One apply must move values + pos of the stored entries,
// slice_ptr and w0 once, x once and y once; the arithmetic is 2 flops an
// entry. A warp's load of one slot is 32 contiguous values and positions
// (128 B and 64 B for fp32 with int16 pos), read with streaming loads
// (__ldcs) so the matrix stream does not push x out of L2 (x of the 800k
// FEM is 3.2 MB, the L2 50 MB); the x gathers of a slice fall in a few
// segments of its window and are served from L1/L2. Staging the tile's x
// window in shared memory does not pay: a 64-segment window is 32 KB of x
// per tile, and a block of 256 rows (8 slices) gathers about 6 KB of it,
// so the block would load 5x the x bytes it reads. The bound is the matrix
// bytes, which the row lists cut to the real entries plus the slice
// padding (WELL slots 8x fewer on the RCM'd FEM's triangles).
// Accumulation is in the storage type, j in order; nvcc contracts
// acc + v*x into an fma, as the block kernel does (csrc/spmm_well.cu), so
// its column at nrhs 1 equals this kernel bit for bit. Index math is
// 64-bit.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_well_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

static constexpr int kSlice = 32;    // rows per slice: one warp
static constexpr int kThreads = 256;  // 8 slices per block

template <typename T, typename P>
__global__ void well_spmv_kernel(const T* __restrict__ values,
                                 const P* __restrict__ pos,
                                 const long long* __restrict__ slice_ptr,
                                 const int* __restrict__ w0,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 long long nslices, long long entries,
                                 int tile_groups, long long col_pad) {
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
  const T* xs = x + shard * col_pad;
  const T* v = values + shard * entries;
  const P* p = pos + shard * entries;
  T acc = T(0);
#pragma unroll 4
  for (long long e = sp[s] + threadIdx.x % kSlice; e < end; e += kSlice) {
    const long long j = base + (long long)__ldcs(p + e);
    const T xv = (j >= 0 && j < col_pad) ? xs[j] : T(0);
    acc += __ldcs(v + e) * xv;
  }
  y[shard * nslices * kSlice + r] = acc;
}

template <typename T, typename P>
static int launch(const void* values, const void* pos, const void* slice_ptr,
                  const void* w0, const void* x, void* y, long long nslices,
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
  well_spmv_kernel<T, P><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const P*>(pos),
      static_cast<const long long*>(slice_ptr), static_cast<const int*>(w0),
      static_cast<const T*>(x), static_cast<T*>(y), nslices, entries,
      tile_groups, col_pad);
  return (int)cudaGetLastError();
}

#define WELL_ENTRY(NAME, T, P)                                                \
  int NAME(const void* values, const void* pos, const void* slice_ptr,       \
           const void* w0, const void* x, void* y, long long nslices,        \
           long long entries, int tile_groups, long long col_pad,            \
           int nshards, void* stream) {                                      \
    return launch<T, P>(values, pos, slice_ptr, w0, x, y, nslices, entries,  \
                        tile_groups, col_pad, nshards, stream);              \
  }

extern "C" {
WELL_ENTRY(well_spmv_f32_i16, float, short)
WELL_ENTRY(well_spmv_f32_i32, float, int)
WELL_ENTRY(well_spmv_f64_i16, double, short)
WELL_ENTRY(well_spmv_f64_i32, double, int)
}  // extern "C"
