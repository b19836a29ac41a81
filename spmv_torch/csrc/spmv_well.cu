// WELL (windowed sliced-ELL) SpMV kernels for Hopper (sm_90a), over the
// stacks' warp-sliced row lists: well_spmv applies one stack, and
// well_sym_spmv the whole symmetric dual-WELL form (below).
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
// Accumulation is in the storage type, j in order, one fma a slot
// (WellRow::sum, the one place a row is summed): the fma nvcc contracts
// the block kernel's acc + v*x into (csrc/spmm_well.cu), so its column at
// nrhs 1 equals this kernel bit for bit. A thread loads the values and
// positions of its row's first kAhead slots before its first gather, and
// gathers them all before its first fma. Index math is 64-bit.
//
// well_sym_spmv: y = L x + L^T x + d x for the symmetric "well" operator
// (DistMatrix's dual-WELL form: the strict lower triangle L as one stack,
// its transpose as a second, the diagonal d). No TPU kernel of its own:
// it replaces the symmetric apply's two well_spmv launches (the reference
// runs _well_kernel on each stack) and the torch glue after them (y +
// L^T x, d * x and their sum), which read x twice, wrote y three times and
// read it back twice (~1.45 GB an apply at poisson2d_4480.matvec's 10.04M
// rows, 47% of its time in glue).
// Bound: bytes, the port's layout_bytes: both stacks' values and
// positions, their slice_ptr and w0, d, x once and y once (648 MB there,
// 0.193 ms at 3.35 TB/s). Without atomics nothing can read less: L^T x
// from L's entries alone would scatter each entry into another row's sum,
// and no apply sums with atomics (its bits would change from run to run),
// so L^T is gathered from its own stack and the stored triangle is read
// twice (the least bytes, L once, x and y, are 74% of layout_bytes).
// Design: one warp owns a slice of a shard and one thread a row, as in
// well_spmv (two slices a warp were 7-40% slower on the H100 at every
// kAhead). The two stacks keep their own slice_ptr, w0, slice widths,
// window starts, position widths and tile_groups, and share the rows and
// col_pad.
// A thread finds its row in both stacks, then issues the loads of both
// stacks' first kAhead slots, d[r] and x[r], then both stacks' x gathers,
// and only then sums: the two stacks' latencies overlap instead of running
// back to back, and d and y take no pass of their own. The matrix stream,
// d and x[r] are streaming loads and y a streaming store, so they do not
// push the gathered x out of L2; x is not staged in shared memory (as for
// well_spmv; under RCM both stacks' gathers fall in a few segments around
// the row). Each stack's row is summed by WellRow::sum, as well_spmv sums
// it, and the three terms are added as the torch glue added them,
// (accL + accT) + d*x with round-to-nearest intrinsics nvcc never
// contracts, so y is the two-launch route's bit for bit.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_well_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

static constexpr int kSlice = 32;    // rows per slice: one warp
static constexpr int kThreads = 256;  // 8 slices per block
// slots a row loads before its first fma: the width of nearly every slice
// of the RCM'd FEM's stacks (poisson2d_4480's 2.0 a row); 1, 3 and 4 were
// slower on the H100 in both kernels
static constexpr int kAhead = 2;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// One stack's row lists, D shards stacked.
template <typename T, typename P>
struct RowLists {
  const T* values;             // (D, entries)
  const P* pos;                // (D, entries)
  const long long* slice_ptr;  // (D, nslices + 1)
  const int* w0;               // (D, nslices / 4 / tile_groups)
  long long entries;
  int tile_groups;
};

// The sum of one row of one stack, the only place a WELL row is summed:
//   acc = fma(values[e_j], x[base + pos[e_j]], acc), j in slot order from
// acc = 0, a position outside [0, col_pad) reading 0. It is taken in steps
// (find, load, gather, sum) so that a kernel can put the loads of two
// stacks in flight before its first fma: the first kAhead slots are held
// in registers, a wider row's other slots are read in sum.
// A slot is live for all 32 lanes of a slice or for none (a slice's entries
// are 32 times its width), so the branches below do not diverge.
template <typename T, typename P>
struct WellRow {
  const T* v;
  const P* p;
  long long e, end, base;  // the row's slot 0, its slice's end, x's window start
  T val[kAhead];
  T xv[kAhead];
  int pos[kAhead];

  __device__ __forceinline__ void find(const RowLists<T, P>& m, long long nslices,
                                       long long shard, long long s, int lane) {
    const long long* sp = m.slice_ptr + shard * (nslices + 1);
    e = sp[s] + lane;
    end = sp[s + 1];
    const long long ntiles = nslices / 4 / m.tile_groups;
    base = (long long)m.w0[shard * ntiles + (s >> 2) / m.tile_groups] * 128;
    v = m.values + shard * m.entries;
    p = m.pos + shard * m.entries;
  }

  __device__ __forceinline__ bool live(int k) const { return e + k * kSlice < end; }

  __device__ __forceinline__ void load() {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      val[k] = live(k) ? __ldcs(v + e + k * kSlice) : T(0);
      pos[k] = live(k) ? (int)__ldcs(p + e + k * kSlice) : 0;
    }
  }

  __device__ __forceinline__ void gather(const T* xs, long long col_pad) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long j = base + pos[k];
      xv[k] = (live(k) && j >= 0 && j < col_pad) ? xs[j] : T(0);
    }
  }

  __device__ __forceinline__ T sum(const T* xs, long long col_pad) const {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (live(k)) acc = fma_rn(val[k], xv[k], acc);
    }
#pragma unroll 4
    for (long long f = e + kAhead * kSlice; f < end; f += kSlice) {
      const long long j = base + (long long)__ldcs(p + f);
      const T x = (j >= 0 && j < col_pad) ? xs[j] : T(0);
      acc = fma_rn(__ldcs(v + f), x, acc);
    }
    return acc;
  }
};

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    well_spmv_kernel(RowLists<T, P> m, const T* __restrict__ x, T* __restrict__ y,
                     long long nslices, long long col_pad) {
  const long long s =
      (long long)blockIdx.x * (kThreads / kSlice) + threadIdx.x / kSlice;
  if (s >= nslices) return;
  const long long shard = blockIdx.y;
  const int lane = threadIdx.x % kSlice;
  const T* xs = x + shard * col_pad;
  WellRow<T, P> row;
  row.find(m, nslices, shard, s, lane);
  row.load();
  row.gather(xs, col_pad);
  y[(shard * nslices + s) * kSlice + lane] = row.sum(xs, col_pad);
}

// The symmetric dual-WELL apply y = L x + L^T x + d x in one pass: one warp
// owns slice s of shard blockIdx.y, one thread row r = 32s + l. See the
// note at the top of the file.
template <typename T, typename P, typename PT>
__global__ void __launch_bounds__(kThreads)
    well_sym_spmv_kernel(RowLists<T, P> lower, RowLists<T, PT> upper,
                         const T* __restrict__ d, const T* __restrict__ x,
                         T* __restrict__ y, long long nslices, long long col_pad) {
  const long long s =
      (long long)blockIdx.x * (kThreads / kSlice) + threadIdx.x / kSlice;
  if (s >= nslices) return;
  const long long shard = blockIdx.y;
  const int lane = threadIdx.x % kSlice;
  const T* xs = x + shard * col_pad;
  const long long r = shard * col_pad + s * kSlice + lane;  // in d, x and y
  WellRow<T, P> l;
  WellRow<T, PT> u;
  l.find(lower, nslices, shard, s, lane);
  u.find(upper, nslices, shard, s, lane);
  l.load();
  u.load();
  const T dv = __ldcs(d + r);
  const T xr = __ldcs(x + r);
  l.gather(xs, col_pad);
  u.gather(xs, col_pad);
  // the torch glue's y = L x; y = y + L^T x; y = y + d * x, rounding for
  // rounding
  const T lu = add_rn(l.sum(xs, col_pad), u.sum(xs, col_pad));
  __stcs(y + r, add_rn(lu, mul_rn(dv, xr)));
}

static bool rows_ok(long long nslices, long long entries, int tile_groups) {
  return nslices >= 4 && nslices % 4 == 0 && entries >= 1 && tile_groups >= 1 &&
         (nslices / 4) % tile_groups == 0;
}

template <typename T, typename P>
static RowLists<T, P> row_lists(const void* values, const void* pos,
                                const void* slice_ptr, const void* w0,
                                long long entries, int tile_groups) {
  return {static_cast<const T*>(values), static_cast<const P*>(pos),
          static_cast<const long long*>(slice_ptr), static_cast<const int*>(w0),
          entries, tile_groups};
}

template <typename T, typename P>
static int launch(const void* values, const void* pos, const void* slice_ptr,
                  const void* w0, const void* x, void* y, long long nslices,
                  long long entries, int tile_groups, long long col_pad,
                  int nshards, void* stream) {
  if (!rows_ok(nslices, entries, tile_groups) || col_pad < 1 || nshards < 1 ||
      nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_block = kThreads / kSlice;
  const dim3 grid((unsigned)((nslices + per_block - 1) / per_block),
                  (unsigned)nshards);
  well_spmv_kernel<T, P><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      row_lists<T, P>(values, pos, slice_ptr, w0, entries, tile_groups),
      static_cast<const T*>(x), static_cast<T*>(y), nslices, col_pad);
  return (int)cudaGetLastError();
}

template <typename T, typename P, typename PT>
static int launch_sym(const void* values, const void* pos, const void* slice_ptr,
                      const void* w0, long long entries, int tile_groups,
                      const void* valuesT, const void* posT, const void* slice_ptrT,
                      const void* w0T, long long entriesT, int tile_groupsT,
                      const void* d, const void* x, void* y, long long nslices,
                      long long col_pad, int nshards, void* stream) {
  if (!rows_ok(nslices, entries, tile_groups) ||
      !rows_ok(nslices, entriesT, tile_groupsT) || col_pad != nslices * kSlice ||
      nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_block = kThreads / kSlice;
  const dim3 grid((unsigned)((nslices + per_block - 1) / per_block),
                  (unsigned)nshards);
  well_sym_spmv_kernel<T, P, PT>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          row_lists<T, P>(values, pos, slice_ptr, w0, entries, tile_groups),
          row_lists<T, PT>(valuesT, posT, slice_ptrT, w0T, entriesT, tile_groupsT),
          static_cast<const T*>(d), static_cast<const T*>(x), static_cast<T*>(y),
          nslices, col_pad);
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

#define WELL_SYM_ENTRY(NAME, T, P, PT)                                           \
  int NAME(const void* values, const void* pos, const void* slice_ptr,          \
           const void* w0, long long entries, int tile_groups,                  \
           const void* valuesT, const void* posT, const void* slice_ptrT,       \
           const void* w0T, long long entriesT, int tile_groupsT, const void* d, \
           const void* x, void* y, long long nslices, long long col_pad,        \
           int nshards, void* stream) {                                         \
    return launch_sym<T, P, PT>(values, pos, slice_ptr, w0, entries,            \
                                tile_groups, valuesT, posT, slice_ptrT, w0T,    \
                                entriesT, tile_groupsT, d, x, y, nslices,       \
                                col_pad, nshards, stream);                      \
  }

extern "C" {
WELL_ENTRY(well_spmv_f32_i16, float, short)
WELL_ENTRY(well_spmv_f32_i32, float, int)
WELL_ENTRY(well_spmv_f64_i16, double, short)
WELL_ENTRY(well_spmv_f64_i32, double, int)
WELL_SYM_ENTRY(well_sym_spmv_f32_i16_i16, float, short, short)
WELL_SYM_ENTRY(well_sym_spmv_f32_i16_i32, float, short, int)
WELL_SYM_ENTRY(well_sym_spmv_f32_i32_i16, float, int, short)
WELL_SYM_ENTRY(well_sym_spmv_f32_i32_i32, float, int, int)
WELL_SYM_ENTRY(well_sym_spmv_f64_i16_i16, double, short, short)
WELL_SYM_ENTRY(well_sym_spmv_f64_i16_i32, double, short, int)
WELL_SYM_ENTRY(well_sym_spmv_f64_i32_i16, double, int, short)
WELL_SYM_ENTRY(well_sym_spmv_f64_i32_i32, double, int, int)
}  // extern "C"
