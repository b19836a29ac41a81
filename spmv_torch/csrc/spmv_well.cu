// WELL (windowed sliced-ELL) SpMV kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of spmv_tpu/ops/spmv_well_pallas.py:
//   well_spmv  <- _well_kernel  (:43, pallas_call :237,
//                                wrapper spmv_well_pallas_2d :268)
// It computes what that kernel computes, not how: the TPU kernel exists
// to work around Mosaic's lack of a multi-row gather (one-hot MXU row
// gather, a 3-term bf16 split to keep that gather exact, a double-buffered
// window DMA). On the card the work is a plain gather.
//
// Layout (spmv_torch/formats/well.py): D shards stacked; per shard
//   values (K, G, 128) f32/f64, pos (K, G, 128) int16/int32 (window-
//   relative flat column), w0 (G / tile_groups) int32 (window start
//   segment of each tile), x (col_pad) and y (G*128).
// One thread owns output row r = 128g + j of shard s (blockIdx.y = s):
//   y[s, r] = sum_k values[s, k, g, j] * x[s, w0[s, g / tg]*128 + pos[s, k, g, j]]
// That one formula covers unpaired and paired slots: every real entry's
// own pos carries its segment, and padding slots hold value 0 at a
// position inside the window. A read outside [0, col_pad) contributes 0,
// so a shard never reads its neighbour's x.
//
// Bound: bytes. One apply must move the stored values + pos + w0 once,
// x once and y once; arithmetic is 2 flops per stored slot. Neighbouring
// threads are neighbouring lanes, so each slot's values and pos reads are
// one coalesced pass over the K planes; within one slot a warp's x reads
// fall in one or two 128-wide segments and are served from L1/L2.
// Accumulation is in the storage type (k = 0..K-1 in order; nvcc contracts
// acc + v*x into an fma, so results differ from an unfused multiply-add in
// the last bits); index math is 64-bit. Shared-memory windows and
// cp.async/TMA staging are later work.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_well_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

template <typename T, typename P>
__global__ void well_spmv_kernel(const T* __restrict__ values,
                                 const P* __restrict__ pos,
                                 const int* __restrict__ w0,
                                 const T* __restrict__ x, T* __restrict__ y,
                                 long long ngroups, int k, int tile_groups,
                                 long long col_pad) {
  const long long plane = ngroups * 128;  // rows of one shard
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= plane) return;
  const long long shard = blockIdx.y;
  const long long ntiles = ngroups / tile_groups;
  const long long base =
      (long long)w0[shard * ntiles + (r >> 7) / tile_groups] * 128;
  const T* xs = x + shard * col_pad;
  const T* v = values + shard * k * plane + r;
  const P* p = pos + shard * k * plane + r;
  T acc = T(0);
  for (int kk = 0; kk < k; ++kk) {
    const long long j = base + (long long)p[kk * plane];
    const T xv = (j >= 0 && j < col_pad) ? xs[j] : T(0);
    acc += v[kk * plane] * xv;
  }
  y[shard * plane + r] = acc;
}

template <typename T, typename P>
static int launch(const void* values, const void* pos, const void* w0,
                  const void* x, void* y, long long ngroups, int k,
                  int tile_groups, long long col_pad, int nshards,
                  void* stream) {
  if (ngroups < 1 || k < 1 || tile_groups < 1 || ngroups % tile_groups ||
      col_pad < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const long long rows = ngroups * 128;
  const dim3 grid((unsigned)((rows + threads - 1) / threads), (unsigned)nshards);
  well_spmv_kernel<T, P><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<const P*>(pos),
      static_cast<const int*>(w0), static_cast<const T*>(x),
      static_cast<T*>(y), ngroups, k, tile_groups, col_pad);
  return (int)cudaGetLastError();
}

#define WELL_ENTRY(NAME, T, P)                                               \
  int NAME(const void* values, const void* pos, const void* w0,             \
           const void* x, void* y, long long ngroups, int k,                \
           int tile_groups, long long col_pad, int nshards, void* stream) { \
    return launch<T, P>(values, pos, w0, x, y, ngroups, k, tile_groups,     \
                        col_pad, nshards, stream);                          \
  }

extern "C" {
WELL_ENTRY(well_spmv_f32_i16, float, short)
WELL_ENTRY(well_spmv_f32_i32, float, int)
WELL_ENTRY(well_spmv_f64_i16, double, short)
WELL_ENTRY(well_spmv_f64_i32, double, int)
}  // extern "C"
