// DIA block SpMM kernels (Y = A X for nrhs columns) for Hopper (sm_90a),
// vanilla and symmetric storage.
//
// Replaces the Pallas TPU kernels of spmv_tpu/ops/:
//   dia_spmm      <- spmm_dia_pallas.py _dia_mrhs_kernel  (:43, pallas_call
//                    :127, wrapper _spmm_dia_pallas_2d :114)
//   dia_sym_spmm  <- spmv_dia_pallas.py _dia_sym_kernel at nrhs > 1 (:265,
//                    wrapper _spmv_dia_sym_pallas_2d :498, reached from
//                    spmm_dia_pallas.spmm_dia :213-217)
// It computes what those kernels compute, not how: their window DMA, lane
// rolls and (symmetric) one-tile carry exist because the TPU grid runs in
// order from VMEM; none of that carries over.
//
// Layout (spmv_torch/ops/spmm_dia.py): D shards stacked. Each shard's data is
// (npad/128, K*128) with data[s, r, k*128 + l] = A_s[128r+l, 128r+l+off_k]
// (the DiaMatrix layout). X and Y are in the SpMM lane layout: per shard
// (npad/128, nrhs*128), element (q, c*128 + l) is row 128q+l of column c. So
// the 32 neighbouring rows of a warp read 32 contiguous elements of one
// column. x~[s, j] = x[s, j] for 0 <= j < npad and 0 otherwise: a shard
// never reads its neighbour's entries.
//
// Bound: bytes. One apply must move K*npad*itemsize of matrix (stored
// diagonals: K_sym for symmetric storage) plus X and Y once, 2*nrhs*npad*
// itemsize, per shard; with chunks of 8 columns the matrix moves
// ceil(nrhs/8) times. Arithmetic is 2 flops per stored element and column.
// bf16 storage accumulates in fp32 and rounds y once, at the store.
//
// dia_spmm is the tile kernel of dia_window.cuh: a CTA takes R rows and a
// chunk of at most 8 columns, stages each x window once for all its
// columns and its rows of each diagonal in shared memory with bulk copies
// of the Tensor Memory Accelerator, and sums from there; on wide bands
// (K = 65 and 297 on AMG's 1-D interval levels) the diagonals go in stages
// whose copies overlap the previous stage's sums. Its one-thread-a-row
// predecessor read every shifted X element once per diagonal through L1/L2,
// 8 columns wide, behind a per-column mask that kept the loads from
// issuing together.
//
// dia_sym_spmm: one thread per output row, blockIdx.y = shard, blockIdx.z =
// a chunk of at most NR = 8 columns. The thread reads each stored diagonal
// element once per chunk and applies it to each of its columns, with one
// accumulator a column in registers. The chunk's width is a template
// parameter (NR = min(nrhs, 8); the narrower last chunk of an nrhs > 8
// block takes its own instance), so no column's loads wait behind a mask:
// its first version guarded each column with `if (c < nc)`, and dropping that
// took 3200^2 nrhs 8 from 1.52x its bound to 1.22x in fp32 and from 3.72x to
// 1.72x in bf16 (PERF.md). The offsets come from device memory (no
// cap on K). The shifted x reads and the transpose term's shifted data
// reads touch lines that neighbouring warps read too and are served from
// L1/L2. The wrapper's route (ops/spmv_dia_cuda.py `route`) runs this
// kernel at every shape: the tile kernel of dia_window.cuh, its transpose
// term taken to every column, was slower at every Laplacian block measured
// (by 1-46%) and won only three wide-band cases no path runs, by at most 6%.
//
// Column c takes exactly the operations dia_spmv / dia_sym_spmv take on it,
// in the same order (acc += d * x, k ascending; the symmetric transpose term
// right after its forward term), so nvcc contracts them the same way and
// each column equals the single-RHS kernel's result bit for bit.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmm_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_window.cuh"

#define SPMM_MAX_NR 8

// dia_sym_spmm's direct kernel: one row a thread, the NC columns of its
// chunk in registers, each column's loads unmasked (NC is the chunk's
// width at compile time)
template <typename T, int NC>
__device__ __forceinline__ void sym_row(const T* __restrict__ ds, const T* __restrict__ xs,
                                        T* __restrict__ ys, long long i, long long npad,
                                        int ndiags, long long lanes,
                                        const long long* __restrict__ offs) {
  typedef typename dia_window::Acc<T>::type Acc;
  const long long row_stride = (long long)ndiags * 128;
  const T* drow = ds + (i >> 7) * row_stride + (i & 127);
  Acc acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = Acc(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long o = __ldg(offs + k);  // o <= 0
    const long long j = i + o;
    const bool in = j >= 0;
    const long long jo = in ? (j >> 7) * lanes + (j & 127) : 0;
    const Acc d = dia_window::load(drow[(long long)k * 128]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const Acc xv = in ? dia_window::load(xs[jo + c * 128]) : Acc(0);
      acc[c] += d * xv;
    }
    if (o < 0) {
      // transpose of the stored entry A[t, t+o] at t = i-o lands on row i
      const long long t = i - o;
      if (t < npad) {
        const Acc dt = dia_window::load(ds[(t >> 7) * row_stride + (long long)k * 128 + (t & 127)]);
        const long long to = (t >> 7) * lanes + (t & 127);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] += dt * dia_window::load(xs[to + c * 128]);
      }
    }
  }
  T* yr = ys + (i >> 7) * lanes + (i & 127);
#pragma unroll
  for (int c = 0; c < NC; ++c) yr[c * 128] = dia_window::store<T>(acc[c]);
}

// blockIdx.y = shard, blockIdx.z = a chunk of NR columns; the last chunk of
// an nrhs > 8 block may be narrower, and takes its own width
template <typename T, int NR>
__global__ void dia_sym_spmm_kernel(const T* __restrict__ data,
                                    const T* __restrict__ x, T* __restrict__ y,
                                    long long npad, int ndiags, int nrhs,
                                    const long long* __restrict__ offs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const int c0 = blockIdx.z * NR;
  const long long lanes = (long long)nrhs * 128;
  const T* xs = x + shard * npad * nrhs + c0 * 128;
  const T* ds = data + shard * npad * ndiags;
  T* ys = y + shard * npad * nrhs + c0 * 128;
  const int nc = min(NR, nrhs - c0);
  if (nc == NR) {
    sym_row<T, NR>(ds, xs, ys, i, npad, ndiags, lanes, offs);
    return;
  }
  if constexpr (NR == SPMM_MAX_NR) {
    switch (nc) {
      case 1: sym_row<T, 1>(ds, xs, ys, i, npad, ndiags, lanes, offs); break;
      case 2: sym_row<T, 2>(ds, xs, ys, i, npad, ndiags, lanes, offs); break;
      case 3: sym_row<T, 3>(ds, xs, ys, i, npad, ndiags, lanes, offs); break;
      case 4: sym_row<T, 4>(ds, xs, ys, i, npad, ndiags, lanes, offs); break;
      case 5: sym_row<T, 5>(ds, xs, ys, i, npad, ndiags, lanes, offs); break;
      case 6: sym_row<T, 6>(ds, xs, ys, i, npad, ndiags, lanes, offs); break;
      default: sym_row<T, 7>(ds, xs, ys, i, npad, ndiags, lanes, offs); break;
    }
  }
}

template <typename T, int NR>
static void launch_nr(dim3 grid, int threads, cudaStream_t s, const void* data,
                      const void* x, void* y, long long npad, int ndiags,
                      int nrhs, const long long* offs) {
  dia_sym_spmm_kernel<T, NR><<<grid, threads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y),
      npad, ndiags, nrhs, offs);
}

template <typename T>
static int launch_sym(const void* data, const void* x, void* y, long long npad,
                      int ndiags, const long long* offsets, int nrhs, int nshards,
                      void* stream) {
  if (ndiags < 1 || npad < 1 || nrhs < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int nr = nrhs < SPMM_MAX_NR ? nrhs : SPMM_MAX_NR;
  const int threads = 256;
  const dim3 grid((unsigned)((npad + threads - 1) / threads), (unsigned)nshards,
                  (unsigned)((nrhs + nr - 1) / nr));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 1: launch_nr<T, 1>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 2: launch_nr<T, 2>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 3: launch_nr<T, 3>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 4: launch_nr<T, 4>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 5: launch_nr<T, 5>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 6: launch_nr<T, 6>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 7: launch_nr<T, 7>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    default: launch_nr<T, 8>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
  }
  return (int)cudaGetLastError();
}

// dia_spmm: the tile kernel with NR = the smallest of 1, 2, 4, 8 that holds
// min(nrhs, 8) columns (the plan stages exactly min(nrhs, 8))
template <typename T>
static int launch_tile(const void* data, const void* x, void* y, long long npad,
                       int ndiags, const int* plan, int rows, int smem_bytes,
                       int nrhs, int nshards, void* stream) {
  if (ndiags < 1 || npad < 1 || nrhs < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nrhs == 1) {
    return dia_window::launch<T, 1, false>(data, x, y, npad, nrhs, nshards, plan, rows, smem_bytes, s);
  }
  if (nrhs == 2) {
    return dia_window::launch<T, 2, false>(data, x, y, npad, nrhs, nshards, plan, rows, smem_bytes, s);
  }
  if (nrhs <= 4) {
    return dia_window::launch<T, 4, false>(data, x, y, npad, nrhs, nshards, plan, rows, smem_bytes, s);
  }
  return dia_window::launch<T, 8, false>(data, x, y, npad, nrhs, nshards, plan, rows, smem_bytes, s);
}

#define DIA_SPMM_ENTRY(NAME, T)                                                \
  int NAME(const void* data, const void* x, void* y, long long npad,           \
           int ndiags, const int* plan, int rows, int smem_bytes, int nrhs,    \
           int nshards, void* stream) {                                        \
    return launch_tile<T>(data, x, y, npad, ndiags, plan, rows, smem_bytes,    \
                          nrhs, nshards, stream);                              \
  }

#define DIA_SYM_SPMM_ENTRY(NAME, T)                                            \
  int NAME(const void* data, const void* x, void* y, long long npad,           \
           int ndiags, const long long* offsets, int nrhs, int nshards,        \
           void* stream) {                                                     \
    return launch_sym<T>(data, x, y, npad, ndiags, offsets, nrhs, nshards,     \
                         stream);                                              \
  }

// dia_spmm's `plan`: the device int32 words of its window plan, with its
// tile rows and shared-memory bytes; dia_sym_spmm's `offsets`: a device
// pointer to ndiags int64 offsets
extern "C" {
DIA_SPMM_ENTRY(dia_spmm_f32, float)
DIA_SPMM_ENTRY(dia_spmm_f64, double)
DIA_SPMM_ENTRY(dia_spmm_bf16, __nv_bfloat16)
DIA_SYM_SPMM_ENTRY(dia_sym_spmm_f32, float)
DIA_SYM_SPMM_ENTRY(dia_sym_spmm_f64, double)
DIA_SYM_SPMM_ENTRY(dia_sym_spmm_bf16, __nv_bfloat16)
}  // extern "C"
