// The DIA tile kernel with shared-memory windows, for Hopper (sm_90a).
// It computes dia_sym_spmv (spmv_dia.cu; symmetric storage, one column) and
// dia_spmm (spmm_dia.cu; vanilla storage, up to NR = 8 columns a CTA) at
// every shape. The wrappers' route (ops/spmv_dia_cuda.py `route`) sends
// dia_spmv and dia_sym_spmm elsewhere: on the card this kernel at one
// vanilla column lost to dia_spmv_rows at every shape and to the
// one-row-a-thread loop kernel on wide bands, and on symmetric blocks to
// dia_sym_spmm's direct kernel (PERF.md), where its CTAs stage five x
// windows for every column. It sends dia_sym_spmv on offsets that span
// planes, where the plan misses SMEM_TARGET (HPCG's 27-point operator:
// 35 windows a 128-row tile, 53% of its bound), to dia_stream.cu.
//
// Layout (spmv_torch/formats/dia.py, ops/spmm_dia.py): D shards stacked;
// shard s's data is (npad/128, K*128) with data[s, q, k*128 + l] =
// A_s[128q+l, 128q+l+off_k]; x and y are in the SpMM lane layout, per shard
// (npad/128, nrhs*128), element (q, c*128 + l) = row 128q+l of column c
// (nrhs = 1 is the single-RHS layout). x~[s, j] = x[s, j] for 0 <= j < npad
// and 0 otherwise: a shard never reads its neighbour's rows.
//
// What bounds it: bytes, once enough of them are in flight. On the card
// (ablations in PERF.md), the one-thread-a-row kernels it replaces ran 1.5-1.7x
// (fp32) and 2.5-3.1x (bf16) from their bound whether or not the far
// diagonals or the transpose term were there, and 1.2x once each thread
// kept more loads in flight (K fixed at compile time, or four rows a
// thread); dia_spmm lost another 1.5x to its per-column masked loads.
//
// Design. A CTA of kThreads threads takes a tile of R = RPT * kThreads rows
// of one shard (blockIdx.y) and one chunk of at most NR columns
// (blockIdx.z). A plan made once per operator on the host
// (ops/spmv_dia_cuda.py window_plan, kept on the card as int32 words) lists
// what the tile reads, in rows relative to its first row i0:
//   - the x windows: the rows [o, R + o) each read offset reaches (the
//     stored offsets, and -o for each o < 0 in symmetric storage), rounded
//     out to 16 bytes and merged wherever they overlap or touch; a window
//     too large for shared memory is marked, and its reads go to global
//     memory instead;
//   - the rows of each diagonal: [0, R), and in symmetric storage for o < 0
//     the rows [-o, R - o) that the transpose term reads, in one window with
//     the forward rows where -o < R. Far transposed rows (o = -3200 on the
//     3200^2 Laplacian) are the forward rows of the CTA 3200/R tiles ahead,
//     which runs at about the same time, so the second read is an L2 hit;
//   - stages: the diagonals whose rows are staged together. Where they do
//     not fit at once, two stage buffers alternate: the copies of stage
//     g + 1 are in flight while stage g is summed;
//   - the copies: every window cut at 128-row tile rows, each piece one
//     contiguous run of a column or a diagonal.
// Warp 0 issues each piece as one bulk copy of the Tensor Memory
// Accelerator (cp.async.bulk, completing on an mbarrier), so a tile's whole
// read is in flight at once and no thread spends instructions on
// addresses; a piece outside [0, npad) of the CTA's own shard is written as
// zeros instead (0 and npad are multiples of 128 rows, so a piece lies
// wholly inside or wholly outside). On the card, staging the same copy
// lists with per-thread 16-byte cp.async, a piece at a time, took 3.5x as
// long, and CTAs that walk several tiles with every buffer doubled were
// slower than one tile a CTA with twice the CTAs resident; the fastest
// tile holds about 15 KB of shared memory in every dtype, so the plan takes
// the largest R that fits 17 KB (PERF.md). What
// bounds it now: a CTA's sums do not overlap its own staging, only other
// CTAs' (staging and stores alone take 95% of the fp32 dia_sym_spmv time
// at 3200^2). Each window is read for every diagonal of its
// interval: on the Laplacian three x windows of about R rows, not five
// reads of x a row; at K = 297 one window of R + 296 rows, not 297.
// Thread t sums rows t, t + kThreads, ...: neighbouring threads read
// neighbouring shared words, with no bank conflict in any dtype, and no
// column's load waits on a mask.
//
// The arithmetic is the one-thread-a-row kernels' operation for operation:
// each row's sum is acc += d * x over k ascending, and in symmetric storage
// the transpose term d_o[i-o] * x~[i-o] right after its forward term. A
// zero-filled read adds d * 0 (or 0 * 0 for a transposed row past npad),
// which leaves the sum's bits as they were (the sum is never -0). So every
// column of dia_spmm equals dia_spmv on it bit for bit, whichever kernel
// dia_spmv's route runs, and dia_sym_spmv equals each column of
// dia_sym_spmm. bf16 storage accumulates in fp32 and
// rounds once, at the store; fp64 in fp64. Index math into global memory is
// 64-bit. No atomics, nothing carried between CTAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dia_window {

constexpr int kThreads = 128;
// the plan's words (spmv_torch/ops/spmv_dia_cuda.py _table)
enum Head { kRows, kNdiags, kNwin, kNstages, kXElems, kBufElems, kWinBase,
            kStageBase, kCopyBase, kDiagBase, kCols, kSymmetric, kXCopyBase, kNXCopies };
constexpr int kStageWords = 4, kCopyWords = 4, kDiagWords = 8, kXCopyWords = 4;
constexpr int kSmemDefault = 46 * 1024;  // beyond it (with the static barriers), opt in

// storage type -> accumulation type, and the conversions between them (every
// DIA kernel of spmv_dia.cu and spmm_dia.cu uses these)
template <typename T> struct Acc { typedef T type; };
template <> struct Acc<__nv_bfloat16> { typedef float type; };
__device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float load(float v) { return v; }
__device__ __forceinline__ double load(double v) { return v; }
template <typename T> __device__ __forceinline__ T store(typename Acc<T>::type v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The Tensor Memory Accelerator's bulk copies, completing on an mbarrier
// in shared memory (a CTA is a cluster of one)
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival (the issuing lane's) that also expects `bytes` of copies
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// order this thread's earlier generic reads of shared memory before the
// bulk copies that overwrite it
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void zero_rows(T* dst, int n) {
  for (int i = 0; i < n; ++i) dst[i] = T();
}

// the tile kernel's body; dia_sym_spmv_tile and dia_spmm_tile below are its
// two kernels, named so that a profile says which one ran
template <typename T, int NR, int RPT, bool SYM>
__device__ __forceinline__ void tile(const T* __restrict__ data, const T* __restrict__ x,
                                     T* __restrict__ y, long long npad, int nrhs,
                                     const int* __restrict__ plan) {
  // the transpose term goes to column 0 only: symmetric storage runs here as
  // dia_sym_spmv, one column (dia_sym_spmm's blocks run its direct kernel,
  // faster on the card at every shape measured, PERF.md)
  static_assert(!SYM || NR == 1, "the tile kernel takes symmetric storage one column at a time");
  typedef typename Acc<T>::type A;
  constexpr int R = RPT * kThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned long long bars[2];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int K = __ldg(plan + kNdiags);
  const int nstages = __ldg(plan + kNstages);
  const int buf_elems = __ldg(plan + kBufElems);
  const int* stage = plan + __ldg(plan + kStageBase);
  const int* copy = plan + __ldg(plan + kCopyBase);
  const int* diag = plan + __ldg(plan + kDiagBase);
  const int* xcopy = plan + __ldg(plan + kXCopyBase);
  const int nxcopies = __ldg(plan + kNXCopies);
  T* const bufs = smem + __ldg(plan + kXElems);

  const long long i0 = (long long)blockIdx.x * R;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long lanes = (long long)nrhs * 128;
  const T* xs = x + (long long)blockIdx.y * npad * nrhs + (long long)c0 * 128;
  const T* ds = data + (long long)blockIdx.y * npad * K;
  T* ys = y + (long long)blockIdx.y * npad * nrhs + (long long)c0 * 128;
  const long long dstride = (long long)K * 128;

  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
  }
  __syncthreads();

  // Warp 0 stages stage g's diagonal rows into buffer `b` (and, with
  // `with_x`, the x windows): each lane takes every 32nd copy. A copy is
  // one contiguous run of at most 128 rows; one that lies outside
  // [0, npad) is written as zeros instead. Then lane 0 arrives on the
  // stage's barrier expecting the bytes of all the warp's bulk copies (a
  // barrier's transaction count may run below zero until that arrival, so
  // the copies need not wait for it).
  auto issue = [&](int g, T* b, bool with_x, unsigned long long* bar) {
    const int lane = tid & 31;
    const int first = __ldg(stage + kStageWords * g + 2);
    const int end = __ldg(stage + kStageWords * g + 3);
    const int nx = with_x ? nxcopies * nc : 0;
    fence_async();
    unsigned bytes = 0;
    for (int p = lane; p < nx + end - first; p += 32) {
      if (p < nx) {
        const int* e = xcopy + kXCopyWords * (p / nc);
        const int c = p % nc;
        const long long j = i0 + __ldg(e);
        const int n = __ldg(e + 1);
        T* dst = smem + __ldg(e + 2) + c * __ldg(e + 3);
        if (j >= 0 && j < npad) {
          bulk_copy(dst, xs + (j >> 7) * lanes + c * 128 + (j & 127), n * sizeof(T), bar);
          bytes += n * sizeof(T);
        } else {
          zero_rows(dst, n);
        }
      } else {
        const int* e = copy + kCopyWords * (first + p - nx);
        const long long k = __ldg(e);
        const long long j = i0 + __ldg(e + 1);
        const int n = __ldg(e + 2);
        T* dst = b + __ldg(e + 3);
        if (j >= 0 && j < npad) {
          bulk_copy(dst, ds + (j >> 7) * dstride + k * 128 + (j & 127), n * sizeof(T), bar);
          bytes += n * sizeof(T);
        } else {
          zero_rows(dst, n);
        }
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, s);
    if (lane == 0) bar_expect(bar, bytes);
  };
  if (tid < 32) issue(0, bufs, true, &bars[0]);

  A acc[RPT][NR];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int c = 0; c < NR; ++c) acc[r][c] = A(0);

  for (int g = 0; g < nstages; ++g) {
    // the next stage's copies go into the other buffer while this one is summed
    if (g + 1 < nstages && tid < 32) {
      issue(g + 1, bufs + ((g + 1) & 1) * buf_elems, false, &bars[(g + 1) & 1]);
    }
    bar_wait(&bars[g & 1], (g >> 1) & 1);
    __syncthreads();  // and warp 0's zero rows are visible
    const T* b = bufs + (g & 1) * buf_elems;
    const int k0 = __ldg(stage + kStageWords * g);
    const int k1 = __ldg(stage + kStageWords * g + 1);
    for (int k = k0; k < k1; ++k) {
      const int* e = diag + kDiagWords * k;
      const int o = __ldg(e), xf = __ldg(e + 1), xfl = __ldg(e + 2), df = __ldg(e + 5);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = tid + r * kThreads;
        const A d = load(b[df + row]);
        if (xf >= 0) {
#pragma unroll
          for (int c = 0; c < NR; ++c) {
            if (c < nc) acc[r][c] += d * load(smem[xf + c * xfl + row]);
          }
        } else {
          const long long j = i0 + row + o;
          const bool in = j >= 0 && j < npad;
          const long long jo = in ? (j >> 7) * lanes + (j & 127) : 0;
#pragma unroll
          for (int c = 0; c < NR; ++c) {
            if (c < nc) acc[r][c] += d * (in ? load(xs[jo + c * 128]) : A(0));
          }
        }
        if (SYM && o < 0) {
          // the transpose of the stored A[t, t+o] at t = i - o lands on row i
          const int xt = __ldg(e + 3), dt = __ldg(e + 6);
          const A dv = load(b[dt + row]);
          if (xt >= 0) {
            acc[r][0] += dv * load(smem[xt + row]);
          } else {
            const long long t = i0 + row - o;
            acc[r][0] += dv * (t < npad ? load(xs[(t >> 7) * lanes + (t & 127)]) : A(0));
          }
        }
      }
    }
    __syncthreads();  // stage g's buffer is free for stage g + 2
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long i = i0 + tid + r * kThreads;
    if (i < npad) {
#pragma unroll
      for (int c = 0; c < NR; ++c) {
        if (c < nc) ys[(i >> 7) * lanes + c * 128 + (i & 127)] = store<T>(acc[r][c]);
      }
    }
  }
}

// twelve CTAs an SM (at most 40 registers a thread: 5% faster than eight in
// fp32 on the 3200^2 Laplacian, PERF.md)
template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads, 12)
dia_sym_spmv_tile(const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                  long long npad, int nrhs, const int* __restrict__ plan) {
  tile<T, 1, RPT, true>(data, x, y, npad, nrhs, plan);
}

// eight CTAs an SM (at most 64 registers a thread) unless the accumulators
// alone would take a quarter of them
template <typename T, int NR, int RPT>
__global__ void __launch_bounds__(kThreads,
                                  NR * RPT * sizeof(typename Acc<T>::type) > 64 ? 4 : 8)
dia_spmm_tile(const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
              long long npad, int nrhs, const int* __restrict__ plan) {
  tile<T, NR, RPT, false>(data, x, y, npad, nrhs, plan);
}

template <typename T, int NR, int RPT, bool SYM>
static int launch_rpt(const void* data, const void* x, void* y, long long npad,
                      int nrhs, int nshards, const int* plan, int smem_bytes,
                      cudaStream_t s) {
  void (*kernel)(const T*, const T*, T*, long long, int, const int*);
  if constexpr (SYM) {
    kernel = dia_sym_spmv_tile<T, RPT>;
  } else {
    kernel = dia_spmm_tile<T, NR, RPT>;
  }
  if (smem_bytes > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long rows = (long long)RPT * kThreads;
  const dim3 grid((unsigned)((npad + rows - 1) / rows), (unsigned)nshards,
                  (unsigned)((nrhs + NR - 1) / NR));
  kernel<<<grid, kThreads, smem_bytes, s>>>(static_cast<const T*>(data),
                                             static_cast<const T*>(x),
                                             static_cast<T*>(y), npad, nrhs, plan);
  return (int)cudaGetLastError();
}

// One launch for all shards and column chunks. `rows` (R) and `smem_bytes`
// are the plan's, passed by the host so that nothing is read back.
template <typename T, int NR, bool SYM>
static int launch(const void* data, const void* x, void* y, long long npad, int nrhs,
                  int nshards, const int* plan, int rows, int smem_bytes,
                  cudaStream_t s) {
  switch (rows) {
    case 128: return launch_rpt<T, NR, 1, SYM>(data, x, y, npad, nrhs, nshards, plan, smem_bytes, s);
    case 256: return launch_rpt<T, NR, 2, SYM>(data, x, y, npad, nrhs, nshards, plan, smem_bytes, s);
    case 512: return launch_rpt<T, NR, 4, SYM>(data, x, y, npad, nrhs, nshards, plan, smem_bytes, s);
    case 1024: return launch_rpt<T, NR, 8, SYM>(data, x, y, npad, nrhs, nshards, plan, smem_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dia_window
