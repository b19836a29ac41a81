// dia_sym_spmv_stream: the symmetric, single-column DIA apply for offsets
// that fall into several far-apart clusters (a 3-D stencil's planes), for
// Hopper (sm_90a).
//
// It replaces no Pallas kernel of its own: it is a second design of
// _dia_sym_kernel (spmv_tpu/ops/spmv_dia_pallas.py:265), beside the tile
// kernel of dia_window.cuh, for offsets that span planes. The wrappers'
// route (ops/spmv_dia_cuda.py `route`) sends a dia_sym_spmv apply here only
// where the tile kernel's window plan misses its shared-memory target and
// the read offsets (the stored ones, and -o for each o < 0) form at least
// two clusters that this kernel's rings hold: HPCG's 27-point operator in
// fp64 (offsets in three planes). Every other apply keeps its route.
//
// Layout (spmv_torch/formats/dia.py): D shards stacked; shard s's data is
// (npad/128, K*128) with data[s, q, k*128 + l] = A_s[128q+l, 128q+l+off_k]:
// a 128-row block q holds all K diagonals contiguously, in ascending offset
// order. x and y are (D, npad); x~[s, j] = x[s, j] for 0 <= j < npad and 0
// otherwise.
//
// What bounds it: bytes, (K + 2) * npad * itemsize an apply. What held the
// tile kernel back on HPCG (PERF.md): its plan misses 17 KB, so it runs
// tiles of 128 rows, each staging 35 windows of about 1 KB (9 x windows of
// 132 rows, 26 data windows) and summing only after all have landed: 282
// bytes of shared-memory fill a row against 128 from HBM, and no overlap of
// a CTA's copies with its own sums (53% of its bound).
//
// Design. Persistent CTAs, one an SM, each walking runs of 128-row blocks
// of one shard in order (a run of `run` blocks; run r of a shard is taken
// by CTA r mod grid). The read offsets fall into clusters (one a plane);
// the host's plan (ops/spmv_dia_cuda.py stream_plan, passed by value, so
// every per-diagonal word is an operand of the constant bank) keeps one
// sliding window of blocks a cluster:
//   - x: one window a cluster ([q + lo, q + hi] around block q: the plane
//     below, this plane, the plane above);
//   - the forward data: all K diagonals of blocks [q, q + hi], hi where the
//     transposed rows of the in-plane diagonals end (3 for HPCG);
//   - each other cluster's transposed data: the diagonals whose -o falls in
//     it (k = 0..8 for HPCG, one contiguous copy a block), the plane above.
// Each window slides one block a step, so each block of each window is one
// bulk copy of the Tensor Memory Accelerator, made once (a run's first step
// copies its windows whole): for HPCG in fp64 5 copies and 26 KB a block,
// where the tile kernel makes 35 copies and 36 KB. Warp 0 is the
// producer, a lane a window: it keeps `depth` steps of copies in flight
// ahead of the sums, in rings of ns slots, on a full barrier a step; it
// refills a slot once the step that last read it has arrived on that step's
// empty barrier. Groups of 128 consumer threads take the steps in turn (two
// in fp64, four in fp32 and bf16), a thread a row; a group waits on the
// full barriers of every step since its own last one (the blocks it reads
// came in on them), and issues the reads of kChunk diagonals before their
// sums. A block outside [0, npad) is copied from a zero buffer. A run's
// first step waits for every earlier step to be summed, then refills every
// ring from its first slot. Runs as long as the cluster spacing (a plane;
// halved while there are fewer runs than SMs) put the run a plane above on
// a neighbouring CTA at the same step, so the transposed rows and x that
// one CTA reads a plane ahead are the rows its neighbour reads as its own
// at about the same time: the second read is an L2 hit.
//
// On the card (H100, PERF.md): 0.766 ms an apply at 256^3 in fp64, 84% of
// its bound, where the tile kernel takes 1.20 (53%); 0.639 in fp32 (50%),
// the tile kernel 0.651. The sums' integer work sets the pace: with the
// copies alone (no sums) a step took as long in fp32 as in fp64; one lane
// issuing every window's copies, or a 64-bit division for each barrier's
// index and parity, cost 1-2 us a step, and are gone (a lane a window,
// counters kept step by step). On the 3200^2 Laplacian, where runs are 25
// blocks and each run starts by draining the rings, it takes 0.312 ms
// against the tile kernel's 0.147, so the route keeps it there.
//
// The arithmetic is the tile kernel's operation for operation: each row's
// sum is acc += d * x over k ascending, each transposed term
// d_o[i-o] * x~[i-o] right after its forward term, a zero-filled read adding
// d * 0 (or 0 * 0 past npad). So it equals dia_sym_spmv_tile bit for bit in
// every dtype. bf16 accumulates in fp32 and rounds once, at the store.
// Index math into global memory is 64-bit. No atomics, nothing carried
// between CTAs.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "dia_window.cuh"

namespace dia_stream {

using dia_window::Acc;
using dia_window::bar_expect;
using dia_window::bar_wait;
using dia_window::bulk_copy;
using dia_window::fence_async;
using dia_window::load;
using dia_window::smem_u32;
using dia_window::store;

constexpr int kMaxK = 16;     // diagonals
constexpr int kMaxWin = 8;    // windows
constexpr int kMaxBars = 16;  // full (and empty) barriers: depth + groups
// consumer groups of 128 threads, taking steps in turn: fp64 sums are
// fastest with two (registers for a chunk's loads), fp32 and bf16, with half
// the bytes a step, need four to keep up (PERF.md)
constexpr int kGroupsWide = 2;    // fp64
constexpr int kGroupsNarrow = 4;  // fp32, bf16
template <typename T> __host__ __device__ constexpr int groups_of() {
  return sizeof(T) == 8 ? kGroupsWide : kGroupsNarrow;
}
constexpr int kChunk = 4;     // diagonals whose reads go in flight together (fp64:
//                               4 beat 8, whose loads took the registers of a
//                               second group)
constexpr int kMinRun = 8;    // blocks: runs are halved to fill the SMs down to this

// the plan's int32 words (ops/spmv_dia_cuda.py stream_plan): a head, six
// words a window (x windows first, then the forward data window, then the
// far data windows), eight a diagonal
enum Head { kK, kNX, kNWin, kNsF, kNsO, kDepth, kSpan, kSmem, kHeadWords = 16 };
struct Plan {
  int head[kHeadWords];
  // window w: its first diagonal and count (x: 0 and 1), its blocks
  // [q + lo, q + lo + width) at block q, its ring's slots and shared offset
  int w_k0[kMaxWin], w_nk[kMaxWin], w_lo[kMaxWin], w_width[kMaxWin], w_ns[kMaxWin],
      w_base[kMaxWin];
  // diagonal k: its forward x read (rows from its window's first block, the
  // window's shared offset), its transposed x read (base -1 where o >= 0),
  // its transposed data read (1 from a far window / 0 from the forward one,
  // rows from the window's first block, the shared offset of the diagonal's
  // rows in slot 0, the elements a slot)
  int xf_rel[kMaxK], xf_base[kMaxK], xt_rel[kMaxK], xt_base[kMaxK];
  int dt_far[kMaxK], dt_rel[kMaxK], dt_base[kMaxK], dt_stride[kMaxK];
};
static_assert(sizeof(Plan) == 4 * (kHeadWords + 6 * kMaxWin + 8 * kMaxK), "plan words");

__device__ __forceinline__ void bar_init_count(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Step g's barrier is bars[g % nbars] in its phase of parity (g / nbars) & 1.
// The counters keep (bi, par) of the current step, so that no step pays a
// division: wait_back waits on the step `back` (0 <= back < nbars) before it.
__device__ __forceinline__ void wait_back(unsigned long long* bars, int nbars, int bi,
                                          unsigned par, int back) {
  int i = bi - back;
  if (i < 0) {
    i += nbars;
    par ^= 1u;
  }
  bar_wait(&bars[i], par);
}

template <typename T, int G = groups_of<T>()>
__global__ void __launch_bounds__(32 + G * 128, 1)
dia_sym_spmv_stream(const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                    const T* __restrict__ zeros, long long npad, int nshards, int run,
                    const __grid_constant__ Plan p) {
  typedef typename Acc<T>::type A;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ unsigned long long full[kMaxBars], empty[kMaxBars];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int K = p.head[kK];
  const int depth = p.head[kDepth];
  // a group waits on the full barriers of its step and the G - 1 before
  // it; a barrier is reused nbars steps on, and the producer fills step s
  // once step s - 1 - depth is summed, so with nbars >= depth + G none of
  // those barriers can have moved two phases on (same parity, not yet
  // complete) before the group is done waiting
  const int nbars = depth + G;
  const long long nblocks = npad >> 7;
  const long long runs_per_shard = (nblocks + run - 1) / run;
  const long long nruns = runs_per_shard * nshards;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int b = 0; b < nbars; ++b) {
      bar_init_count(&full[b], 1);
      bar_init_count(&empty[b], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 32) {
    // the producer: lane w keeps window w, step g's copies on full[g % nbars]
    const int nx = p.head[kNX], nwin = p.head[kNWin];
    const int w = tid;
    if (w >= nwin) return;
    unsigned steady = 0, first = 0;  // the bytes of a step, and of a run's first step
    for (int v = 0; v < nwin; ++v) {
      const unsigned n = p.w_nk[v] * 128 * (unsigned)sizeof(T);
      steady += n;
      first += p.w_width[v] * n;
    }
    const int width = p.w_width[w], ns = p.w_ns[w], nk = p.w_nk[w], lo = p.w_lo[w];
    const unsigned n = nk * 128 * (unsigned)sizeof(T);
    const long long stride = w < nx ? 128 : (long long)K * 128;  // elements a block
    T* const ring = smem + p.w_base[w];
    int g = 0, bi = 0;  // the step, and its barriers' index and parity
    unsigned par = 0;
    for (long long r = blockIdx.x; r < nruns; r += gridDim.x) {
      const long long shard = r / runs_per_shard;
      const long long q0 = (r % runs_per_shard) * run;
      const int steps = (int)min((long long)run, nblocks - q0);
      const T* src = (w < nx ? x + shard * npad : data + shard * npad * K + p.w_k0[w] * 128);
      long long b = q0 + lo;  // the block the next copy takes
      int slot = 0;           // and its slot
      for (int t = 0; t < steps; ++t) {
        // the slots this step fills were last read by step g - 1 - depth;
        // a run's first step refills every slot, so waits for every step
        for (int back = t == 0 ? 1 : 1 + depth; back <= 1 + depth && back <= g; ++back) {
          wait_back(empty, nbars, bi, par, back);
        }
        fence_async();
        unsigned long long* bar = &full[bi];
        if (w == 0) bar_expect(bar, t == 0 ? first : steady);
        for (int d = t == 0 ? 0 : width - 1; d < width; ++d) {
          bulk_copy(ring + slot * nk * 128, b >= 0 && b < nblocks ? src + b * stride : zeros,
                    n, bar);
          ++b;
          if (++slot == ns) slot = 0;
        }
        ++g;
        if (++bi == nbars) {
          bi = 0;
          par ^= 1u;
        }
      }
    }
    return;
  }

  // the consumers: group (tid - 32) / 128 sums the steps g with
  // g % G == group, row l of the step's block a thread
  const int c = tid - 32;
  const int group = c >> 7, l = c & 127;
  const int ns_f = p.head[kNsF], ns_o = p.head[kNsO];
  const int m_o = ns_o * 128;  // elements of an x ring
  const int f_base = p.w_base[p.head[kNX]];
  int g = 0, bi = 0, turn = 0;  // the step, its barriers' index and parity, g % G
  unsigned par = 0;
  for (long long r = blockIdx.x; r < nruns; r += gridDim.x) {
    const long long shard = r / runs_per_shard;
    const long long q0 = (r % runs_per_shard) * run;
    const int steps = (int)min((long long)run, nblocks - q0);
    T* ys = y + shard * npad + q0 * 128 + l;
    int s_f = 0, s_o = 0;  // t mod ns_f, t mod ns_o: the slots of each window's first block
    for (int t = 0; t < steps; ++t) {
      if (turn == group) {
        // every step since this group's last one brought blocks this step reads
        for (int back = G - 1; back >= 0; --back) {
          if (back <= g) wait_back(full, nbars, bi, par, back);
        }
        const T* f = smem + f_base + s_f * K * 128 + l;
        const int tl = s_o * 128 + l;
        // the reads of a chunk of diagonals first (independent loads in flight
        // together), then its sums in the tile kernel's order
        A acc = A(0);
#pragma unroll
        for (int k0 = 0; k0 < kMaxK; k0 += kChunk) {
          A xv[kChunk], dv[kChunk], xtv[kChunk], dtv[kChunk];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int k = k0 + j;
            if (k < K) {
              int e = tl + p.xf_rel[k];
              if (e >= m_o) e -= m_o;
              xv[j] = load(smem[p.xf_base[k] + e]);
              dv[j] = load(f[k * 128]);
              if (p.xt_base[k] >= 0) {
                int et = tl + p.xt_rel[k];
                if (et >= m_o) et -= m_o;
                xtv[j] = load(smem[p.xt_base[k] + et]);
                const int u = l + p.dt_rel[k];
                const int ns = p.dt_far[k] ? ns_o : ns_f;
                int slot = (p.dt_far[k] ? s_o : s_f) + (u >> 7);
                if (slot >= ns) slot -= ns;
                dtv[j] = load(smem[p.dt_base[k] + slot * p.dt_stride[k] + (u & 127)]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int k = k0 + j;
            if (k < K) {
              acc += dv[j] * xv[j];
              // the transpose of the stored A[t, t+o] at t = i - o lands on row i
              if (p.xt_base[k] >= 0) acc += dtv[j] * xtv[j];
            }
          }
        }
        ys[(long long)t * 128] = store<T>(acc);
        bar_arrive(&empty[bi]);
      }
      if (++s_f == ns_f) s_f = 0;
      if (++s_o == ns_o) s_o = 0;
      ++g;
      if (++bi == nbars) {
        bi = 0;
        par ^= 1u;
      }
      if (++turn == G) turn = 0;
    }
  }
}

// One launch for all shards: a CTA an SM, or one a run where there are
// fewer runs. The run is the plan's span (the cluster spacing, in blocks),
// halved while the shards hold fewer runs than SMs, down to kMinRun.
template <typename T>
static int launch(const void* data, const void* x, void* y, long long npad, int ndiags,
                  const int* words, const void* zeros, int nshards, void* stream) {
  Plan p;
  std::memcpy(&p, words, sizeof(Plan));
  const int depth = p.head[kDepth];
  if (ndiags < 1 || ndiags > kMaxK || p.head[kK] != ndiags || npad < 128 || npad % 128 ||
      nshards < 1 || depth < 1 || depth + groups_of<T>() > kMaxBars || p.head[kNWin] > kMaxWin ||
      p.head[kSpan] < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const long long nblocks = npad / 128;
  auto runs = [&](long long len) { return nshards * ((nblocks + len - 1) / len); };
  long long run = p.head[kSpan];
  while (run > kMinRun && runs(run) < sms) run = (run + 1) / 2;
  const int grid = (int)(runs(run) < sms ? runs(run) : sms);
  const int smem_bytes = p.head[kSmem];
  auto kernel = dia_sym_spmv_stream<T>;
  if (smem_bytes > dia_window::kSmemDefault) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<grid, 32 + groups_of<T>() * 128, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const T*>(zeros), npad, nshards, (int)run, p);
  return (int)cudaGetLastError();
}

}  // namespace dia_stream

// `plan`: the host int32 words of stream_plan (copied into the kernel's
// parameters); `zeros`: a device buffer of at least ndiags * 128 zeros of T
#define DIA_SYM_STREAM_ENTRY(NAME, T)                                                    \
  int NAME(const void* data, const void* x, void* y, long long npad, int ndiags,         \
           const int* plan, const void* zeros, int nshards, void* stream) {              \
    return dia_stream::launch<T>(data, x, y, npad, ndiags, plan, zeros, nshards, stream); \
  }

extern "C" {
DIA_SYM_STREAM_ENTRY(dia_sym_spmv_stream_f32, float)
DIA_SYM_STREAM_ENTRY(dia_sym_spmv_stream_f64, double)
DIA_SYM_STREAM_ENTRY(dia_sym_spmv_stream_bf16, __nv_bfloat16)
}  // extern "C"
