// Symmetric Gauss-Seidel on symmetric DIA storage in 8 colours, and the
// residual at the coarse points of a multigrid level, for Hopper (sm_90a):
// HPCG 3.1's smoother (ComputeSYMGS_ref) and the residual half of its
// restriction (ComputeRestriction_ref: rc = r[f2c] - (A x)[f2c]).
//
// Replaces no Pallas kernel: the reference has no multigrid. These are the
// port's first kernels that update a vector in place from its own
// neighbours. Their plain torch versions, with the rules of a sweep, are in
// spmv_torch/ops/symgs_dia.py.
//
// The operator is a grid's: row ix + nx*(iy + ny*iz), every coupling
// between two points of the 27-point neighbourhood, stored as one DIA block
// in symmetric storage (offsets o <= 0, the diagonal included; the value
// of row i at diagonal d lies at data[(i / 128) * K * 128 + d * 128 + i %
// 128]). Row i's coupling to i + o is read at row i, its coupling to i - o
// at row i - o: the storage is read as dia_window.cuh reads its transpose
// term, and no second copy of the operator is kept.
//
// Colours: (ix % 2) + 2 (iy % 2) + 4 (iz % 2); a sweep takes 0 .. 7
// forward, 7 .. 0 backward, and a row reads only its neighbours of the
// colours before its own. Why plane parity is a valid order: a neighbour in
// plane z +- 1 has the other z parity, so in a forward sweep a point of an
// even plane (colours 0-3) reads none outside its plane, and one of an odd
// plane (4-7) reads its own plane and the two even planes beside it;
// backward the roles swap. So a sweep direction is 2 launches, the planes
// of one parity each (even then odd forward, odd then even backward; 1
// where nz = 1), and no plane of a launch waits on another. Inside a plane
// the two colours of a line differ in ix alone; the lines of the parity
// that goes first (even forward, odd backward: "first lines") read no line
// of their plane, and each other line reads the two first lines beside it.
//
// What a block owns: a plane, or a band of one, whose lines it walks with
// a lag: each step takes kSweepThreads / tpl lines, tpl threads each, a
// first line as soon as its turn comes and an other line lag lines later,
// once both first lines beside it are done. Inside a line a thread takes
// the points 2m and 2m + 1 (ix order by the sweep's), the first in the
// step's first stage, the second in its second, with a barrier of the
// line's threads alone between (the warp, or a named barrier; the second
// point reads its line's first points from a line buffer in shared
// memory); a block barrier ends the step. Bands: where a forward sweep's
// planes of one parity leave SMs idle, each plane is cut into bands of an
// even number of lines, at least 4: the caller decides the lines of each
// launch (spmv_torch/ops/symgs_dia_cuda.py) and the entry refuses a band it
// cannot run. A band's last other line needs the next band's first line:
// the block computes that line too, into shared memory (the "ghost" line),
// with the same sums as its owner, so the same bits, and never writes it;
// no block waits on another. A backward sweep is not cut: its update reads
// the row's own x before the sweep, which the owner of a ghost line may
// already have overwritten.
//
// Which terms a point reads: those whose neighbour (by the carry
// arithmetic below, so a diagonal may join different neighbours on
// different rows, as where nx or ny is 2) is one of its 27 and comes
// before it. That set depends on the point only through its place in its
// line and its line's place in its plane (first, last, even or odd
// between), so each block makes a table of 16 masks once. The plain
// version also adds terms whose diagonal reaches past the neighbourhood by
// a carry; their stored values are 0 and add nothing (E is never -0).
//
// How values are staged: a step's values (each sector once a sweep) are
// asked for one step ahead, as asynchronous copies into the second of two
// buffers in shared memory, and the rows' diagonal, r, w and x before the
// sweep one step ahead into registers, so that device memory works on the
// next step while this one waits on x, which its own plane's lines write.
// The planes of the other parity, finished in the launch before, are read
// through the read-only path. Three shapes. Where nx, ny >= 3 the
// couplings inside a plane are the last 5 stored diagonals and the others
// join planes: the first launch of a direction reads only the former, so
// it stages 9 slots a point and runs 512 threads (twice the lines a
// step); the second ("split") sums each point's terms on the diagonals
// before those 5, which come first in the sum and read only final planes,
// a step ahead off the chain, and adds its in-plane terms to that sum in
// the step (256 threads, the registers for a step of far terms). Smaller
// grids and lines of more than 512 points take the full shape: all 14
// diagonals staged, 27 slots a point, 256 threads.
//
// A sweep reads only the neighbours before each row in its order: from
// them (E) and w, the sum over the rows after it that the last backward
// sweep kept (0 from x = 0), it makes Gauss-Seidel's update, and a
// backward sweep keeps its E as the next forward sweep's w (symgs_dia.py
// derives it, and why a V-cycle may). So each coupling is read once a
// sweep. Sums take one rounding a product and one a sum (no fma), in the
// plain version's order, so the two give the same bits.
//
// Bound: bytes. A sweep direction over n rows with L stored values must
// read the values once, x and r once and write x once: 8 (L + 3 n) bytes
// in float64 (0.68 ms for HPCG's 256^3 level at 3.35 TB/s, L = 14 n; one
// from zero reads no x: 8 (L + 2 n)). Here the values and x are read about
// once a sweep (x of the planes beside from the L2). What still holds the
// kernel back: a block's steps are a chain, each waiting on x its own
// plane wrote and on its barriers, with one block of 8 or 16 warps an SM
// (the staging fills shared memory, the far terms the registers); a
// coarse level's few planes leave SMs idle, the more so backward, which is
// never cut into bands; lines of more than 512 points take one line a
// step.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/symgs_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // a block of mg_restrict
constexpr int kSweepThreads = 256;  // a block of the sweep's full shape
constexpr int kLanes = 128;         // rows of a DIA tile row (formats/dia.py)
constexpr int kMaxDiags = 14;       // the 27-point neighbourhood's lower half

// one stored diagonal: u = -offset, split into grid steps
// u = ux + nx * (uy + ny * uz), 0 <= ux < nx, 0 <= uy < ny
struct Step {
  int u, ux, uy, uz;
};

struct Grid {
  int nx, ny, nz;
};

// a neighbour's grid coordinates and colour
struct Nb {
  int x, y, z, colour;
};

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ const T* at(const T* data, int k, int row, int d) {
  return data + (row >> 7) * (k * kLanes) + d * kLanes + (row & (kLanes - 1));
}

template <typename T>
__device__ __forceinline__ T value(const T* __restrict__ data, int k, int row,
                                   int d) {
  return __ldg(at(data, k, row, d));
}

__device__ __forceinline__ int colour_of(int x, int y, int z) {
  return (x & 1) | (y & 1) << 1 | (z & 1) << 2;
}

// the point u rows below (ix, iy, iz): false where it is outside the grid
__device__ __forceinline__ bool below(const Step& s, const Grid& g, int ix,
                                      int iy, int iz, Nb& n) {
  int jx = ix - s.ux;
  int b = jx < 0;
  jx += b * g.nx;
  int jy = iy - s.uy - b;
  b = jy < 0;
  jy += b * g.ny;
  n = Nb{jx, jy, iz - s.uz - b, 0};
  n.colour = colour_of(n.x, n.y, n.z);
  return n.z >= 0;
}

// the point u rows above (ix, iy, iz)
__device__ __forceinline__ bool above(const Step& s, const Grid& g, int ix,
                                      int iy, int iz, Nb& n) {
  int jx = ix + s.ux;
  int c = jx >= g.nx;
  jx -= c * g.nx;
  int jy = iy + s.uy + c;
  c = jy >= g.ny;
  jy -= c * g.ny;
  n = Nb{jx, jy, iz + s.uz + c, 0};
  n.colour = colour_of(n.x, n.y, n.z);
  return n.z < g.nz;
}

__device__ __forceinline__ void load_steps(Step* steps, const Step* table, int k) {
  for (int d = threadIdx.x; d < k; d += blockDim.x) steps[d] = table[d];
  __syncthreads();
}

// the terms of a row: 2 d its lower term on diagonal d, 2 d + 1 its upper
constexpr int kTerms = 2 * kMaxDiags;

// whether a neighbour of colour cj comes before a row of colour c in the
// sweep's order: the only neighbours a sweep reads
template <bool kForward>
__device__ __forceinline__ bool before(int cj, int c) {
  return kForward ? cj < c : cj > c;
}

// whether n, a neighbour by the carry arithmetic above, is one of the 27
// points around (ix, iy, iz): the couplings a stored value can hold
__device__ __forceinline__ bool near(const Nb& n, int ix, int iy, int iz) {
  return abs(n.x - ix) <= 1 && abs(n.y - iy) <= 1 && abs(n.z - iz) <= 1;
}

// a point's place in its line, or a line's in its plane: 0 the first, 3
// the last, 1 and 2 the even and odd ones between. Which 27-point
// neighbours a diagonal joins, so which terms a point reads, depends on
// the point only through these classes of ix and iy (and iz, a block's
// own): a step of -1, 0 or 1 crosses no edge from between them.
__device__ __forceinline__ int place(int i, int n) {
  return i == 0 ? 0 : i == n - 1 ? 3 : 1 + (i & 1);
}

// a point of each place: -1 where the place holds none
__device__ __forceinline__ int sample(int cls, int n) {
  return cls == 0 ? 0 : cls == 3 ? (n > 1 ? n - 1 : -1)
                   : cls == 1 ? (n > 3 ? 2 : -1) : (n > 2 ? 1 : -1);
}

// the terms (bit 2 d lower, 2 d + 1 upper) that the point (ix, iy, iz)
// reads: those whose neighbour is one of its 27 and comes before it in
// the sweep. The plain version also adds the terms whose diagonal reaches
// past them by a carry: their stored values are 0, so they add nothing (E
// is never -0), and the two give the same bits.
template <bool kForward>
__device__ unsigned term_mask(const Step* steps, int k, const Grid& g, int ix,
                              int iy, int iz) {
  const int c = colour_of(ix, iy, iz);
  unsigned m = 0u;
  for (int d = 0; d < k; ++d) {
    const Step st = steps[d];
    if (st.u == 0) continue;
    Nb n;
    if (below(st, g, ix, iy, iz, n) && near(n, ix, iy, iz) &&
        before<kForward>(n.colour, c))
      m |= 1u << (2 * d);
    if (above(st, g, ix, iy, iz, n) && near(n, ix, iy, iz) &&
        before<kForward>(n.colour, c))
      m |= 1u << (2 * d + 1);
  }
  return m;
}

// where a block reads x: rows of another plane (not written in this
// launch) through the read-only path, the ghost line from shared memory,
// the rest of its plane through coherent loads (written by the block
// before its last barrier)
template <typename T>
struct Plane {
  const T* x;
  const T* ghost;
  int p0, size;  // the plane's first row and its rows
  int g0, nx;    // the ghost line's first row (far below 0: none) and points

  __device__ __forceinline__ T at(int j) const {
    if ((unsigned)(j - p0) >= (unsigned)size) return __ldg(x + j);
    if ((unsigned)(j - g0) < (unsigned)nx) return ghost[j - g0];
    return x[j];
  }
};

// what a row's update reads besides E and its diagonal: r, w (0 where
// w_in is null) and, backward, the row's own x before the sweep, asked for
// before E is summed
template <typename T>
struct Row {
  T r, w, x;
};

template <typename T, bool kForward>
__device__ __forceinline__ Row<T> row_inputs(const T* __restrict__ r,
                                             const T* x, const T* w_in, int i) {
  return Row<T>{kForward ? r[i] : T(0), w_in != nullptr ? w_in[i] : T(0),
                kForward ? T(0) : x[i]};
}

// the row's new x from E (``e``, the sum over the rows before it) and w,
// as symgs_dia.py writes the update, written to x (a ghost line's,
// forward only, to ``ghost`` alone) and returned; a backward sweep keeps
// E in ``w_out`` where given
template <typename T, bool kForward>
__device__ __forceinline__ T finish(const Row<T>& in, bool has_w, T* x, T* w_out,
                                    T* ghost, bool to_ghost, int i, int ix, T e,
                                    T diag) {
  if (kForward) {
    const T v = (in.r - (has_w ? add(e, in.w) : e)) / diag;
    if (to_ghost)
      ghost[ix] = v;
    else
      x[i] = v;
    return v;
  }
  const T v = in.x + (in.w - e) / diag;
  x[i] = v;
  if (w_out != nullptr) w_out[i] = e;
  return v;
}

// the terms read (bit t of ``reads``) added in their order
template <typename T>
__device__ __forceinline__ T sum_terms(const T (&v)[kTerms], const T (&xv)[kTerms],
                                       unsigned reads) {
  T e = T(0);
#pragma unroll
  for (int t = 0; t < kTerms; ++t)
    if (reads >> t & 1u) e = add(e, mul(v[t], xv[t]));
  return e;
}

// E of row i and its diagonal in ``diag``, reading the terms ``reads``:
// every read asked for before the sum begins
template <typename T>
__device__ __forceinline__ T point_sum(const T* __restrict__ data,
                                       const Plane<T>& xs, const Step* steps,
                                       int k, int i, unsigned reads, T& diag) {
  T v[kTerms], xv[kTerms];
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {
    if (d >= k) break;
    const int u = steps[d].u;
    if (u == 0) diag = value(data, k, i, d);
    if (reads >> (2 * d) & 1u) {
      v[2 * d] = value(data, k, i, d);
      xv[2 * d] = xs.at(i - u);
    }
    if (reads >> (2 * d + 1) & 1u) {
      v[2 * d + 1] = value(data, k, i + u, d);
      xv[2 * d + 1] = xs.at(i + u);
    }
  }
  return sum_terms(v, xv, reads);
}

// orders the threads of one line of a step: its warp where a line takes
// at most 32 threads, else a named barrier of the line's threads (ids 1 ..
// per_step; 0 is the block's)
__device__ __forceinline__ void line_sync(int slot, int tpl, int threads) {
  if (tpl <= 32)
    __syncwarp();
  else if (tpl == threads)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(tpl) : "memory");
}

// The kernel's shapes: kWindow the stored diagonals it stages, the last
// ones (the diagonal is the last), kFar whether it sums the diagonals
// before the window a step ahead, and its block. Every diagonal, 256
// threads; the last 5 (the couplings inside a plane where nx and ny are at
// least 3, the stored offsets -(nx + 1) .. 0), 512 threads, for the first
// launch of a direction, which reads nothing else; or the last 5 and the
// far terms, 256 threads, for the second.
__host__ __device__ constexpr int threads_of(int window, bool far = false) {
  return window == kMaxDiags || far ? kSweepThreads : 2 * kSweepThreads;
}
constexpr int kPlaneWindow = 5;

// a point's slots for its staged values: its terms' (the term 2 e + side
// of the window's diagonal e), then its diagonal's (the window's last,
// which has no terms)
__host__ __device__ constexpr int slots_of(int window) { return 2 * window - 1; }

// the staged values of a step: two buffers (steps in turn) of two points'
// slots, each slot a row of the block (a thread's column)
template <typename T, int kWindow, int kN>
constexpr size_t staged_bytes() {
  return sizeof(T) * 2 * 2 * slots_of(kWindow) * kN;
}

// asks, as asynchronous copies into the thread's column ``col`` of a
// buffer, for the values that a step's two points read: every term of
// ``ra`` and ``rb`` (bits relative to the window's first diagonal d0) and
// the diagonals (none where a point is absent)
template <typename T, int kWindow, int kN>
__device__ __forceinline__ void stage(T* col, const T* __restrict__ data,
                                      const Step* steps, int k, int d0, int ia,
                                      int ib, bool has_a, bool has_b,
                                      unsigned ra, unsigned rb) {
  constexpr int kS = slots_of(kWindow);
#pragma unroll
  for (int e = 0; e < kWindow; ++e) {
    const int d = d0 + e;
    if (d >= k) break;
    const int u = steps[d].u;
    if (u == 0) {
      if (has_a)
        __pipeline_memcpy_async(col + (kS - 1) * kN, at(data, k, ia, d), sizeof(T));
      if (has_b)
        __pipeline_memcpy_async(col + (2 * kS - 1) * kN, at(data, k, ib, d),
                                sizeof(T));
    }
    if (ra >> (2 * e) & 1u)
      __pipeline_memcpy_async(col + 2 * e * kN, at(data, k, ia, d), sizeof(T));
    if (ra >> (2 * e + 1) & 1u)
      __pipeline_memcpy_async(col + (2 * e + 1) * kN, at(data, k, ia + u, d),
                              sizeof(T));
    if (rb >> (2 * e) & 1u)
      __pipeline_memcpy_async(col + (kS + 2 * e) * kN, at(data, k, ib, d),
                              sizeof(T));
    if (rb >> (2 * e + 1) & 1u)
      __pipeline_memcpy_async(col + (kS + 2 * e + 1) * kN, at(data, k, ib + u, d),
                              sizeof(T));
  }
  __pipeline_commit();
}

// the terms read (bit t of ``reads``), their values staged in ``vals``
// (slot t at vals[t * threads]), added in their order
template <typename T, int kWindow, int kN>
__device__ __forceinline__ T sum_staged(T e, const T* vals,
                                        const T (&xv)[2 * kWindow],
                                        unsigned reads) {
#pragma unroll
  for (int t = 0; t < slots_of(kWindow) - 1; ++t)
    if (reads >> t & 1u) e = add(e, mul(vals[t * kN], xv[t]));
  return e;
}

// the split shape's far terms: those of the diagonals before the window
// (the first d0), which join a plane to the planes beside it, final in the
// second launch of a direction; their values and x asked for a step ahead
constexpr int kFarSlots = 2 * (kMaxDiags - kPlaneWindow);

template <typename T>
__device__ __forceinline__ void far_reads(const T* __restrict__ data, const T* x,
                                          const Step* steps, int k, int d0, int i,
                                          unsigned reads, T (&v)[kFarSlots],
                                          T (&xv)[kFarSlots]) {
#pragma unroll
  for (int d = 0; d < kMaxDiags - kPlaneWindow; ++d) {
    if (d >= d0) break;
    const int u = steps[d].u;
    if (reads >> (2 * d) & 1u) {
      v[2 * d] = value(data, k, i, d);
      xv[2 * d] = __ldg(x + i - u);
    }
    if (reads >> (2 * d + 1) & 1u) {
      v[2 * d + 1] = value(data, k, i + u, d);
      xv[2 * d + 1] = __ldg(x + i + u);
    }
  }
}

template <typename T>
__device__ __forceinline__ T far_sum(const T (&v)[kFarSlots],
                                     const T (&xv)[kFarSlots], unsigned reads) {
  T e = T(0);
#pragma unroll
  for (int t = 0; t < kFarSlots; ++t)
    if (reads >> t & 1u) e = add(e, mul(v[t], xv[t]));
  return e;
}

// the planes iz = pz + 2 p of one parity, ``band`` lines of one a block
// (band even where it cuts a plane), tpl threads a line (a power of two,
// at most the block), the block / tpl lines a step. A thread takes
// the points 2m and 2m + 1 of its line in the sweep's ix order. Which
// terms a point reads comes from the block's table of masks by place
// (``term_mask``). The values of a step's points are asked for one step
// ahead, as asynchronous copies into a second buffer of shared memory, so
// that device memory works on the next step while this one waits on x:
// the first stage reads every x its two points read but the second's own
// line's and sums the first point, the second stage reads those from the
// step's line buffer and sums the second. kFar: each point's sum starts
// from its far terms' (``far_a``, ``far_b``), asked for a step ahead and
// summed at the end of the step before.
// kLong (the full shape alone): lines of more than 2 kSweepThreads points,
// whose further points 2 (m + tpl s) and 2 (m + tpl s) + 1 the thread sums
// whole in their stage, its own line's x from device memory (the kernel of
// short lines keeps none of their code, so neither their registers).
template <typename T, bool kForward, bool kLong, int kWindow, bool kFar>
__global__ void __launch_bounds__(threads_of(kWindow, kFar))
    symgs_dia_lines_planes(const T* __restrict__ data, const T* __restrict__ r,
                           T* x, const T* w_in, T* w_out,
                           const Step* __restrict__ table, int k, Grid g,
                           int pz, int tpl, int band) {
  __shared__ Step steps[kMaxDiags];
  __shared__ unsigned masks[4][4];  // [place of ix][place of iy]
  constexpr int kN = threads_of(kWindow, kFar), kS = slots_of(kWindow);
  __shared__ T ghost[kLong ? 1 : 2 * kN];
  __shared__ T line_x[kLong ? 1 : 2 * kN];  // the step's lines
  extern __shared__ __align__(16) unsigned char staged_raw[];
  T* const col = reinterpret_cast<T*>(staged_raw) + threadIdx.x;
  const int bands = (g.ny + band - 1) / band;
  const int iz = pz + 2 * (int)(blockIdx.x / bands);
  const int y0 = (int)(blockIdx.x % bands) * band;
  const int y1 = min(g.ny, y0 + band);
  const int gy = kLong || y1 == g.ny ? -1 : y1;  // the ghost line
  const int last = gy >= 0 ? gy : y1 - 1;        // the last line walked
  load_steps(steps, table, k);
  if (threadIdx.x < 16) {
    const int sx = sample(threadIdx.x >> 2, g.nx), sy = sample(threadIdx.x & 3, g.ny);
    masks[threadIdx.x >> 2][threadIdx.x & 3] =
        sx >= 0 && sy >= 0 ? term_mask<kForward>(steps, k, g, sx, sy, iz) : 0u;
  }
  __syncthreads();
  const int plane = g.nx * g.ny;
  const Plane<T> xs{x, ghost, plane * iz, plane,
                    gy >= 0 ? g.nx * (gy + g.ny * iz) : -(1 << 30), g.nx};
  const int per_step = kN / tpl;
  const int d0 = max(k - kWindow, 0);  // the window's first diagonal
  // where nx, ny >= 3 the diagonals before the last kPlaneWindow join
  // planes only to the planes beside them: read whole through the
  // read-only path
  const int far = g.nx >= 3 && g.ny >= 3 ? k - kPlaneWindow : 0;
  const int lag = (per_step + 2) & ~1;  // even, more than per_step
  const int slot = (int)threadIdx.x / tpl, m = (int)threadIdx.x % tpl;
  T* own = line_x + (kLong ? 0 : slot * 2 * tpl);
  // the parity of the lines, and of the points in a line, that go first
  const int first = kForward ? 0 : 1;
  const int xa = 2 * m + first, xb = 2 * m + 1 - first;
  unsigned ma[4], mb[4];  // the two points' masks by place of the line
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ma[q] = xa < g.nx ? masks[place(xa, g.nx)][q] : 0u;
    mb[q] = xb < g.nx ? masks[place(xb, g.nx)][q] : 0u;
  }
  // the thread's line at step s (-1: none)
  auto line_at = [&](int s) {
    const int c = y0 + s * per_step + slot;
    const int iy = (c & 1) == first ? c : c - lag;
    return iy < y0 || iy > last ? -1 : iy;
  };
  auto pick = [](const unsigned (&mk)[4], int q) {
    return q == 0 ? mk[0] : q == 1 ? mk[1] : q == 2 ? mk[2] : mk[3];
  };
  // a point's mask on line iy (0 where the line or the point is absent)
  auto pick_line = [&](const unsigned (&mk)[4], int iy, int ix) {
    return iy >= 0 && ix < g.nx ? pick(mk, place(iy, g.ny)) : 0u;
  };
  auto stage_step = [&](int s) {
    const int iy = line_at(s);
    const int row0 = g.nx * (iy + g.ny * iz);
    const bool has_a = iy >= 0 && xa < g.nx, has_b = iy >= 0 && xb < g.nx;
    const int q = iy >= 0 ? place(iy, g.ny) : 0;
    stage<T, kWindow, kN>(col + (s & 1) * 2 * kS * kN, data, steps, k, d0, row0 + xa,
                      row0 + xb, has_a, has_b, has_a ? pick(ma, q) >> 2 * d0 : 0u,
                      has_b ? pick(mb, q) >> 2 * d0 : 0u);
  };
  // r, w and (backward) x of the thread's points at step s
  auto inputs = [&](int s, Row<T>& a, Row<T>& b) {
    const int iy = line_at(s);
    const int row0 = g.nx * (iy + g.ny * iz);
    a = iy >= 0 && xa < g.nx ? row_inputs<T, kForward>(r, x, w_in, row0 + xa) : Row<T>{};
    b = iy >= 0 && xb < g.nx ? row_inputs<T, kForward>(r, x, w_in, row0 + xb) : Row<T>{};
  };
  // the split shape: the sums over the far terms of the thread's points at
  // step s, from values and x asked for a step before
  const unsigned far_bits = kFar ? (1u << 2 * d0) - 1u : 0u;
  T fva[kFarSlots], fxa[kFarSlots], fvb[kFarSlots], fxb[kFarSlots];
  unsigned fra = 0u, frb = 0u;
  auto far_ask = [&](int s) {
    const int iy = line_at(s);
    const int row0 = g.nx * (iy + g.ny * iz);
    fra = pick_line(ma, iy, xa) & far_bits;
    frb = pick_line(mb, iy, xb) & far_bits;
    far_reads(data, x, steps, k, d0, row0 + xa, fra, fva, fxa);
    far_reads(data, x, steps, k, d0, row0 + xb, frb, fvb, fxb);
  };
  T far_a = T(0), far_b = T(0);
  if (kFar) {
    far_ask(0);
    far_a = far_sum(fva, fxa, fra);
    far_b = far_sum(fvb, fxb, frb);
  }
  const int nsteps = (last - y0 + lag) / per_step + 1;
  Row<T> next_a, next_b;
  inputs(0, next_a, next_b);
  stage_step(0);
  for (int s = 0; s < nsteps; ++s) {
    const Row<T> in_a = next_a, in_b = next_b;
    inputs(s + 1, next_a, next_b);  // asked for a step ahead, as the values
    stage_step(s + 1);  // an empty group after the last step
    if (kFar) far_ask(s + 1);
    const int iy = line_at(s);
    const bool live = iy >= 0, to_ghost = live && iy == gy;
    const int row0 = g.nx * (iy + g.ny * iz);
    const bool has_a = live && xa < g.nx, has_b = live && xb < g.nx;
    const int ia = row0 + xa, ib = row0 + xb;
    const int py = live ? place(iy, g.ny) : 0;
    // the terms read, by bits relative to the window
    const unsigned ra = has_a ? pick(ma, py) >> 2 * d0 : 0u;
    const unsigned rb = has_b ? pick(mb, py) >> 2 * d0 : 0u;
    const T* va = col + (s & 1) * 2 * kS * kN;
    const T* vb = va + kS * kN;
    // stage 1: every x the two points read but the second point's own
    // line's ("late": the first stage writes them), and the first point
    T xva[2 * kWindow], xvb[2 * kWindow];
    unsigned late = 0u;
#pragma unroll
    for (int e = 0; e < kWindow; ++e) {
      const int d = d0 + e;
      if (d >= k) break;
      const int u = steps[d].u;
      if (d < far) {  // another plane's rows, whole
        if (ra >> (2 * e) & 1u) xva[2 * e] = __ldg(x + ia - u);
        if (ra >> (2 * e + 1) & 1u) xva[2 * e + 1] = __ldg(x + ia + u);
        if (rb >> (2 * e) & 1u) xvb[2 * e] = __ldg(x + ib - u);
        if (rb >> (2 * e + 1) & 1u) xvb[2 * e + 1] = __ldg(x + ib + u);
        continue;
      }
      if (ra >> (2 * e) & 1u) xva[2 * e] = xs.at(ia - u);
      if (ra >> (2 * e + 1) & 1u) xva[2 * e + 1] = xs.at(ia + u);
      if (rb >> (2 * e) & 1u) {
        if ((unsigned)(ib - u - row0) < (unsigned)g.nx)
          late |= 1u << (2 * e);
        else
          xvb[2 * e] = xs.at(ib - u);
      }
      if (rb >> (2 * e + 1) & 1u) {
        if ((unsigned)(ib + u - row0) < (unsigned)g.nx)
          late |= 1u << (2 * e + 1);
        else
          xvb[2 * e + 1] = xs.at(ib + u);
      }
    }
    __pipeline_wait_prior(1);  // this step's values
    if (has_a) {
      const T v = finish<T, kForward>(in_a, w_in != nullptr, x, w_out, ghost,
                                      to_ghost, ia, xa,
                                      sum_staged<T, kWindow, kN>(far_a, va, xva, ra),
                                      va[(kS - 1) * kN]);
      if (!kLong) own[xa] = v;
    }
    if (kLong && live)
      for (int jx = xa + 2 * tpl; jx < g.nx; jx += 2 * tpl) {
        T dj = T(1);
        const Row<T> in = row_inputs<T, kForward>(r, x, w_in, row0 + jx);
        const T ej = point_sum(data, xs, steps, k, row0 + jx,
                               masks[place(jx, g.nx)][py], dj);
        finish<T, kForward>(in, w_in != nullptr, x, w_out, ghost, false, row0 + jx,
                            jx, ej, dj);
      }
    line_sync(slot, tpl, kN);
    // stage 2: the second point, its line's x from the line buffer
    if (has_b) {
#pragma unroll
      for (int e = 0; e < kWindow; ++e) {
        const int d = d0 + e;
        if (d >= k) break;
        const int u = steps[d].u;
        if (late >> (2 * e) & 1u)
          xvb[2 * e] = kLong ? xs.at(ib - u) : own[ib - u - row0];
        if (late >> (2 * e + 1) & 1u)
          xvb[2 * e + 1] = kLong ? xs.at(ib + u) : own[ib + u - row0];
      }
      finish<T, kForward>(in_b, w_in != nullptr, x, w_out, ghost, to_ghost, ib,
                          xb, sum_staged<T, kWindow, kN>(far_b, vb, xvb, rb),
                          vb[(kS - 1) * kN]);
    }
    if (kLong && live)
      for (int jx = xb + 2 * tpl; jx < g.nx; jx += 2 * tpl) {
        T dj = T(1);
        const Row<T> in = row_inputs<T, kForward>(r, x, w_in, row0 + jx);
        const T ej = point_sum(data, xs, steps, k, row0 + jx,
                               masks[place(jx, g.nx)][py], dj);
        finish<T, kForward>(in, w_in != nullptr, x, w_out, ghost, false, row0 + jx,
                            jx, ej, dj);
      }
    if (kFar) {
      far_a = far_sum(fva, fxa, fra);
      far_b = far_sum(fvb, fxb, frb);
    }
    __syncthreads();
  }
}

// rc[c] = r[f] - (A x)[f] at each coarse point, f = (2i, 2j, 2k) of the
// fine grid; rc in the coarse grid's numbering (nx, ny, nz even). Every
// read of a point is asked for before its sum begins.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mg_restrict(const T* __restrict__ data, const T* __restrict__ r,
                const T* __restrict__ x, T* __restrict__ rc,
                const Step* __restrict__ table, int k, Grid g) {
  __shared__ Step steps[kMaxDiags];
  load_steps(steps, table, k);
  const int cx = g.nx / 2, cy = g.ny / 2, cz = g.nz / 2;
  const int ci = blockIdx.x * kThreads + threadIdx.x;
  if (ci >= cx * cy * cz) return;
  const int ix = 2 * (ci % cx), iy = 2 * (ci / cx % cy), iz = 2 * (ci / (cx * cy));
  const int i = ix + g.nx * (iy + g.ny * iz);
  T v[kTerms], xv[kTerms];
  unsigned reads = 0u;
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {
    if (d >= k) break;
    const Step st = steps[d];
    Nb nb;
    if (st.u == 0) {  // the diagonal's term, in its place
      v[2 * d] = value(data, k, i, d);
      xv[2 * d] = x[i];
      reads |= 1u << (2 * d);
      continue;
    }
    if (below(st, g, ix, iy, iz, nb)) {
      v[2 * d] = value(data, k, i, d);
      xv[2 * d] = x[i - st.u];
      reads |= 1u << (2 * d);
    }
    if (above(st, g, ix, iy, iz, nb)) {
      v[2 * d + 1] = value(data, k, i + st.u, d);
      xv[2 * d + 1] = x[i + st.u];
      reads |= 1u << (2 * d + 1);
    }
  }
  T s = T(0);
#pragma unroll
  for (int t = 0; t < kTerms; ++t)
    if (reads >> t & 1u) s = add(s, mul(v[t], xv[t]));
  rc[ci] = r[i] - s;
}

// whether a launch runs correctly with ``band`` lines a block: a whole
// plane, or a cut of a forward sweep of short lines into bands of an even
// number of lines, at least 4 (a backward sweep's ghost line would read x
// its owner may have overwritten; a long line has no ghost line)
bool band_ok(const Grid& g, int band, bool forward) {
  return band == g.ny || (forward && g.nx <= 2 * kSweepThreads && band >= 4 &&
                          band % 2 == 0 && band < g.ny);
}

// one launch: planes of parity pz, ``band`` lines a block
template <typename T, bool kForward, bool kLong, int kWindow, bool kFar>
cudaError_t launch_planes(const T* data, const T* r, T* x, const T* w_in,
                          T* w_out, const Step* table, int k, Grid g, int pz,
                          int band, unsigned blocks, cudaStream_t stream) {
  constexpr int kN = threads_of(kWindow, kFar);
  int tpl = 1;
  while (tpl < (g.nx + 1) / 2 && tpl < kN) tpl <<= 1;
  const auto kernel = symgs_dia_lines_planes<T, kForward, kLong, kWindow, kFar>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)staged_bytes<T, kWindow, kN>());
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kN, staged_bytes<T, kWindow, kN>(), stream>>>(
      data, r, x, w_in, w_out, table, k, g, pz, tpl, band);
  return cudaGetLastError();
}

// bands: the lines a block of each launch, in launch order
template <typename T, bool kForward>
cudaError_t sweep(const T* data, const T* r, T* x, const T* w_in, T* w_out,
                  const Step* table, int k, Grid g, const int* bands,
                  cudaStream_t stream) {
  // where nx, ny >= 3 the couplings inside a plane are the last
  // kPlaneWindow stored diagonals, and the rest join planes
  const bool split = g.nx >= 3 && g.ny >= 3;
  for (int step = 0; step < 2; ++step) {
    const int pz = kForward ? step : 1 - step;
    const int planes = (g.nz - pz + 1) / 2;
    if (planes == 0) continue;
    const int band = bands[step];
    const unsigned blocks = (unsigned)(planes * ((g.ny + band - 1) / band));
    const bool long_lines = g.nx > 2 * kSweepThreads;
    // the first launch reads no other plane; the second adds the far terms
    const cudaError_t err =
        split && step == 0 && g.nx <= 2 * threads_of(kPlaneWindow)
            ? launch_planes<T, kForward, false, kPlaneWindow, false>(
                  data, r, x, w_in, w_out, table, k, g, pz, band, blocks, stream)
        : split && step == 1 && !long_lines
            ? launch_planes<T, kForward, false, kPlaneWindow, true>(
                  data, r, x, w_in, w_out, table, k, g, pz, band, blocks, stream)
        : long_lines
            ? launch_planes<T, kForward, true, kMaxDiags, false>(
                  data, r, x, w_in, w_out, table, k, g, pz, band, blocks, stream)
            : launch_planes<T, kForward, false, kMaxDiags, false>(
                  data, r, x, w_in, w_out, table, k, g, pz, band, blocks, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int symgs_entry(const void* data, const void* r, void* x, const void* w_in,
                void* w_out, const void* table, int k, int nx, int ny, int nz,
                int forward, int band0, int band1, void* stream) {
  const Grid g{nx, ny, nz};
  const int bands[2] = {band0, band1};
  if (k < 1 || k > kMaxDiags || !band_ok(g, band0, forward) ||
      !band_ok(g, band1, forward))
    return (int)cudaErrorInvalidValue;
  const T* d = static_cast<const T*>(data);
  const T* rv = static_cast<const T*>(r);
  T* xv = static_cast<T*>(x);
  const T* wi = static_cast<const T*>(w_in);
  T* wo = static_cast<T*>(w_out);
  const Step* t = static_cast<const Step*>(table);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(forward ? sweep<T, true>(d, rv, xv, wi, wo, t, k, g, bands, s)
                       : sweep<T, false>(d, rv, xv, wi, wo, t, k, g, bands, s));
}

template <typename T>
int restrict_entry(const void* data, const void* r, const void* x, void* rc,
                   const void* table, int k, int nx, int ny, int nz,
                   void* stream) {
  if (k < 1 || k > kMaxDiags) return (int)cudaErrorInvalidValue;
  const long long nc = (long long)(nx / 2) * (ny / 2) * (nz / 2);
  if (nc == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((nc + kThreads - 1) / kThreads);
  mg_restrict<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(r),
      static_cast<const T*>(x), static_cast<T*>(rc),
      static_cast<const Step*>(table), k, Grid{nx, ny, nz});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
int symgs_dia_f32(const void* data, const void* r, void* x, const void* w_in,
                  void* w_out, const void* table, int k, int nx, int ny, int nz,
                  int forward, int band0, int band1, void* stream) {
  return symgs_entry<float>(data, r, x, w_in, w_out, table, k, nx, ny, nz,
                            forward, band0, band1, stream);
}
int symgs_dia_f64(const void* data, const void* r, void* x, const void* w_in,
                  void* w_out, const void* table, int k, int nx, int ny, int nz,
                  int forward, int band0, int band1, void* stream) {
  return symgs_entry<double>(data, r, x, w_in, w_out, table, k, nx, ny, nz,
                             forward, band0, band1, stream);
}
int mg_restrict_f32(const void* data, const void* r, const void* x, void* rc,
                    const void* table, int k, int nx, int ny, int nz,
                    void* stream) {
  return restrict_entry<float>(data, r, x, rc, table, k, nx, ny, nz, stream);
}
int mg_restrict_f64(const void* data, const void* r, const void* x, void* rc,
                    const void* table, int k, int nx, int ny, int nz,
                    void* stream) {
  return restrict_entry<double>(data, r, x, rc, table, k, nx, ny, nz, stream);
}
}  // extern "C"
