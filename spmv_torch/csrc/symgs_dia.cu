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
// Colours: (ix % 2) + 2 (iy % 2) + 4 (iz % 2). A grid line (fixed iy, iz)
// holds two colours, which differ in ix alone; lines of one (iy % 2,
// iz % 2) class are never neighbours. So one launch takes a class of lines
// and the colour pair on them, in two stages with a block barrier between
// (the second colour reads the first's new x on its own line); a sweep
// direction is 4 launches: classes (0,0) (1,0) (0,1) (1,1) forward, the
// reverse backward, colours 0 .. 7 and 7 .. 0. A line lies in one block; a
// thread takes two neighbouring points of it, one a stage, and reads both
// points' values in the first stage, so each sector of the matrix a launch
// reads is read once. A line longer than 2 kThreads points is taken in
// segments of 2 kThreads, one point pair a thread each; past the first
// segment each point reads its own values in its own stage.
//
// A sweep reads only the neighbours before each row in its order: from
// them (E) and w, the sum over the rows after it that the last backward
// sweep kept (0 from x = 0), it makes Gauss-Seidel's update, and a
// backward sweep keeps its E as the next forward sweep's w (symgs_dia.py
// derives it, and why a V-cycle may). So each coupling is read once a
// sweep. A neighbour's colour comes from its own grid coordinates (the
// offset split into grid steps with carries), so a diagonal may join
// different neighbours on different rows, as it does where nx or ny is 2.
//
// Bound: bytes. A sweep direction over n rows with L stored values must
// read the values once, x and r once and write x once: 8 (L + 3 n) bytes
// in float64 (0.68 ms for HPCG's 256^3 level at 3.35 TB/s, L = 14 n; one
// from zero reads no x: 8 (L + 2 n)). Here a launch reads x about once (4
// n a sweep) and w once. What bounds it then is latency: a thread's terms
// are sums of dependent loads, so the first stage's values for the second
// point go to shared memory as asynchronous copies that the thread does
// not wait for until the barrier, and 7 blocks an SM keep the rest in
// flight. Sums take one rounding a product and one a sum (no fma), in the
// plain version's order, so the two give the same bits.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/symgs_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // a block
constexpr int kLanes = 128;    // rows of a DIA tile row (formats/dia.py)
constexpr int kMaxDiags = 14;  // the 27-point neighbourhood's lower half

// one stored diagonal: u = -offset, split into grid steps
// u = ux + nx * (uy + ny * uz), 0 <= ux < nx, 0 <= uy < ny
struct Step {
  int u, ux, uy, uz;
};

struct Grid {
  int nx, ny, nz;
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
                                      int iy, int iz, int& colour) {
  int jx = ix - s.ux;
  int b = jx < 0;
  jx += b * g.nx;
  int jy = iy - s.uy - b;
  b = jy < 0;
  jy += b * g.ny;
  const int jz = iz - s.uz - b;
  colour = colour_of(jx, jy, jz);
  return jz >= 0;
}

// the point u rows above (ix, iy, iz)
__device__ __forceinline__ bool above(const Step& s, const Grid& g, int ix,
                                      int iy, int iz, int& colour) {
  int jx = ix + s.ux;
  int c = jx >= g.nx;
  jx -= c * g.nx;
  int jy = iy + s.uy + c;
  c = jy >= g.ny;
  jy -= c * g.ny;
  const int jz = iz + s.uz + c;
  colour = colour_of(jx, jy, jz);
  return jz < g.nz;
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

// the row's new x from E (``e``, the sum over the rows before it) and w
// (``w_in``, 0 where null), as symgs_dia.py writes the update; a backward
// sweep keeps E in ``w_out`` where given
template <typename T, bool kForward>
__device__ __forceinline__ void finish(const T* __restrict__ r, T* x,
                                       const T* w_in, T* w_out, int i, T e,
                                       T diag) {
  if (kForward) {
    x[i] = (r[i] - (w_in != nullptr ? add(e, w_in[i]) : e)) / diag;
  } else {
    x[i] = x[i] + ((w_in != nullptr ? w_in[i] : T(0)) - e) / diag;
    if (w_out != nullptr) w_out[i] = e;
  }
}

// E of the point ix of the line (iy, iz), row i and colour c, and its
// diagonal in ``diag``: every value read in place, the terms in the order
// the first stage adds them
template <typename T, bool kForward>
__device__ __forceinline__ T point_sum(const T* __restrict__ data, const T* x,
                                       const Step* steps, int k, const Grid& g,
                                       int ix, int iy, int iz, int i, int c,
                                       T& diag) {
  T e = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {
    if (d >= k) break;
    const Step st = steps[d];
    if (st.u == 0) {
      diag = value(data, k, i, d);
      continue;
    }
    int cj;
    if (below(st, g, ix, iy, iz, cj) && before<kForward>(cj, c))
      e = add(e, mul(value(data, k, i, d), x[i - st.u]));
    if (above(st, g, ix, iy, iz, cj) && before<kForward>(cj, c))
      e = add(e, mul(value(data, k, i + st.u, d), x[i + st.u]));
  }
  return e;
}

// one class of lines (iy % 2 == py, iz % 2 == pz) and its two colours;
// tpl threads a line (a power of two, at most kThreads), kThreads / tpl
// lines a block. A thread takes the points 2m and 2m + 1 of its line, one
// a stage, and m + tpl s of each further segment s. The first stage reads
// the values of the first segment's both points (neighbouring rows: the
// same sectors), the second point's as copies straight into shared memory
// that it does not wait for; a bit a term says which were read. x is read
// with plain loads, the second points' after the barrier that makes the
// first stage's stores visible to the block. kLong: lines of more than one
// segment (the kernel of the lines of one segment keeps none of their
// code, so neither their registers).
template <typename T, bool kForward, bool kLong>
__global__ void __launch_bounds__(kThreads)
    symgs_dia_lines(const T* __restrict__ data, const T* __restrict__ r, T* x,
                    const T* w_in, T* w_out, const Step* __restrict__ table,
                    int k, Grid g, int py, int pz, int tpl) {
  __shared__ Step steps[kMaxDiags];
  __shared__ T later[kTerms][kThreads];  // the second point's values
  load_steps(steps, table, k);
  const int nly = (g.ny - py + 1) / 2, nlz = (g.nz - pz + 1) / 2;
  const int line = blockIdx.x * (kThreads / tpl) + threadIdx.x / tpl;
  const bool live = line < nly * nlz;
  const int iy = py + 2 * (line % nly), iz = pz + 2 * (line / nly);
  const int first = kForward ? 0 : 1;  // the first stage's ix parity
  const int lane = (int)threadIdx.x % tpl;
  const int ix[2] = {2 * lane + first, 2 * lane + 1 - first};
  const bool has[2] = {live && ix[0] < g.nx, live && ix[1] < g.nx};
  const int c[2] = {colour_of(first, py, pz), colour_of(1 - first, py, pz)};
  const int i0 = ix[0] + g.nx * (iy + g.ny * iz);
  const int i[2] = {i0, i0 + ix[1] - ix[0]};
  T diag[2] = {T(1), T(1)};
  unsigned reads = 0u;  // the second point's terms that it reads
  T e = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {
    if (d >= k) break;
    const Step st = steps[d];
    if (st.u == 0) {
      if (has[0]) diag[0] = value(data, k, i[0], d);
      if (has[1]) diag[1] = value(data, k, i[1], d);
      continue;
    }
    int cj;
    if (has[1] && below(st, g, ix[1], iy, iz, cj) && before<kForward>(cj, c[1])) {
      __pipeline_memcpy_async(&later[2 * d][threadIdx.x], at(data, k, i[1], d),
                              sizeof(T));
      reads |= 1u << (2 * d);
    }
    if (has[1] && above(st, g, ix[1], iy, iz, cj) && before<kForward>(cj, c[1])) {
      __pipeline_memcpy_async(&later[2 * d + 1][threadIdx.x],
                              at(data, k, i[1] + st.u, d), sizeof(T));
      reads |= 1u << (2 * d + 1);
    }
    if (has[0] && below(st, g, ix[0], iy, iz, cj) && before<kForward>(cj, c[0]))
      e = add(e, mul(value(data, k, i[0], d), x[i[0] - st.u]));
    if (has[0] && above(st, g, ix[0], iy, iz, cj) && before<kForward>(cj, c[0]))
      e = add(e, mul(value(data, k, i[0] + st.u, d), x[i[0] + st.u]));
  }
  if (has[0]) finish<T, kForward>(r, x, w_in, w_out, i[0], e, diag[0]);
  const int segments = kLong ? (g.nx + 2 * tpl - 1) / (2 * tpl) : 1;
  for (int s = 1; s < segments; ++s) {
    const int jx = ix[0] + 2 * tpl * s;
    if (!live || jx >= g.nx) break;
    T dj = T(1);
    const T ej = point_sum<T, kForward>(data, x, steps, k, g, jx, iy, iz,
                                        i[0] + 2 * tpl * s, c[0], dj);
    finish<T, kForward>(r, x, w_in, w_out, i[0] + 2 * tpl * s, ej, dj);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (!has[1]) return;
  e = T(0);
#pragma unroll
  for (int t = 0; t < kTerms; ++t)
    if (reads >> t & 1u) {
      const int j = (t & 1) ? i[1] + steps[t / 2].u : i[1] - steps[t / 2].u;
      e = add(e, mul(later[t][threadIdx.x], x[j]));
    }
  finish<T, kForward>(r, x, w_in, w_out, i[1], e, diag[1]);
  for (int s = 1; s < segments; ++s) {
    const int jx = ix[1] + 2 * tpl * s;
    if (jx >= g.nx) break;
    T dj = T(1);
    const T ej = point_sum<T, kForward>(data, x, steps, k, g, jx, iy, iz,
                                        i[1] + 2 * tpl * s, c[1], dj);
    finish<T, kForward>(r, x, w_in, w_out, i[1] + 2 * tpl * s, ej, dj);
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
    int cj;
    if (st.u == 0) {  // the diagonal's term, in its place
      v[2 * d] = value(data, k, i, d);
      xv[2 * d] = x[i];
      reads |= 1u << (2 * d);
      continue;
    }
    if (below(st, g, ix, iy, iz, cj)) {
      v[2 * d] = value(data, k, i, d);
      xv[2 * d] = x[i - st.u];
      reads |= 1u << (2 * d);
    }
    if (above(st, g, ix, iy, iz, cj)) {
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

template <typename T, bool kForward>
cudaError_t sweep(const T* data, const T* r, T* x, const T* w_in, T* w_out,
                  const Step* table, int k, Grid g, cudaStream_t stream) {
  int tpl = 1;
  while (tpl < (g.nx + 1) / 2 && tpl < kThreads) tpl <<= 1;
  const int lines_a_block = kThreads / tpl;
  for (int step = 0; step < 4; ++step) {
    const int cls = kForward ? step : 3 - step;
    const int py = cls & 1, pz = cls >> 1;
    const long long lines =
        (long long)((g.ny - py + 1) / 2) * ((g.nz - pz + 1) / 2);
    if (lines == 0) continue;
    const unsigned blocks = (unsigned)((lines + lines_a_block - 1) / lines_a_block);
    if (g.nx > 2 * kThreads)
      symgs_dia_lines<T, kForward, true><<<blocks, kThreads, 0, stream>>>(
          data, r, x, w_in, w_out, table, k, g, py, pz, tpl);
    else
      symgs_dia_lines<T, kForward, false><<<blocks, kThreads, 0, stream>>>(
          data, r, x, w_in, w_out, table, k, g, py, pz, tpl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
int symgs_entry(const void* data, const void* r, void* x, const void* w_in,
                void* w_out, const void* table, int k, int nx, int ny, int nz,
                int forward, void* stream) {
  if (k < 1 || k > kMaxDiags) return (int)cudaErrorInvalidValue;
  const T* d = static_cast<const T*>(data);
  const T* rv = static_cast<const T*>(r);
  T* xv = static_cast<T*>(x);
  const T* wi = static_cast<const T*>(w_in);
  T* wo = static_cast<T*>(w_out);
  const Step* t = static_cast<const Step*>(table);
  const Grid g{nx, ny, nz};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(forward ? sweep<T, true>(d, rv, xv, wi, wo, t, k, g, s)
                       : sweep<T, false>(d, rv, xv, wi, wo, t, k, g, s));
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
                  int forward, void* stream) {
  return symgs_entry<float>(data, r, x, w_in, w_out, table, k, nx, ny, nz,
                            forward, stream);
}
int symgs_dia_f64(const void* data, const void* r, void* x, const void* w_in,
                  void* w_out, const void* table, int k, int nx, int ny, int nz,
                  int forward, void* stream) {
  return symgs_entry<double>(data, r, x, w_in, w_out, table, k, nx, ny, nz,
                             forward, stream);
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
