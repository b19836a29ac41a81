// DIA SpMV kernels for Hopper (sm_90a), vanilla and symmetric storage.
//
// Replaces the Pallas TPU kernels of spmv_tpu/ops/spmv_dia_pallas.py:
//   dia_spmv      <- _dia_kernel      (:191, wrapper _spmv_dia_pallas_2d :602)
//   dia_sym_spmv  <- _dia_sym_kernel  (:265, wrapper _spmv_dia_sym_pallas_2d :498)
//
// Layout (spmv_torch/formats/dia.py): D shards stacked, each shard's data
// is (npad/128, K*128) with data[s, r, k*128 + l] = A_s[128r+l, 128r+l+off_k];
// x and y are (D, npad). x~[s, j] = x[s, j] for 0 <= j < npad and 0 otherwise:
// a shard never reads its neighbour's entries (the remote ELL term of the
// distributed operator already adds those).
//
// Bound: bytes. One apply moves (K+2)*npad*itemsize per shard (K_sym
// stored diagonals in symmetric storage); arithmetic is 2 flops per stored
// element (4 for a symmetric off-diagonal).
//
// dia_spmv has two kernels, and the wrapper's route (ops/spmv_dia_cuda.py
// `route`, made once per offsets and dtype) picks one:
//   - dia_spmv_rows, for K = 5 (the 2-D Laplacian) and K = 9 (the AMG 2-D
//     levels): K is a template parameter and the offsets come by value in
//     the kernel's parameters, so a thread issues all its data and x loads
//     before its first sum, with no offset read from memory in between.
//     CTAs of 128 threads; a thread takes one row, or 16 bytes of rows (4
//     fp32, 8 bf16) where at most two offsets are not multiples of that
//     count: then each diagonal's rows are one 16-byte load, and so are
//     x's at every other offset.
//   - dia_spmv_kernel, the first design, for every other K (the 1-D interval
//     levels' K = 65 and 297): one thread a row, a runtime loop over K
//     that reads each offset from a K-long int64 array on the card, so K
//     has no cap.
// On the card (PERF.md) dia_spmv_kernel at K = 5 and 9 kept too few
// loads in flight: each iteration waits on its offset before its x load.
// dia_spmv_rows took the 3200^2 Laplacian from 1.19x its bound to 1.09x in
// fp32 and from 1.86x to 1.16x in bf16, and the AMG levels' 640k and 41k
// rows by 30%; the tile kernel of dia_window.cuh at one column lost to it
// at every shape, and to dia_spmv_kernel at K = 65 and 297. Where more
// offsets are unaligned (six of the AMG levels' nine), 16 bytes of rows a
// thread cost 14-18% against one, each unaligned x read becoming 4-8
// scalar loads. The threads of a warp take neighbouring rows: each
// diagonal is one coalesced pass over `data`; the shifted x reads touch
// lines that neighbouring warps read too, and are served from L1/L2. Accumulation is in fp32 for fp32 and bf16
// storage (bf16 y is rounded once, at the store) and in fp64 for fp64, in
// the same order in both kernels (acc += d * x, k ascending), so they give
// the same bits; index math is 64-bit.
//
// dia_sym_spmv is the tile kernel of dia_window.cuh (and, on offsets that
// span planes, the stream kernel of dia_stream.cu): a CTA stages its x
// windows and its rows of each diagonal (the transpose term's rows too) in
// shared memory with bulk copies of the Tensor Memory Accelerator, as a
// plan made once per operator lays them out, and sums from there. Run on
// the card, the one-thread-a-row symmetric kernel it replaces kept too few
// bytes in flight (a runtime loop of 2- to 8-byte loads, two gathers a
// stored diagonal): 1.7x its bound in fp32, 3.1x in bf16 (PERF.md). It
// stores offsets <= 0 only and computes the transpose term y[i] += d_o[i-o] *
// x~[i-o] as a gather: no atomics, no carry, no delayed write (the TPU's
// one-tile carry exists only because its grid runs in order).
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmv_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dia_window.cuh"

// dia_spmv's first design: one row a thread, a runtime loop over K that
// reads each offset from the card
template <typename T>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long npad, int ndiags,
                                const long long* __restrict__ offs) {
  typedef typename dia_window::Acc<T>::type Acc;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const long long row_stride = (long long)ndiags * 128;
  const T* xs = x + shard * npad;
  const T* drow = data + shard * npad * ndiags + (i >> 7) * row_stride + (i & 127);
  Acc acc = Acc(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long j = i + __ldg(offs + k);
    const Acc xv = (j >= 0 && j < npad) ? dia_window::load(xs[j]) : Acc(0);
    acc += dia_window::load(drow[(long long)k * 128]) * xv;
  }
  y[shard * npad + i] = dia_window::store<T>(acc);
}

// dia_spmv_rows: K fixed at compile time, the offsets passed by value (the
// kernel's parameter space: no load from memory before the data and x
// loads), V neighbouring rows a thread. With V * sizeof(T) = 16 each
// diagonal's V rows are one 16-byte load, and so are x's where the offset
// is a multiple of V; every load of a thread is issued before its first sum.
template <int K>
struct Offsets {
  long long o[K];
};

template <typename T, int V>
__device__ __forceinline__ void load_rows(const T* p, T (&out)[V]) {
  if constexpr (sizeof(T) * V == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = e[v];
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = p[v];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_rows(T* p, const T (&in)[V]) {
  if constexpr (sizeof(T) * V == 16) {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = in[v];
    *reinterpret_cast<uint4*>(p) = r;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = in[v];
  }
}

template <typename T, int K, int V>
__global__ void dia_spmv_rows(const T* __restrict__ data, const T* __restrict__ x,
                              T* __restrict__ y, long long npad, Offsets<K> offs) {
  typedef typename dia_window::Acc<T>::type A;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= npad) return;  // V divides 128, and so npad: rows i .. i+V-1 exist
  const long long shard = blockIdx.y;
  const T* xs = x + shard * npad;
  const T* drow = data + shard * npad * K + (i >> 7) * (K * 128LL) + (i & 127);
  T d[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) load_rows<T, V>(drow + k * 128, d[k]);
  A xv[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = i + offs.o[k];
    if (V > 1 && (offs.o[k] & (V - 1)) == 0) {
      // j is a multiple of V: its V rows lie wholly inside or outside [0, npad)
      if (j >= 0 && j < npad) {
        T raw[V];
        load_rows<T, V>(xs + j, raw);
#pragma unroll
        for (int v = 0; v < V; ++v) xv[k][v] = dia_window::load(raw[v]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xv[k][v] = A(0);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const long long jv = j + v;
        xv[k][v] = (jv >= 0 && jv < npad) ? dia_window::load(xs[jv]) : A(0);
      }
    }
  }
  // the sums of dia_spmv_kernel, row by row: acc += d * x over k ascending
  T out[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    A acc = A(0);
#pragma unroll
    for (int k = 0; k < K; ++k) acc += dia_window::load(d[k][v]) * xv[k][v];
    out[v] = dia_window::store<T>(acc);
  }
  store_rows<T, V>(y + shard * npad + i, out);
}

template <typename T>
static int launch(const void* data, const void* x, void* y, long long npad,
                  int ndiags, const long long* offsets, int nshards,
                  void* stream) {
  if (ndiags < 1 || npad < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = 256;
  const dim3 grid((unsigned)((npad + threads - 1) / threads), (unsigned)nshards);
  dia_spmv_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y),
      npad, ndiags, offsets);
  return (int)cudaGetLastError();
}

// dia_spmv_rows' CTA: within 1.5% of 256 threads at every shape measured,
// and faster on the 41k-row AMG level in bf16 (PERF.md)
constexpr int kRowsThreads = 128;

template <typename T, int K, int V>
static int launch_rows_kv(const void* data, const void* x, void* y, long long npad,
                          const long long* host_offsets, int nshards, cudaStream_t s) {
  Offsets<K> offs;
  for (int k = 0; k < K; ++k) offs.o[k] = host_offsets[k];
  const long long n = npad / V;
  const dim3 grid((unsigned)((n + kRowsThreads - 1) / kRowsThreads), (unsigned)nshards);
  dia_spmv_rows<T, K, V><<<grid, kRowsThreads, 0, s>>>(
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), npad,
      offs);
  return (int)cudaGetLastError();
}

template <typename T, int K>
static int launch_rows_k(const void* data, const void* x, void* y, long long npad,
                         const long long* host_offsets, int rows_per_thread, int nshards,
                         cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (rows_per_thread == 1) {
    return launch_rows_kv<T, K, 1>(data, x, y, npad, host_offsets, nshards, s);
  }
  if (rows_per_thread == kVec) {
    return launch_rows_kv<T, K, kVec>(data, x, y, npad, host_offsets, nshards, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dia_spmv_rows is built for K = 5 (the 2-D Laplacian) and K = 9 (the AMG
// 2-D levels, the +-301 band), one row a thread or 16 bytes of rows
template <typename T>
static int launch_rows(const void* data, const void* x, void* y, long long npad,
                       int ndiags, const long long* host_offsets, int rows_per_thread,
                       int nshards, void* stream) {
  if (npad < 1 || npad % 128 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ndiags) {
    case 5: return launch_rows_k<T, 5>(data, x, y, npad, host_offsets, rows_per_thread, nshards, s);
    case 9: return launch_rows_k<T, 9>(data, x, y, npad, host_offsets, rows_per_thread, nshards, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#define DIA_SPMV_ENTRY(NAME, T)                                             \
  int NAME(const void* data, const void* x, void* y, long long npad,        \
           int ndiags, const long long* offsets, int nshards, void* stream) { \
    return launch<T>(data, x, y, npad, ndiags, offsets, nshards, stream);   \
  }

#define DIA_SPMV_ROWS_ENTRY(NAME, T)                                              \
  int NAME(const void* data, const void* x, void* y, long long npad, int ndiags,  \
           const long long* host_offsets, int rows_per_thread, int nshards,       \
           void* stream) {                                                        \
    return launch_rows<T>(data, x, y, npad, ndiags, host_offsets, rows_per_thread, \
                          nshards, stream);                                       \
  }

template <typename T>
static int launch_sym(const void* data, const void* x, void* y, long long npad,
                      int ndiags, const int* plan, int rows, int smem_bytes,
                      int nshards, void* stream) {
  if (ndiags < 1 || npad < 1 || nshards < 1 || nshards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return dia_window::launch<T, 1, true>(data, x, y, npad, 1, nshards, plan, rows,
                                        smem_bytes, static_cast<cudaStream_t>(stream));
}

#define DIA_SYM_SPMV_ENTRY(NAME, T)                                            \
  int NAME(const void* data, const void* x, void* y, long long npad,           \
           int ndiags, const int* plan, int rows, int smem_bytes, int nshards, \
           void* stream) {                                                     \
    return launch_sym<T>(data, x, y, npad, ndiags, plan, rows, smem_bytes,    \
                         nshards, stream);                                     \
  }

// dia_spmv's `offsets`: a device pointer to ndiags int64 offsets;
// dia_spmv_rows' `host_offsets`: the same offsets in host memory (passed to
// the kernel by value); dia_sym_spmv's `plan`: the device int32 words of its
// window plan, with its tile rows and shared-memory bytes
extern "C" {
DIA_SPMV_ENTRY(dia_spmv_f32, float)
DIA_SPMV_ENTRY(dia_spmv_f64, double)
DIA_SPMV_ENTRY(dia_spmv_bf16, __nv_bfloat16)
DIA_SPMV_ROWS_ENTRY(dia_spmv_rows_f32, float)
DIA_SPMV_ROWS_ENTRY(dia_spmv_rows_f64, double)
DIA_SPMV_ROWS_ENTRY(dia_spmv_rows_bf16, __nv_bfloat16)
DIA_SYM_SPMV_ENTRY(dia_sym_spmv_f32, float)
DIA_SYM_SPMV_ENTRY(dia_sym_spmv_f64, double)
DIA_SYM_SPMV_ENTRY(dia_sym_spmv_bf16, __nv_bfloat16)
}  // extern "C"
