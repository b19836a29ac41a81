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
// Design: one thread per output row, blockIdx.y = shard, blockIdx.z = a
// chunk of at most NR = 8 columns. The thread reads each stored diagonal
// element once per chunk and applies it to each of its columns, with NR
// accumulators in registers (NR is a template parameter, min(nrhs, 8)). A
// block of more than 8 columns re-reads the matrix once per chunk.
// Column c takes exactly the operations dia_spmv / dia_sym_spmv take on it,
// in the same order (acc += d * x, k ascending; the symmetric transpose term
// right after its forward term), so nvcc contracts them the same way and
// each column equals the single-RHS kernel's result bit for bit.
//
// Bound: bytes. One apply must move K*npad*itemsize of matrix (stored
// diagonals: K_sym for symmetric storage) plus X and Y once, 2*nrhs*npad*
// itemsize, per shard; with chunks the matrix moves ceil(nrhs/8) times.
// Arithmetic is 2 flops per stored element and column. bf16 storage
// accumulates in fp32 and rounds y once, at the store, as dia_spmv does.
// The offsets come from device memory (no cap on K), as in spmv_dia.cu.
// The shifted x reads
// (and the symmetric term's shifted data reads) touch lines that
// neighbouring warps read too and are served from L1/L2. Shared-memory x
// windows, TMA staging and register blocking over rows are later work.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/spmm_dia_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SPMM_MAX_NR 8

// storage type -> accumulation type, and the conversions between them
template <typename T> struct SpmmAcc { typedef T type; };
template <> struct SpmmAcc<__nv_bfloat16> { typedef float type; };
__device__ __forceinline__ float spmm_load(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float spmm_load(float v) { return v; }
__device__ __forceinline__ double spmm_load(double v) { return v; }
template <typename T> __device__ __forceinline__ T spmm_store(typename SpmmAcc<T>::type v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 spmm_store<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int NR>
__global__ void dia_spmm_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long npad, int ndiags, int nrhs,
                                const long long* __restrict__ offs) {
  typedef typename SpmmAcc<T>::type Acc;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long row_stride = (long long)ndiags * 128;
  const long long lanes = (long long)nrhs * 128;
  const T* xs = x + shard * npad * nrhs + c0 * 128;
  const T* drow = data + shard * npad * ndiags + (i >> 7) * row_stride + (i & 127);
  Acc acc[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = Acc(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long j = i + __ldg(offs + k);
    const bool in = j >= 0 && j < npad;
    const long long jo = in ? (j >> 7) * lanes + (j & 127) : 0;
    const Acc d = spmm_load(drow[(long long)k * 128]);
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < nc) {
        const Acc xv = in ? spmm_load(xs[jo + c * 128]) : Acc(0);
        acc[c] += d * xv;
      }
    }
  }
  T* ys = y + shard * npad * nrhs + (i >> 7) * lanes + c0 * 128 + (i & 127);
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < nc) ys[c * 128] = spmm_store<T>(acc[c]);
  }
}

template <typename T, int NR>
__global__ void dia_sym_spmm_kernel(const T* __restrict__ data,
                                    const T* __restrict__ x, T* __restrict__ y,
                                    long long npad, int ndiags, int nrhs,
                                    const long long* __restrict__ offs) {
  typedef typename SpmmAcc<T>::type Acc;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const long long shard = blockIdx.y;
  const int c0 = blockIdx.z * NR;
  const int nc = min(NR, nrhs - c0);
  const long long row_stride = (long long)ndiags * 128;
  const long long lanes = (long long)nrhs * 128;
  const T* xs = x + shard * npad * nrhs + c0 * 128;
  const T* ds = data + shard * npad * ndiags;
  const T* drow = ds + (i >> 7) * row_stride + (i & 127);
  Acc acc[NR];
#pragma unroll
  for (int c = 0; c < NR; ++c) acc[c] = Acc(0);
  for (int k = 0; k < ndiags; ++k) {
    const long long o = __ldg(offs + k);  // o <= 0
    const long long j = i + o;
    const bool in = j >= 0;
    const long long jo = in ? (j >> 7) * lanes + (j & 127) : 0;
    const Acc d = spmm_load(drow[(long long)k * 128]);
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      if (c < nc) {
        const Acc xv = in ? spmm_load(xs[jo + c * 128]) : Acc(0);
        acc[c] += d * xv;
      }
    }
    if (o < 0) {
      // transpose of the stored entry A[t, t+o] at t = i-o lands on row i
      const long long t = i - o;
      if (t < npad) {
        const Acc dt = spmm_load(ds[(t >> 7) * row_stride + (long long)k * 128 + (t & 127)]);
        const long long to = (t >> 7) * lanes + (t & 127);
#pragma unroll
        for (int c = 0; c < NR; ++c) {
          if (c < nc) acc[c] += dt * spmm_load(xs[to + c * 128]);
        }
      }
    }
  }
  T* ys = y + shard * npad * nrhs + (i >> 7) * lanes + c0 * 128 + (i & 127);
#pragma unroll
  for (int c = 0; c < NR; ++c) {
    if (c < nc) ys[c * 128] = spmm_store<T>(acc[c]);
  }
}

template <typename T, bool kSymmetric, int NR>
static void launch_nr(dim3 grid, int threads, cudaStream_t s, const void* data,
                      const void* x, void* y, long long npad, int ndiags,
                      int nrhs, const long long* offs) {
  if (kSymmetric) {
    dia_sym_spmm_kernel<T, NR><<<grid, threads, 0, s>>>(
        static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), npad, ndiags, nrhs, offs);
  } else {
    dia_spmm_kernel<T, NR><<<grid, threads, 0, s>>>(
        static_cast<const T*>(data), static_cast<const T*>(x),
        static_cast<T*>(y), npad, ndiags, nrhs, offs);
  }
}

template <typename T, bool kSymmetric>
static int launch(const void* data, const void* x, void* y, long long npad,
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
    case 1: launch_nr<T, kSymmetric, 1>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 2: launch_nr<T, kSymmetric, 2>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 3: launch_nr<T, kSymmetric, 3>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 4: launch_nr<T, kSymmetric, 4>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 5: launch_nr<T, kSymmetric, 5>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 6: launch_nr<T, kSymmetric, 6>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    case 7: launch_nr<T, kSymmetric, 7>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
    default: launch_nr<T, kSymmetric, 8>(grid, threads, s, data, x, y, npad, ndiags, nrhs, offsets); break;
  }
  return (int)cudaGetLastError();
}

#define DIA_SPMM_ENTRY(NAME, T, SYM)                                          \
  int NAME(const void* data, const void* x, void* y, long long npad,         \
           int ndiags, const long long* offsets, int nrhs, int nshards,      \
           void* stream) {                                                    \
    return launch<T, SYM>(data, x, y, npad, ndiags, offsets, nrhs, nshards,  \
                          stream);                                            \
  }

// `offsets`: a device pointer to ndiags int64 offsets
extern "C" {
DIA_SPMM_ENTRY(dia_spmm_f32, float, false)
DIA_SPMM_ENTRY(dia_spmm_f64, double, false)
DIA_SPMM_ENTRY(dia_spmm_bf16, __nv_bfloat16, false)
DIA_SPMM_ENTRY(dia_sym_spmm_f32, float, true)
DIA_SPMM_ENTRY(dia_sym_spmm_f64, double, true)
DIA_SPMM_ENTRY(dia_sym_spmm_bf16, __nv_bfloat16, true)
}  // extern "C"
