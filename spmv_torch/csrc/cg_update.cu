// The vector work of an unpreconditioned CG iteration, fused into three
// kernels for Hopper (sm_90a), with the iteration's scalars kept on the card.
//
// Replaces no Pallas kernel: the reference's CG (spmv_tpu/solvers/cg.py) is
// a lax.while_loop of jnp ops, which XLA fuses on the TPU. Run as torch ops
// on the card, an iteration's vector work makes 19 passes over n-vectors:
// alpha*p, alpha*Ap and beta*p are written out and read back, r is read
// once for its update and again for r.r, p once for x and again for its own
// update, and the two dots are cuBLAS calls. These kernels make 10:
//
//   cg_pap        pAp = p.Ap;  alpha = rho / pAp             reads p, Ap
//   cg_update_r   r -= alpha Ap;  rho' = r.r;  beta = rho' / rho;
//                 flag = sqrt(rho') / max(rnorm0, tiny) >= rtol;
//                 rho = rho'                                  reads r, Ap;
//                                                             writes r
//   cg_update_xp  x += alpha p;  p = r + beta p               reads x, p, r;
//                                                             writes x, p
//
// alpha needs the global p.Ap and beta the global r.r, so no two of them
// merge while the apply stays a kernel of its own: 10 passes is the floor.
//
// Bound: bytes, 10 n itemsize an iteration (244.5 us for 10.24M float64 at
// 3.35 TB/s). A grid of at most (resident blocks a SM) x SMs blocks strides
// over the flattened vector with 16-byte loads (double2 / float4); a vector
// that is not 16-byte aligned, and the ragged tail, take scalar loads.
//
// The dots accumulate in double (for float32 vectors too, which costs
// nothing in a kernel bound by bytes). Each block writes one partial sum to
// scratch; the last block to finish (a completion ticket, the one atomic,
// which counts blocks and sums nothing) adds the partials in a fixed order
// and writes the scalars, then sets the ticket back to 0 for the next
// launch. The sums are the same bits from run to run on one card.
//
// The scalars are a small buffer in the vectors' type (kRho .. kFlag):
// the wrapper writes rho and rnorm0 before the first iteration; the host
// reads only the flag, once an iteration. Each scalar is rounded to the
// vectors' type where the torch loop rounds it, and the flag compares in
// that type, with rtol rounded to it, as torch compares a tensor with a
// Python float. nvcc contracts x + alpha p, r - alpha Ap and r + beta p
// into one fma each: one rounding where the torch loop rounds twice.
//
// Plain C interface, bound from Python with ctypes
// (spmv_torch/ops/cg_update_cuda.py). Each entry launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

static constexpr int kThreads = 256;
static constexpr int kWarps = kThreads / 32;
// the scalar buffer's slots (ops/cg_update_cuda.py: RHO .. FLAG)
static constexpr int kRho = 0, kAlpha = 1, kBeta = 2, kRnorm0 = 3, kFlag = 4;

template <typename T> struct Pack;  // 16 bytes of T
template <> struct Pack<float> {
  static constexpr int N = 4;
  float v[4];
  __device__ __forceinline__ static Pack load(const float* p, long long i) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    return {{t.x, t.y, t.z, t.w}};
  }
  __device__ __forceinline__ void store(float* p, long long i) const {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Pack<double> {
  static constexpr int N = 2;
  double v[2];
  __device__ __forceinline__ static Pack load(const double* p, long long i) {
    const double2 t = reinterpret_cast<const double2*>(p)[i];
    return {{t.x, t.y}};
  }
  __device__ __forceinline__ void store(double* p, long long i) const {
    reinterpret_cast<double2*>(p)[i] = make_double2(v[0], v[1]);
  }
};

template <typename T> struct Tiny;  // torch.finfo(T).tiny
template <> struct Tiny<float> { static constexpr float value = FLT_MIN; };
template <> struct Tiny<double> { static constexpr double value = DBL_MIN; };

// correctly rounded, as torch.sqrt (no fast math in the build)
__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }

// The block's sum of v, in thread 0; the same order on every run.
__device__ __forceinline__ double block_sum(double v, double* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.0;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kWarps ? sh[threadIdx.x] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The grid's sum of every thread's ``part``: true in thread 0 of the last
// block to finish, with the sum in *total; false everywhere else.
__device__ bool grid_sum(double part, double* partials, unsigned* ticket,
                         double* total) {
  __shared__ double sh[kWarps];
  __shared__ bool last;
  const double s = block_sum(part, sh);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();  // the partial is seen before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  double t = 0.0;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += kThreads)
    t += __ldcg(partials + i);  // from L2, where the other blocks wrote
  __syncthreads();  // sh is reused
  t = block_sum(t, sh);
  if (threadIdx.x != 0) return false;
  *ticket = 0u;
  *total = t;
  return true;
}

// 16-byte packs below nv (0 where a vector is not 16-byte aligned); the
// scalar tail from nv * N.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_pap_kernel(const T* __restrict__ p, const T* __restrict__ ap, long long n,
              long long nv, T* __restrict__ s, double* __restrict__ partials,
              unsigned* __restrict__ ticket) {
  constexpr int N = Pack<T>::N;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  double acc = 0.0;
  for (long long i = t0; i < nv; i += stride) {
    const Pack<T> a = Pack<T>::load(p, i), b = Pack<T>::load(ap, i);
#pragma unroll
    for (int j = 0; j < N; ++j) acc += (double)a.v[j] * (double)b.v[j];
  }
  for (long long i = nv * N + t0; i < n; i += stride)
    acc += (double)p[i] * (double)ap[i];
  double total;
  if (grid_sum(acc, partials, ticket, &total)) s[kAlpha] = s[kRho] / (T)total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_r_kernel(T* __restrict__ r, const T* __restrict__ ap, long long n,
                   long long nv, T* __restrict__ s,
                   double* __restrict__ partials, unsigned* __restrict__ ticket,
                   T rtol) {
  constexpr int N = Pack<T>::N;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const T alpha = s[kAlpha];
  double acc = 0.0;
  for (long long i = t0; i < nv; i += stride) {
    Pack<T> a = Pack<T>::load(r, i);
    const Pack<T> b = Pack<T>::load(ap, i);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a.v[j] = a.v[j] - alpha * b.v[j];
      acc += (double)a.v[j] * (double)a.v[j];
    }
    a.store(r, i);
  }
  for (long long i = nv * N + t0; i < n; i += stride) {
    const T v = r[i] - alpha * ap[i];
    r[i] = v;
    acc += (double)v * (double)v;
  }
  double total;
  if (grid_sum(acc, partials, ticket, &total)) {
    const T rho = (T)total, r0 = s[kRnorm0], tiny = Tiny<T>::value;
    // torch.clamp(rnorm0, min=tiny): a NaN stays NaN
    const T rel = root(rho) / (r0 < tiny ? tiny : r0);
    s[kBeta] = rho / s[kRho];
    s[kFlag] = rel >= rtol ? T(1) : T(0);
    s[kRho] = rho;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_xp_kernel(T* __restrict__ x, T* __restrict__ p,
                    const T* __restrict__ r, long long n, long long nv,
                    const T* __restrict__ s) {
  constexpr int N = Pack<T>::N;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const T alpha = s[kAlpha], beta = s[kBeta];
  for (long long i = t0; i < nv; i += stride) {
    Pack<T> xv = Pack<T>::load(x, i), pv = Pack<T>::load(p, i);
    const Pack<T> rv = Pack<T>::load(r, i);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      xv.v[j] = xv.v[j] + alpha * pv.v[j];
      pv.v[j] = rv.v[j] + beta * pv.v[j];
    }
    xv.store(x, i);
    pv.store(p, i);
  }
  for (long long i = nv * N + t0; i < n; i += stride) {
    const T pi = p[i];
    x[i] = x[i] + alpha * pi;
    p[i] = r[i] + beta * pi;
  }
}

static bool aligned16(const void* a, const void* b, const void* c = nullptr) {
  return ((reinterpret_cast<std::uintptr_t>(a) | reinterpret_cast<std::uintptr_t>(b) |
           reinterpret_cast<std::uintptr_t>(c)) & 15u) == 0;
}

// Blocks for n entries: enough for one pack a thread, at most the blocks
// resident on the card at once and at most max_blocks (the scratch's
// partials). *err is the first CUDA error of the queries.
template <typename Kernel>
static unsigned grid_for(Kernel kernel, long long n, int per_pack,
                         int max_blocks, int* resident, cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess && *resident == 0)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         kThreads, 0);
  long long blocks = (n + (long long)per_pack * kThreads - 1) /
                     ((long long)per_pack * kThreads);
  if (blocks > (long long)*resident * sms) blocks = (long long)*resident * sms;
  if (blocks > max_blocks) blocks = max_blocks;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <typename T>
static int launch_pap(const void* p, const void* ap, long long n, void* s,
                      void* partials, void* ticket, int max_blocks,
                      void* stream) {
  static int resident = 0;
  if (n < 0 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const unsigned grid = grid_for(cg_pap_kernel<T>, n, Pack<T>::N, max_blocks,
                                 &resident, &err);
  if (err != cudaSuccess) return (int)err;
  const long long nv = aligned16(p, ap) ? n / Pack<T>::N : 0;
  cg_pap_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(ap), n, nv,
      static_cast<T*>(s), static_cast<double*>(partials),
      static_cast<unsigned*>(ticket));
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_update_r(void* r, const void* ap, long long n, void* s,
                           void* partials, void* ticket, int max_blocks,
                           double rtol, void* stream) {
  static int resident = 0;
  if (n < 0 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const unsigned grid = grid_for(cg_update_r_kernel<T>, n, Pack<T>::N,
                                 max_blocks, &resident, &err);
  if (err != cudaSuccess) return (int)err;
  const long long nv = aligned16(r, ap) ? n / Pack<T>::N : 0;
  cg_update_r_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(r), static_cast<const T*>(ap), n, nv, static_cast<T*>(s),
      static_cast<double*>(partials), static_cast<unsigned*>(ticket), (T)rtol);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_update_xp(void* x, void* p, const void* r, long long n,
                            const void* s, int max_blocks, void* stream) {
  static int resident = 0;
  if (n < 0 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const unsigned grid = grid_for(cg_update_xp_kernel<T>, n, Pack<T>::N,
                                 max_blocks, &resident, &err);
  if (err != cudaSuccess) return (int)err;
  const long long nv = aligned16(x, p, r) ? n / Pack<T>::N : 0;
  cg_update_xp_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(x), static_cast<T*>(p), static_cast<const T*>(r), n, nv,
      static_cast<const T*>(s));
  return (int)cudaGetLastError();
}

#define CG_ENTRIES(SUFFIX, T)                                                 \
  int cg_pap_##SUFFIX(const void* p, const void* ap, long long n, void* s,   \
                      void* partials, void* ticket, int max_blocks,          \
                      void* stream) {                                        \
    return launch_pap<T>(p, ap, n, s, partials, ticket, max_blocks, stream); \
  }                                                                          \
  int cg_update_r_##SUFFIX(void* r, const void* ap, long long n, void* s,    \
                           void* partials, void* ticket, int max_blocks,     \
                           double rtol, void* stream) {                      \
    return launch_update_r<T>(r, ap, n, s, partials, ticket, max_blocks,     \
                              rtol, stream);                                 \
  }                                                                          \
  int cg_update_xp_##SUFFIX(void* x, void* p, const void* r, long long n,    \
                            const void* s, int max_blocks, void* stream) {   \
    return launch_update_xp<T>(x, p, r, n, s, max_blocks, stream);           \
  }

extern "C" {
CG_ENTRIES(f32, float)
CG_ENTRIES(f64, double)
}  // extern "C"
