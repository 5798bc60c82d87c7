// The fused PCG iteration outside the preconditioner: step_ab, step_c and
// step_init, each one wrapper call.
//
// Replace the TPU kernels of fluidsolver_tpu/poisson/pallas_cg.py:
//   step_ab   (:109, pallas_call at :251)  Ap = A p, pAp = <p, Ap>,
//             alpha = rz / pAp, x' = x + alpha p, r' = r - alpha Ap,
//             rr = <r', r'>, sum_r = sum(r')
//   step_c    (:287, :426)  z = z_raw - mean(z_raw) (singular),
//             rz_new = <r, z_raw> - mean sum_r, beta = rz_new / rz_prev,
//             p' = z + beta p (or p' = z without p)
//   step_init (:462, :655)  b1 = b - mean(b), x1 = x0 - mean(x0)
//             (singular), bb = <b1, b1>, r_ws = b1 - A x1, the guess kept
//             iff <r_ws, r_ws> < bb; rr0 and sum_r0 of the kept residual
// The TPU kernels run a (phase, band) grid in order, so a dot product
// accumulated in phase 0 is complete when phase 1 uses it. Blocks of a CUDA
// grid run in no order, so each kernel is split at its reductions into
// launches on one stream: a pass kernel writes per-block partial sums, and
// a one-block finalize kernel adds them and derives the scalars (alpha,
// the mean, beta, the warm-start test) for the next pass. The sums are
// deterministic: each thread adds its grid-strided points in order, each
// block reduces its threads in a fixed tree, and the finalize kernel
// reduces the per-block partials in a fixed tree; no float atomics. They
// accumulate in the data type, as the TPU kernel and torch.sum do.
//
// Bound: device-memory bandwidth (~20 flops per point). step_ab reads the
// five coefficient planes, x, r and p and writes x' and r' (plus the Ap
// scratch plane, written by the matvec pass and read by the axpy pass);
// step_c reads r, z_raw and p and writes z and p'; step_init reads the
// planes, b and x0 and writes x0' and r0'.
#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kThreads = 256;     // threads of a pass kernel
constexpr int kMaxBlocks = 1024;  // blocks of a pass kernel = finalize threads
constexpr int kMaxSums = 4;       // sums per pass (poisson/cuda_cg.py PARTIALS)

int pass_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

// Reduce each thread's NQ sums over the block in a fixed tree; thread 0
// writes them to part[q * kMaxBlocks + blockIdx.x].
template <typename T, int NQ>
__device__ __forceinline__ void block_partials(const T (&v)[NQ], T* part) {
  static_assert(NQ <= kMaxSums, "part holds kMaxSums sums per block");
  __shared__ T s[NQ][kThreads];
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < NQ; ++q) s[q][t] = v[q];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) s[q][t] = s[q][t] + s[q][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) part[q * kMaxBlocks + blockIdx.x] = s[q][0];
  }
}

// In a one-block launch of kMaxBlocks threads: the totals of the partials of
// nblocks blocks, reduced in a fixed tree; every thread gets them.
template <typename T, int NQ>
__device__ __forceinline__ void total_partials(const T* part, int nblocks, T (&tot)[NQ]) {
  __shared__ T s[NQ][kMaxBlocks];
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < NQ; ++q) s[q][t] = t < nblocks ? part[q * kMaxBlocks + t] : T(0);
  __syncthreads();
  for (int w = kMaxBlocks / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) s[q][t] = s[q][t] + s[q][t + w];
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) tot[q] = s[q][0];
}

#define FS_GRID_STRIDE(o, n) \
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x; o < (n); \
       o += (long long)gridDim.x * kThreads)

// ---- step_ab -----------------------------------------------------------------
// scal: [pAp, rr, sum_r, alpha]
template <typename T>
__global__ void __launch_bounds__(kThreads) step_ab_kernel_matvec(Level<T> op, const T* p, T* Ap,
                                                                  T* part) {
  const int N = op.N, M = op.M;
  T acc[1] = {T(0)};
  FS_GRID_STRIDE(o, (long long)N * M) {
    const int i = static_cast<int>(o / M), j = static_cast<int>(o % M);
    auto X = [&](int a, int b) { return ld(p, a, b, N, M); };
    const T ap = apply_at<T, 5>(op, (size_t)o, i, j, X);
    Ap[o] = ap;
    acc[0] = acc[0] + p[o] * ap;
  }
  block_partials<T, 1>(acc, part);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlocks) step_ab_kernel_alpha(const T* part, int nblocks,
                                                                   const T* rz, T* scal) {
  T tot[1];
  total_partials<T, 1>(part, nblocks, tot);
  if (threadIdx.x == 0) {
    scal[0] = tot[0];
    scal[3] = rz[0] / safe(tot[0]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) step_ab_kernel_axpy(const T* x, const T* r, const T* p,
                                                                const T* Ap, const T* scal,
                                                                T* x_out, T* r_out, long long n,
                                                                T* part) {
  const T alpha = scal[3];
  T acc[2] = {T(0), T(0)};
  FS_GRID_STRIDE(o, n) {
    const T rn = r[o] - alpha * Ap[o];
    x_out[o] = x[o] + alpha * p[o];
    r_out[o] = rn;
    acc[0] = acc[0] + rn * rn;
    acc[1] = acc[1] + rn;
  }
  block_partials<T, 2>(acc, part);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlocks) step_ab_kernel_sums(const T* part, int nblocks,
                                                                  T* scal) {
  T tot[2];
  total_partials<T, 2>(part, nblocks, tot);
  if (threadIdx.x == 0) {
    scal[1] = tot[0];
    scal[2] = tot[1];
  }
}

// ---- step_c ------------------------------------------------------------------
// scal: [rz_new, mean, beta]
template <typename T>
__global__ void __launch_bounds__(kThreads) step_c_kernel_sums(const T* r, const T* z_raw,
                                                               long long n, T* part) {
  T acc[2] = {T(0), T(0)};
  FS_GRID_STRIDE(o, n) {
    acc[0] = acc[0] + r[o] * z_raw[o];
    acc[1] = acc[1] + z_raw[o];
  }
  block_partials<T, 2>(acc, part);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlocks) step_c_kernel_beta(const T* part, int nblocks,
                                                                 int singular, T inv_n,
                                                                 const T* rz_prev, const T* sum_r,
                                                                 T* scal) {
  T tot[2];
  total_partials<T, 2>(part, nblocks, tot);
  if (threadIdx.x == 0) {
    const T mean = singular ? tot[1] * inv_n : T(0);
    const T rz_new = singular ? tot[0] - mean * sum_r[0] : tot[0];
    scal[0] = rz_new;
    scal[1] = mean;
    scal[2] = rz_new / safe(rz_prev[0]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) step_c_kernel_update(const T* z_raw, const T* p,
                                                                 const T* scal, int singular,
                                                                 T* z_out, T* p_out, long long n) {
  const T mean = scal[1], beta = scal[2];
  FS_GRID_STRIDE(o, n) {
    const T z = singular ? z_raw[o] - mean : z_raw[o];
    z_out[o] = z;
    if (p) p_out[o] = z + beta * p[o];
  }
}

// ---- step_init ---------------------------------------------------------------
// scal: [bb, rr0, sum_r0, mean_b, mean_x, good]
template <typename T>
__global__ void __launch_bounds__(kThreads) step_init_kernel_means(const T* b, const T* x0,
                                                                   long long n, T* part) {
  T acc[2] = {T(0), T(0)};
  FS_GRID_STRIDE(o, n) {
    acc[0] = acc[0] + b[o];
    if (x0) acc[1] = acc[1] + x0[o];
  }
  block_partials<T, 2>(acc, part);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlocks) step_init_kernel_mean(const T* part, int nblocks,
                                                                    T inv_n, T* scal) {
  T tot[2];
  total_partials<T, 2>(part, nblocks, tot);
  if (threadIdx.x == 0) {
    scal[3] = tot[0] * inv_n;
    scal[4] = tot[1] * inv_n;
  }
}

// b1 = b - mean_b; the warm start's residual r_ws = b1 - A x1 into r_out
// (cold: r_out = b1, x_out = 0); partials of <b1,b1>, sum(b1) and, warm,
// <r_ws,r_ws>, sum(r_ws)
template <typename T>
__global__ void __launch_bounds__(kThreads) step_init_kernel_resid(Level<T> op, const T* b,
                                                                   const T* x0, const T* scal,
                                                                   int singular, T* x_out,
                                                                   T* r_out, T* part) {
  const int N = op.N, M = op.M;
  const T mean_b = singular ? scal[3] : T(0), mean_x = singular ? scal[4] : T(0);
  T acc[4] = {T(0), T(0), T(0), T(0)};
  FS_GRID_STRIDE(o, (long long)N * M) {
    const T b1 = singular ? b[o] - mean_b : b[o];
    acc[0] = acc[0] + b1 * b1;
    acc[1] = acc[1] + b1;
    if (x0) {
      const int i = static_cast<int>(o / M), j = static_cast<int>(o % M);
      auto X = [&](int a, int c) {
        if (a < 0 || a >= N || c < 0 || c >= M) return T(0);
        const T v = x0[(size_t)a * M + c];
        return singular ? v - mean_x : v;
      };
      const T rws = b1 - apply_at<T, 5>(op, (size_t)o, i, j, X);
      r_out[o] = rws;
      acc[2] = acc[2] + rws * rws;
      acc[3] = acc[3] + rws;
    } else {
      r_out[o] = b1;
      x_out[o] = T(0);
    }
  }
  block_partials<T, 4>(acc, part);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlocks) step_init_kernel_test(const T* part, int nblocks,
                                                                    int warm, T* scal) {
  T tot[4];
  total_partials<T, 4>(part, nblocks, tot);
  if (threadIdx.x == 0) {
    const bool good = warm && tot[2] < tot[0];
    scal[0] = tot[0];
    scal[1] = good ? tot[2] : tot[0];
    scal[2] = good ? tot[3] : tot[1];
    scal[5] = good ? T(1) : T(0);
  }
}

// warm start: x_out = good ? x1 : 0, r_out = good ? r_ws (already there) : b1
template <typename T>
__global__ void __launch_bounds__(kThreads) step_init_kernel_select(const T* b, const T* x0,
                                                                    const T* scal, int singular,
                                                                    T* x_out, T* r_out,
                                                                    long long n) {
  const T mean_b = singular ? scal[3] : T(0), mean_x = singular ? scal[4] : T(0);
  const bool good = scal[5] != T(0);
  FS_GRID_STRIDE(o, n) {
    if (good) {
      x_out[o] = singular ? x0[o] - mean_x : x0[o];
    } else {
      x_out[o] = T(0);
      r_out[o] = singular ? b[o] - mean_b : b[o];
    }
  }
}

template <typename T>
Level<T> level5(const void* const* op, int N, int M) {
  Level<T> L{};
  for (int k = 0; k < 5; ++k) L.a[k] = static_cast<const T*>(op[k]);
  L.N = N;
  L.M = M;
  return L;
}

template <typename T>
int ab(const void* const* op, const void* x, const void* r, const void* p, const void* rz,
       int N, int M, void* x_out, void* r_out, void* Ap, void* part, void* scal, cudaStream_t s) {
  const long long n = (long long)N * M;
  const int nb = pass_blocks(n);
  T* P = static_cast<T*>(part);
  T* S = static_cast<T*>(scal);
  step_ab_kernel_matvec<T><<<nb, kThreads, 0, s>>>(level5<T>(op, N, M), static_cast<const T*>(p),
                                                   static_cast<T*>(Ap), P);
  step_ab_kernel_alpha<T><<<1, kMaxBlocks, 0, s>>>(P, nb, static_cast<const T*>(rz), S);
  step_ab_kernel_axpy<T><<<nb, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const T*>(p),
      static_cast<const T*>(Ap), S, static_cast<T*>(x_out), static_cast<T*>(r_out), n, P);
  step_ab_kernel_sums<T><<<1, kMaxBlocks, 0, s>>>(P, nb, S);
  return cudaGetLastError();
}

template <typename T>
int c(const void* r, const void* z_raw, const void* p, const void* rz_prev, const void* sum_r,
      int singular, long long n, void* z_out, void* p_out, void* part, void* scal,
      cudaStream_t s) {
  if (singular && !sum_r) return cudaErrorInvalidValue;
  if ((p == nullptr) != (p_out == nullptr)) return cudaErrorInvalidValue;
  const int nb = pass_blocks(n);
  T* P = static_cast<T*>(part);
  T* S = static_cast<T*>(scal);
  step_c_kernel_sums<T><<<nb, kThreads, 0, s>>>(static_cast<const T*>(r),
                                                static_cast<const T*>(z_raw), n, P);
  step_c_kernel_beta<T><<<1, kMaxBlocks, 0, s>>>(P, nb, singular, T(1.0 / (double)n),
                                                 static_cast<const T*>(rz_prev),
                                                 static_cast<const T*>(sum_r), S);
  step_c_kernel_update<T><<<nb, kThreads, 0, s>>>(static_cast<const T*>(z_raw),
                                                  static_cast<const T*>(p), S, singular,
                                                  static_cast<T*>(z_out), static_cast<T*>(p_out),
                                                  n);
  return cudaGetLastError();
}

template <typename T>
int init(const void* const* op, const void* b, const void* x0, int singular, int N, int M,
         void* x_out, void* r_out, void* part, void* scal, cudaStream_t s) {
  const long long n = (long long)N * M;
  const int nb = pass_blocks(n);
  T* P = static_cast<T*>(part);
  T* S = static_cast<T*>(scal);
  const T* B = static_cast<const T*>(b);
  const T* X0 = static_cast<const T*>(x0);
  if (singular) {
    step_init_kernel_means<T><<<nb, kThreads, 0, s>>>(B, X0, n, P);
    step_init_kernel_mean<T><<<1, kMaxBlocks, 0, s>>>(P, nb, T(1.0 / (double)n), S);
  }
  step_init_kernel_resid<T><<<nb, kThreads, 0, s>>>(level5<T>(op, N, M), B, X0, S, singular,
                                                    static_cast<T*>(x_out),
                                                    static_cast<T*>(r_out), P);
  step_init_kernel_test<T><<<1, kMaxBlocks, 0, s>>>(P, nb, X0 != nullptr, S);
  if (X0)
    step_init_kernel_select<T><<<nb, kThreads, 0, s>>>(B, X0, S, singular, static_cast<T*>(x_out),
                                                       static_cast<T*>(r_out), n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// Scratch of every entry point: part holds kMaxSums * kMaxBlocks values,
// scal 8, of the data type. dtype 0 = float, 1 = double. Each returns a
// cudaError_t (0 = launched).

// step_ab. op: 5 planes (aC, aL, aR, aB, aT) of (N, M); x, r, p: (N, M); rz:
// one value. Writes x_out, r_out and the Ap scratch (N, M), and scal[0..2]
// = pAp, rr, sum_r.
extern "C" int fs_step_ab(int dtype, const void* const* op, const void* x, const void* r,
                          const void* p, const void* rz, int N, int M, void* x_out, void* r_out,
                          void* Ap, void* part, void* scal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::ab<float>(op, x, r, p, rz, N, M, x_out, r_out, Ap, part, scal, s)
                    : fs::ab<double>(op, x, r, p, rz, N, M, x_out, r_out, Ap, part, scal, s);
}

// step_c. r, z_raw, p (or null): n values; rz_prev, sum_r (null unless
// singular): one value. Writes z_out, p_out (null iff p is null) and
// scal[0] = rz_new.
extern "C" int fs_step_c(int dtype, const void* r, const void* z_raw, const void* p,
                         const void* rz_prev, const void* sum_r, int singular, long long n,
                         void* z_out, void* p_out, void* part, void* scal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? fs::c<float>(r, z_raw, p, rz_prev, sum_r, singular, n, z_out, p_out, part, scal, s)
      : fs::c<double>(r, z_raw, p, rz_prev, sum_r, singular, n, z_out, p_out, part, scal, s);
}

// step_init. op: 5 planes of (N, M); b, x0 (null: cold start): (N, M).
// Writes x_out, r_out (N, M) and scal[0..2] = bb, rr0, sum_r0.
extern "C" int fs_step_init(int dtype, const void* const* op, const void* b, const void* x0,
                            int singular, int N, int M, void* x_out, void* r_out, void* part,
                            void* scal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::init<float>(op, b, x0, singular, N, M, x_out, r_out, part, scal, s)
                    : fs::init<double>(op, b, x0, singular, N, M, x_out, r_out, part, scal, s);
}
