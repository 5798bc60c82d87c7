// The BoxMG coarse tail: every level from the tail start (at most
// kMaxTailLevels levels, at most 160 points a side) in one launch each for
// its setup and for its V-cycle.
//
// tail_setup replaces fluidsolver_tpu/poisson/pallas_tail.py:403
// (build_tail_pack_fused, pallas_call at :436): from the tail-finest
// operator it builds every coarser tail level's transfer weights and 9-point
// Galerkin operator. The TPU kernel keeps a dilated pyramid canvas in VMEM
// and forms the Galerkin product by comb probing; here the weights and the
// closed-form product are the device functions fused_rap uses
// (boxmg_device.cuh), so the result equals boxmg.galerkin_closed level by
// level.
//
// tail_cycle replaces fluidsolver_tpu/poisson/pallas_tail.py:455
// (tail_cycle, pallas_call at :482): one V(n_pre, n_post) cycle over the
// whole tail, the coarsest level running COARSE_SWEEPS / 2 forward+reverse
// sweep pairs instead of a dense inverse.
//
// Bound: synchronisation and on-chip bandwidth, not device memory. The tail
// is a few hundred KB and stays in the 50 MB L2; a cycle is ~110 dependent
// colour updates. Both kernels are one thread block of 1024 threads that
// walks the levels in global memory with __syncthreads() between
// dependent steps -- one launch instead of ~13 per level visit. Colour
// updates ping-pong between two buffers because a 9-point update reads the
// previous iterate at its same-colour corners. One block uses one SM; a
// cluster or shared-memory-resident version is later work.
#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kThreads = 1024;
constexpr int kCoarsePairs = 16;   // boxmg.COARSE_SWEEPS // 2

// ---- setup -----------------------------------------------------------------
// Layout of the pack buffer, per level d < n_levels - 1 with coarse size
// S = Nc_d * Mc_d: 8 weight planes (transfer d -> d+1), then the 9
// coefficient planes of level d+1. cuda_tail.py uses the same layout.
template <typename T, int NC>
__device__ void setup_level(const Level<T>& F, T* W, T* C) {
  const int Nc = (F.N + 1) / 2, Mc = (F.M + 1) / 2;
  const size_t S = (size_t)Nc * Mc;
  for (size_t p = threadIdx.x; p < S; p += kThreads) {
    T w[8];
    collapse_point<T, NC>(F, (int)(p / Mc), (int)(p % Mc), w);
#pragma unroll
    for (int q = 0; q < 8; ++q) W[q * S + p] = w[q];
  }
  __syncthreads();
  WeightPlanes<T> wp;
  for (int q = 0; q < 8; ++q) wp.w[q] = W + q * S;
  wp.Nc = Nc;
  wp.Mc = Mc;
  for (size_t p = threadIdx.x; p < S; p += kThreads) {
    T c[9];
    rap_point<T, NC>(F, (int)(p / Mc), (int)(p % Mc), wp, c);
#pragma unroll
    for (int q = 0; q < 9; ++q) C[q * S + p] = c[q];
  }
  __syncthreads();
}

template <typename T, int NC0>
__global__ void __launch_bounds__(kThreads) tail_setup_kernel(Level<T> F, int n_levels, T* buf) {
  T* p = buf;
  for (int d = 0; d < n_levels - 1; ++d) {
    const int Nc = (F.N + 1) / 2, Mc = (F.M + 1) / 2;
    const size_t S = (size_t)Nc * Mc;
    if (d == 0 && NC0 == 5) setup_level<T, 5>(F, p, p + 8 * S);
    else setup_level<T, 9>(F, p, p + 8 * S);
    for (int k = 0; k < 9; ++k) F.a[k] = p + (8 + k) * S;
    F.N = Nc;
    F.M = Mc;
    p += 17 * S;
  }
}

// ---- cycle -----------------------------------------------------------------
template <typename T>
struct TailLevel {
  Level<T> op;
  WeightPlanes<T> tr;   // transfer to the next level (unused on the coarsest)
  T* x;                 // iterate
  T* xt;                // ping-pong partner
  T* b;                 // right-hand side
  T* r;                 // residual
};

template <typename T>
struct TailArgs {
  TailLevel<T> lv[kMaxTailLevels];
  int n_levels, n_pre, n_post;
  T* x_out;
};

// one colour half-step on level L: x <- GS value on the colour's points;
// returns with L.x holding the result (buffers swapped)
template <typename T, int NC>
__device__ void half_step(TailLevel<T>& L, bool red) {
  const int N = L.op.N, M = L.op.M;
  const T* x = L.x;
  auto X = [&](int i, int j) { return ld(x, i, j, N, M); };
  for (int p = threadIdx.x; p < N * M; p += kThreads) {
    const int i = p / M, j = p % M;
    T v = x[p];
    if ((((i + j) & 1) == 0) == red) v = gs_value<T, NC>(L.op, (size_t)p, i, j, L.b[p], X);
    L.xt[p] = v;
  }
  __syncthreads();
  T* t = L.x;
  L.x = L.xt;
  L.xt = t;
}

template <typename T, int NC>
__device__ void residual(TailLevel<T>& L) {
  const int N = L.op.N, M = L.op.M;
  const T* x = L.x;
  auto X = [&](int i, int j) { return ld(x, i, j, N, M); };
  for (int p = threadIdx.x; p < N * M; p += kThreads)
    L.r[p] = L.b[p] - apply_at<T, NC>(L.op, (size_t)p, p / M, p % M, X);
  __syncthreads();
}

template <typename T, int NC0, int NC>
__device__ void smooth(TailArgs<T>& A, int d, bool first_red, int n_sweeps) {
  for (int s = 0; s < n_sweeps; ++s) {
    if (d == 0) {
      half_step<T, NC0>(A.lv[0], first_red);
      half_step<T, NC0>(A.lv[0], !first_red);
    } else {
      half_step<T, NC>(A.lv[d], first_red);
      half_step<T, NC>(A.lv[d], !first_red);
    }
  }
}

template <typename T, int NC0>
__global__ void __launch_bounds__(kThreads) tail_cycle_kernel(TailArgs<T> A) {
  const int nl = A.n_levels;
  // descent: pre-smooth from zero, residual, restrict
  for (int d = 0; d < nl - 1; ++d) {
    TailLevel<T>& L = A.lv[d];
    const int N = L.op.N, M = L.op.M;
    for (int p = threadIdx.x; p < N * M; p += kThreads) L.x[p] = T(0);
    __syncthreads();
    smooth<T, NC0, 9>(A, d, true, A.n_pre);
    if (d == 0) residual<T, NC0>(L);
    else residual<T, 9>(L);
    TailLevel<T>& Cl = A.lv[d + 1];
    const T* r = L.r;
    auto R = [&](int i, int j) { return ld(r, i, j, N, M); };
    for (int p = threadIdx.x; p < Cl.op.N * Cl.op.M; p += kThreads)
      Cl.b[p] = restrict_at<T>(p / Cl.op.M, p % Cl.op.M, R, L.tr);
    __syncthreads();
  }
  // coarsest: symmetric forward+reverse sweep pairs from zero
  {
    TailLevel<T>& L = A.lv[nl - 1];
    for (int p = threadIdx.x; p < L.op.N * L.op.M; p += kThreads) L.x[p] = T(0);
    __syncthreads();
    for (int s = 0; s < kCoarsePairs; ++s) {
      half_step<T, 9>(L, true);
      half_step<T, 9>(L, false);
      half_step<T, 9>(L, false);
      half_step<T, 9>(L, true);
    }
  }
  // ascent: prolongate + correct, post-smooth (black first)
  for (int d = nl - 2; d >= 0; --d) {
    TailLevel<T>& L = A.lv[d];
    const TailLevel<T>& Cl = A.lv[d + 1];
    const int N = L.op.N, M = L.op.M;
    const T* ec = Cl.x;
    const int Nc = Cl.op.N, Mc = Cl.op.M;
    auto E = [&](int k, int l) { return ld(ec, k, l, Nc, Mc); };
    for (int p = threadIdx.x; p < N * M; p += kThreads)
      L.x[p] = L.x[p] + prolong_at<T>(p / M, p % M, E, L.tr);
    __syncthreads();
    smooth<T, NC0, 9>(A, d, false, A.n_post);
  }
  const TailLevel<T>& L0 = A.lv[0];
  for (int p = threadIdx.x; p < L0.op.N * L0.op.M; p += kThreads) A.x_out[p] = L0.x[p];
}

template <typename T>
int setup(int ncoef0, const void* const* op0, int N, int M, int n_levels, void* buf,
          cudaStream_t stream) {
  if (n_levels < 2 || n_levels > kMaxTailLevels) return cudaErrorInvalidValue;
  Level<T> F{};
  for (int k = 0; k < ncoef0; ++k) F.a[k] = static_cast<const T*>(op0[k]);
  F.N = N;
  F.M = M;
  if (ncoef0 == 5) tail_setup_kernel<T, 5><<<1, kThreads, 0, stream>>>(F, n_levels, static_cast<T*>(buf));
  else tail_setup_kernel<T, 9><<<1, kThreads, 0, stream>>>(F, n_levels, static_cast<T*>(buf));
  return cudaGetLastError();
}

template <typename T>
int cycle(int ncoef0, const void* const* op0, const void* buf, const void* b, void* x_out,
          void* scratch, int N, int M, int n_levels, int n_pre, int n_post,
          cudaStream_t stream) {
  if (n_levels < 2 || n_levels > kMaxTailLevels) return cudaErrorInvalidValue;
  TailArgs<T> A{};
  A.n_levels = n_levels;
  A.n_pre = n_pre;
  A.n_post = n_post;
  A.x_out = static_cast<T*>(x_out);
  const T* p = static_cast<const T*>(buf);
  T* s = static_cast<T*>(scratch);
  for (int d = 0; d < n_levels; ++d) {
    TailLevel<T>& L = A.lv[d];
    L.op.N = N;
    L.op.M = M;
    const size_t S = (size_t)N * M;
    if (d == 0)
      for (int k = 0; k < ncoef0; ++k) L.op.a[k] = static_cast<const T*>(op0[k]);
    // scratch per level: x, xt, r, and b below the tail-finest level
    L.x = s;
    L.xt = s + S;
    L.r = s + 2 * S;
    L.b = d == 0 ? const_cast<T*>(static_cast<const T*>(b)) : s + 3 * S;
    s += 4 * S;
    if (d < n_levels - 1) {
      const int Nc = (N + 1) / 2, Mc = (M + 1) / 2;
      const size_t Sc = (size_t)Nc * Mc;
      for (int q = 0; q < 8; ++q) L.tr.w[q] = p + q * Sc;
      L.tr.Nc = Nc;
      L.tr.Mc = Mc;
      for (int k = 0; k < 9; ++k) A.lv[d + 1].op.a[k] = p + (8 + k) * Sc;
      p += 17 * Sc;
      N = Nc;
      M = Mc;
    }
  }
  if (ncoef0 == 5) tail_cycle_kernel<T, 5><<<1, kThreads, 0, stream>>>(A);
  else tail_cycle_kernel<T, 9><<<1, kThreads, 0, stream>>>(A);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// Tail setup. op0: ncoef0 (5 or 9) planes of the (N, M) tail-finest level;
// buf: the pack buffer (layout above), sum over d < n_levels-1 of
// 17 * Nc_d * Mc_d elements. dtype 0 = float, 1 = double.
extern "C" int fs_tail_setup(int dtype, int ncoef0, const void* const* op0, int N, int M,
                             int n_levels, void* buf, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::setup<float>(ncoef0, op0, N, M, n_levels, buf, s)
                    : fs::setup<double>(ncoef0, op0, N, M, n_levels, buf, s);
}

// One tail V-cycle for right-hand side b (N, M) into x_out (N, M). scratch:
// 4 * N_d * M_d elements per level d. dtype 0 = float, 1 = double.
extern "C" int fs_tail_cycle(int dtype, int ncoef0, const void* const* op0, const void* buf,
                             const void* b, void* x_out, void* scratch, int N, int M,
                             int n_levels, int n_pre, int n_post, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? fs::cycle<float>(ncoef0, op0, buf, b, x_out, scratch, N, M, n_levels, n_pre, n_post, s)
      : fs::cycle<double>(ncoef0, op0, buf, b, x_out, scratch, N, M, n_levels, n_pre, n_post, s);
}
