// fused_smooth: one whole red-black smoothing phase on a BoxMG level in one
// launch, with the optional residual b - A x, restriction P^T r epilogue, or
// prolongation-and-correction x0 + P ec prologue.
//
// Replaces the TPU kernel fluidsolver_tpu/poisson/pallas_vcycle.py:357
// (fused_smooth, pallas_call at :462). The TPU kernel streams row bands
// through VMEM in a band-padded layout with parity-packed transfer planes;
// none of that layout is kept. What is kept is the temporal blocking: a
// block owns a 32x32 output tile and holds the iterate on the tile plus an
// H-deep halo in shared memory, H = half-steps + 1 (residual) or + 2
// (restriction reads the residual one point past the tile). Each colour
// half-step reads the previous iterate at every neighbour (also the
// same-colour 9-point corners), so it is a pure function of x: the block
// ping-pongs between two shared buffers and every half-step invalidates one
// more halo ring. The prolongation needs no halo: each point reads the
// coarse error and weights it needs from global memory.
//
// Bound: device-memory bandwidth. A phase reads the coefficients, b and x0
// once (the halo re-reads hit L1) and writes x and the residual or the
// coarse right-hand side once, instead of one pass per half-step.
#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kTile = 32;
constexpr int kMaxHalo = 8;
constexpr int kRegion = kTile + 2 * kMaxHalo;
constexpr int kThreads = 256;

enum Mode { kPlain = 0, kResidual = 1, kRestrict = 2 };

template <typename T>
struct SmoothArgs {
  Level<T> op;
  const T* b;
  const T* x0;        // null: start from zero
  WeightPlanes<T> tr; // restriction / prolongation weights
  const T* ec;        // coarse error for the prologue, or null
  T* x_out;           // (N, M)
  T* r_out;           // residual (N, M) or restricted residual (Nc, Mc)
  unsigned colors;    // bit s set: half-step s updates red points
  int n_colors;
  int halo;
};

template <typename T, int NC, int MODE, bool EC>
__global__ void __launch_bounds__(kThreads) fused_smooth_kernel(SmoothArgs<T> A) {
  __shared__ T xs[2][kRegion * kRegion];
  const int N = A.op.N, M = A.op.M, H = A.halo;
  const int R = kTile + 2 * H;                 // region side
  const int gi0 = blockIdx.y * kTile - H, gj0 = blockIdx.x * kTile - H;
  const int tid = threadIdx.x;

  // initial iterate (zero outside the level)
  for (int p = tid; p < R * R; p += kThreads) {
    const int gi = gi0 + p / R, gj = gj0 + p % R;
    T v = T(0);
    if (gi >= 0 && gi < N && gj >= 0 && gj < M) {
      if (A.x0) v = A.x0[(size_t)gi * M + gj];
      if (EC) {
        const int Nc = A.tr.Nc, Mc = A.tr.Mc;
        const T* ec = A.ec;
        auto E = [&](int k, int l) { return ld(ec, k, l, Nc, Mc); };
        v = v + prolong_at<T>(gi, gj, E, A.tr);
      }
    }
    xs[0][p] = v;
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < A.n_colors; ++s) {
    const bool red = (A.colors >> s) & 1u;
    const T* x = xs[cur];
    T* xn = xs[cur ^ 1];
    for (int p = tid; p < R * R; p += kThreads) {
      const int ri = p / R, rj = p % R;
      const int gi = gi0 + ri, gj = gj0 + rj;
      T v = x[p];
      // the outermost ring is never updated (its neighbours are off-region)
      if (ri > 0 && ri < R - 1 && rj > 0 && rj < R - 1 &&
          gi >= 0 && gi < N && gj >= 0 && gj < M && (((gi + gj) & 1) == 0) == red) {
        const size_t o = (size_t)gi * M + gj;
        auto X = [&](int i, int j) { return x[(i - gi0) * R + (j - gj0)]; };
        v = gs_value<T, NC>(A.op, o, gi, gj, A.b[o], X);
      }
      xn[p] = v;
    }
    __syncthreads();
    cur ^= 1;
  }

  const T* x = xs[cur];
  auto X = [&](int i, int j) { return x[(i - gi0) * R + (j - gj0)]; };
  // smoothed iterate on the tile
  for (int p = tid; p < kTile * kTile; p += kThreads) {
    const int gi = gi0 + H + p / kTile, gj = gj0 + H + p % kTile;
    if (gi < N && gj < M) {
      const size_t o = (size_t)gi * M + gj;
      A.x_out[o] = X(gi, gj);
      if (MODE == kResidual) A.r_out[o] = A.b[o] - apply_at<T, NC>(A.op, o, gi, gj, X);
    }
  }
  if (MODE != kRestrict) return;

  // residual on the tile plus a one-point ring, into the free buffer
  T* r = xs[cur ^ 1];
  const int RR = kTile + 2;
  for (int p = tid; p < RR * RR; p += kThreads) {
    const int gi = gi0 + H - 1 + p / RR, gj = gj0 + H - 1 + p % RR;
    T v = T(0);
    if (gi >= 0 && gi < N && gj >= 0 && gj < M) {
      const size_t o = (size_t)gi * M + gj;
      v = A.b[o] - apply_at<T, NC>(A.op, o, gi, gj, X);
    }
    r[p] = v;
  }
  __syncthreads();
  const int ri0 = gi0 + H - 1, rj0 = gj0 + H - 1;
  auto Rs = [&](int i, int j) { return r[(i - ri0) * RR + (j - rj0)]; };
  // coarse points whose injection point (2k, 2l) lies on this tile
  constexpr int kCT = kTile / 2;
  for (int p = tid; p < kCT * kCT; p += kThreads) {
    const int k = blockIdx.y * kCT + p / kCT, l = blockIdx.x * kCT + p % kCT;
    if (k < A.tr.Nc && l < A.tr.Mc)
      A.r_out[(size_t)k * A.tr.Mc + l] = restrict_at<T>(k, l, Rs, A.tr);
  }
}

template <typename T, int NC>
cudaError_t dispatch(const SmoothArgs<T>& a, int mode, dim3 grid, cudaStream_t s) {
  const bool ec = a.ec != nullptr;
  if (mode == kPlain && !ec) fused_smooth_kernel<T, NC, kPlain, false><<<grid, kThreads, 0, s>>>(a);
  else if (mode == kPlain) fused_smooth_kernel<T, NC, kPlain, true><<<grid, kThreads, 0, s>>>(a);
  else if (mode == kResidual) fused_smooth_kernel<T, NC, kResidual, false><<<grid, kThreads, 0, s>>>(a);
  else fused_smooth_kernel<T, NC, kRestrict, false><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(int ncoef, const void* const* op, const void* b, const void* x0,
           const void* const* tr, const void* ec, int Nc, int Mc, void* x_out,
           void* r_out, int N, int M, unsigned colors, int n_colors, int mode,
           cudaStream_t stream) {
  SmoothArgs<T> a{};
  for (int k = 0; k < ncoef; ++k) a.op.a[k] = static_cast<const T*>(op[k]);
  a.op.N = N;
  a.op.M = M;
  a.b = static_cast<const T*>(b);
  a.x0 = static_cast<const T*>(x0);
  if (tr)
    for (int q = 0; q < 8; ++q) a.tr.w[q] = static_cast<const T*>(tr[q]);
  a.tr.Nc = Nc;
  a.tr.Mc = Mc;
  a.ec = static_cast<const T*>(ec);
  a.x_out = static_cast<T*>(x_out);
  a.r_out = static_cast<T*>(r_out);
  a.colors = colors;
  a.n_colors = n_colors;
  a.halo = n_colors + (mode == kRestrict ? 2 : mode == kResidual ? 1 : 0);
  if (a.halo > kMaxHalo || (ec && mode != kPlain) || (mode == kRestrict && !tr) ||
      (ec && !tr) || (mode != kPlain && !r_out))
    return cudaErrorInvalidValue;
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  return ncoef == 5 ? dispatch<T, 5>(a, mode, grid, stream) : dispatch<T, 9>(a, mode, grid, stream);
}

}  // namespace
}  // namespace fs

// One smoothing phase. op: ncoef (5 or 9) planes (N, M); b, x0 (or null):
// (N, M); tr: 8 weight planes (Nc, Mc) or null; ec: (Nc, Mc) or null.
// mode 0: x only (with the ec prologue if ec is given); 1: also r_out =
// b - A x (N, M); 2: also r_out = P^T (b - A x) (Nc, Mc). Half-step s
// updates red points ((i + j) even) if bit s of colors is set, else black.
// dtype 0 = float, 1 = double. Returns a cudaError_t (0 = launched).
extern "C" int fs_fused_smooth(int dtype, int ncoef, const void* const* op, const void* b,
                               const void* x0, const void* const* tr, const void* ec,
                               int Nc, int Mc, void* x_out, void* r_out, int N, int M,
                               unsigned colors, int n_colors, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? fs::launch<float>(ncoef, op, b, x0, tr, ec, Nc, Mc, x_out, r_out, N, M, colors,
                          n_colors, mode, s)
      : fs::launch<double>(ncoef, op, b, x0, tr, ec, Nc, Mc, x_out, r_out, N, M, colors,
                           n_colors, mode, s);
}
