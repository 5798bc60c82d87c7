// fused_smooth: one whole red-black smoothing phase on a BoxMG level in one
// launch, with the optional residual b - A x, restriction P^T r epilogue, or
// prolongation-and-correction x0 + P ec prologue.
//
// Replaces the TPU kernel fluidsolver_tpu/poisson/pallas_vcycle.py:357
// (fused_smooth, pallas_call at :462). The TPU kernel streams row bands
// through VMEM in a band-padded layout with parity-packed transfer planes;
// none of that layout is kept. What is kept is the temporal blocking: a
// block owns an output tile and holds the iterate on the tile plus an H-deep
// halo in shared memory, H = half-steps + 1 (residual) or + 2 (restriction
// reads the residual one point past the tile), so the phase reads its
// operands once and writes x and the residual (fine or coarse) once.
//
// What bounds it on an H100 is each block's chain of dependent loads and
// barriers, not the bytes (0.0116 ms for the bench's 1026^2 restriction
// phase): a first version, which read every coefficient from L1/L2 again in
// every half-step at every point of its region, took 4.4x that bound. The
// design:
// - a fixed thread-to-point map for the whole launch: the block is BX x BY
//   threads over a region of RI = BY * P rows and RJ = 2 * BX columns;
//   thread (tx, ty) owns the column pair (2 tx, 2 tx + 1) of the P adjacent
//   rows P ty + p, so one red and one black point a row. Its points'
//   coefficients and b are loaded once, all loads issued together, into
//   registers;
// - one iterate buffer in shared memory, stored colour-split by column
//   parity (a warp's reads of the active colour and of each neighbour are
//   consecutive words), with a zero guard row on each side so that every
//   neighbour is a fixed offset from the point. A half-step updates only the
//   active colour and only the rings of the halo that later half-steps
//   still read; a thread with any such point computes all its new values
//   (their dependency chains overlap) before it stores those. A 5-point
//   update reads only the other colour, so it writes in place; a 9-point
//   update also reads same-colour corners, so the block computes every new
//   value before any is written (two barriers per half-step);
// - the region is a compile-time shape (no index arithmetic divides), and
//   the host picks it from the level's size and the variant (dispatch);
// - the restriction phase copies its weights into shared memory with
//   cp.async at the start (in flight during the half-steps) and writes its
//   residual into a second shared buffer, read by the restriction.
// Per point the arithmetic is boxmg_device.cuh's (gs_coefs / apply_coefs,
// restrict_at, prolong_at) in the twin's operand order, compiled with
// --fmad=false and with the true division, so the result is the twin's to
// the last bit.
//
// bf16 storage (dtype 2), the TPU kernel's contract for a bf16 hierarchy
// (pallas_vcycle.py:118-125): the kernel is templated on a storage type S
// and a compute type T. The bf16 instantiation loads bf16 and widens it to
// float, keeps the coefficients, the shared iterate and the residual in
// float across the half-steps, and rounds once, to nearest even, on the
// store of x and of r (the coarse r of the restriction form). Its bytes are
// half the float kernel's; its registers and shared memory are the float
// kernel's, so it takes the float kernel's block shapes. The restriction's
// weights are loaded directly (cp.async copies 4 bytes at least). The float
// and double instantiations (S = T) compile to what they were.
#include <cuda_pipeline.h>

#include "bf16.cuh"
#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kMaxHalo = 8;

enum Mode { kPlain = 0, kResidual = 1, kRestrict = 2 };

// operands in the storage type S
template <typename S>
struct SmoothArgs {
  Level<S> op;
  const S* b;
  const S* x0;        // null: start from zero
  WeightPlanes<S> tr; // restriction / prolongation weights
  const S* ec;        // coarse error for the prologue, or null
  S* x_out;           // (N, M)
  S* r_out;           // residual (N, M) or restricted residual (Nc, Mc)
  unsigned colors;    // bit s set: half-step s updates red points
  int n_colors;
  int halo;
};

// the operands of one thread's points of one colour: coefficients and b
template <typename T, int NC, int P>
struct Points {
  T a[P][NC];
  T b[P];
};

// p[(i, j)] widened to the compute type, zero outside the (N, M) grid
template <typename S>
__device__ __forceinline__ typename Compute<S>::type ldw(const S* p, int i, int j, int N, int M) {
  using T = typename Compute<S>::type;
  return (i >= 0 && i < N && j >= 0 && j < M) ? widen(p[(size_t)i * M + j]) : T(0);
}

template <typename S, typename T, int NC, int MODE, bool EC, int BX, int BY, int P, int MINB>
__global__ void __launch_bounds__(BX * BY, MINB) fused_smooth_kernel(SmoothArgs<S> A) {
  constexpr int NT = BX * BY, RJ = 2 * BX, RI = BY * P;
  constexpr int KQ = (P + 1) / 2;   // coarse rows a thread restricts
  static_assert(P <= 4, "lims packs 2 P limits of 4 bits into 32 bits");
  // the iterate, with a zero guard row (and one word) on each side, so that
  // every neighbour of every region point is in bounds
  __shared__ T xs_raw[RI * RJ + 2 * (RJ + 1)];
  T* const xs = xs_raw + RJ + 1;
  // the restriction phase's residual on the region (same layout as xs) and
  // its weights, 8 per coarse point of each thread (slot (q, w) of thread t
  // at (8 q + w) * threads + t)
  constexpr bool kR = MODE == kRestrict;
  __shared__ T rs[kR ? RI * RJ : 1];
  __shared__ T ws[kR ? 8 * KQ * NT : 1];
  // region point (ri, rj): row ri, column parity rj & 1, half-column rj >> 1
  auto X = [&](int ri, int rj) -> T& { return xs[ri * RJ + (rj & 1) * BX + (rj >> 1)]; };

  const int N = A.op.N, M = A.op.M, H = A.halo;
  const int TI = RI - 2 * H, TJ = RJ - 2 * H;   // the output tile
  const int ti0 = blockIdx.y * TI, tj0 = blockIdx.x * TJ;
  const int gi0 = ti0 - H, gj0 = tj0 - H;        // the region's origin
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  // thread (tx, ty) owns the column pair (2 tx, 2 tx + 1) of the rows
  // P ty + p; col(p, ci) is the column in the pair of its red (ci = 0) or
  // black (ci = 1) point in row p
  auto row = [&](int p) { return P * ty + p; };
  const int c_red0 = (gi0 + P * ty + gj0) & 1;
  auto col = [&](int p, int ci) { return c_red0 ^ (p & 1) ^ ci; };
  auto in_level = [&](int ri, int rj) {
    const int gi = gi0 + ri, gj = gj0 + rj;
    return gi >= 0 && gi < N && gj >= 0 && gj < M;
  };
  auto offset = [&](int ri, int rj) { return (size_t)(gi0 + ri) * M + (gj0 + rj); };

  // the restriction's weights of this thread's coarse points (k, l), at the
  // positions restrict_at reads them, copied into shared memory (in flight
  // during the half-steps)
  const int l_c = tj0 / 2 + tx;
  if (MODE == kRestrict) {
    const int Nc = A.tr.Nc, Mc = A.tr.Mc;
    auto copy = [&](int q, int w, int k, int l) {
      const bool in = k >= 0 && k < Nc && l >= 0 && l < Mc;
      if constexpr (sizeof(S) == sizeof(T))
        __pipeline_memcpy_async(&ws[(q * 8 + w) * NT + tid], A.tr.w[w] + (in ? (size_t)k * Mc + l : 0),
                                sizeof(T), in ? 0 : sizeof(T));
      else
        ws[(q * 8 + w) * NT + tid] = ldw(A.tr.w[w], k, l, Nc, Mc);
    };
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int k = ti0 / 2 + ty + BY * q;
      copy(q, kPW, k, l_c);
      copy(q, kPE, k - 1, l_c);
      copy(q, kPS, k, l_c);
      copy(q, kPN, k, l_c - 1);
      copy(q, kPSW, k, l_c);
      copy(q, kPSE, k - 1, l_c);
      copy(q, kPNW, k, l_c - 1);
      copy(q, kPNE, k - 1, l_c - 1);
    }
    __pipeline_commit();
  }

  // the initial iterate x0 (+ P ec), zero off the level
  for (int e = tid; e < RJ + 1; e += NT) xs_raw[e] = xs[RI * RJ + e] = T(0);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ri = row(p);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int rj = 2 * tx + c;
      T v = T(0);
      if (in_level(ri, rj)) {
        if (A.x0) v = widen(__ldg(A.x0 + offset(ri, rj)));
        if (EC) {
          const int Nc = A.tr.Nc, Mc = A.tr.Mc;
          const S* ec = A.ec;
          auto E = [&](int k, int l) { return ldw(ec, k, l, Nc, Mc); };
          auto W = [&](int q, int k, int l) { return ldw(A.tr.w[q], k, l, Nc, Mc); };
          v = v + prolong_at<T>(gi0 + ri, gj0 + rj, E, W);
        }
      }
      X(ri, rj) = v;
    }
  }

  // this thread's operands, loaded once into registers (zero off the level
  // and on the outermost ring, which is only read), and for each point
  // (p, ci) lim = H + 1 - (its rings outside the tile), 0 off the level, in
  // the 4 bits of lims at 4 (2 p + ci): half-step s updates it if
  // s < lim - 1; it lies on the tile if lim = H + 1
  Points<T, NC, P> red, black;
  unsigned lims = 0;
  auto lim = [&](int p, int ci) { return (int)(lims >> (4 * (2 * p + ci))) & 15; };
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ri = row(p);
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      Points<T, NC, P>& pt = ci == 0 ? red : black;
      const int rj = 2 * tx + col(p, ci);
      const int di = max(max(H - ri, ri - (H + TI - 1)), 0);
      const int dj = max(max(H - rj, rj - (H + TJ - 1)), 0);
      const int l = in_level(ri, rj) ? H + 1 - max(di, dj) : 0;
      lims |= (unsigned)l << (4 * (2 * p + ci));
      const bool used = l > 1;
      const size_t o = used ? offset(ri, rj) : 0;
#pragma unroll
      for (int k = 0; k < NC; ++k) pt.a[p][k] = used ? widen(__ldg(A.op.a[k] + o)) : T(0);
      pt.b[p] = used ? widen(__ldg(A.b + o)) : T(0);
    }
  }
  __syncthreads();

  // the iterate around a point: its own index in xs and that of its row's
  // other-colour point on its left (the right one is the next word), so
  // that every neighbour (di, dj) is a fixed offset
  auto around = [&](int p, int c) {
    const int base = row(p) * RJ;
    const int self = base + c * BX + tx, left = base + (c ^ 1) * BX + tx - (c == 0);
    return [xs, self, left](int di, int dj) -> T& {
      return xs[(dj == 0 ? self : left + (dj > 0)) + di * RJ];
    };
  };
  // half-step s updates the active colour on the rings <= H - 1 - s: the
  // points whose value a later half-step or the epilogue still reads. A
  // thread with any such point computes the new values of all its points
  // of the colour (so that their chains overlap) before it stores those it
  // updates
  auto half_step = [&](const Points<T, NC, P>& pt, int ci, int s) {
    bool any = false;
#pragma unroll
    for (int p = 0; p < P; ++p) any |= s < lim(p, ci) - 1;
    T v[P];
    if (any) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        v[p] = gs_coefs<T, NC>([&](int k) { return pt.a[p][k]; }, 0, 0, pt.b[p], around(p, col(p, ci)));
    }
    if (NC == 9) __syncthreads();
    if (any) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (s < lim(p, ci) - 1) around(p, col(p, ci))(0, 0) = v[p];
    }
    __syncthreads();
  };
  for (int s = 0; s < A.n_colors; ++s) {
    if ((A.colors >> s) & 1u) half_step(red, 0, s);
    else half_step(black, 1, s);
  }

  // the smoothed iterate on the tile, and the residual where it is needed:
  // on the tile (MODE kResidual, stored) or the tile and one ring
  // (kRestrict, into rs; zero off the level and beyond the ring)
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const Points<T, NC, P>& pt = ci == 0 ? red : black;
      const int c = col(p, ci);
      auto Xn = around(p, c);
      const int l = lim(p, ci);
      T r = T(0);
      if (MODE != kPlain && l >= (MODE == kRestrict ? H : H + 1))
        r = pt.b[p] - apply_coefs<T, NC>([&](int k) { return pt.a[p][k]; }, 0, 0, Xn);
      if (MODE == kRestrict) rs[&Xn(0, 0) - xs] = r;
      if (l == H + 1) {
        const size_t o = offset(row(p), 2 * tx + c);
        put(A.x_out + o, Xn(0, 0));
        if (MODE == kResidual) put(A.r_out + o, r);
      }
    }
  }
  if (MODE != kRestrict) return;

  // each coarse point whose injection point (2k, 2l) lies on the tile
  __pipeline_wait_prior(0);
  __syncthreads();
  auto Rs = [&](int i, int j) {
    const int ri = i - gi0, rj = j - gj0;
    return rs[ri * RJ + (rj & 1) * BX + (rj >> 1)];
  };
  if (tx < TJ / 2 && l_c < A.tr.Mc) {
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int kk = ty + BY * q, k = ti0 / 2 + kk;
      if (kk < TI / 2 && k < A.tr.Nc)
        put(A.r_out + (size_t)k * A.tr.Mc + l_c,
            restrict_at<T>(k, l_c, Rs, [&](int w, int, int) { return ws[(8 * q + w) * NT + tid]; }));
    }
  }
}

// one launch with a BX x BY thread block over a region of (BY * P) x
// (2 * BX) points, at least MINB blocks resident on an SM
template <typename S, int NC, int MODE, bool EC, int BX, int BY, int P, int MINB>
cudaError_t launch_kernel(const SmoothArgs<S>& a, cudaStream_t s) {
  using T = typename Compute<S>::type;
  const int TI = BY * P - 2 * a.halo, TJ = 2 * BX - 2 * a.halo;
  const dim3 grid((a.op.M + TJ - 1) / TJ, (a.op.N + TI - 1) / TI), block(BX, BY);
  fused_smooth_kernel<S, T, NC, MODE, EC, BX, BY, P, MINB><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename S, int NC, int BX, int BY, int P, int MINB>
cudaError_t launch_shape(const SmoothArgs<S>& a, int mode, cudaStream_t s) {
  if (mode == kPlain && !a.ec) return launch_kernel<S, NC, kPlain, false, BX, BY, P, MINB>(a, s);
  if (mode == kPlain) return launch_kernel<S, NC, kPlain, true, BX, BY, P, MINB>(a, s);
  if (mode == kResidual) return launch_kernel<S, NC, kResidual, false, BX, BY, P, MINB>(a, s);
  return launch_kernel<S, NC, kRestrict, false, BX, BY, P, MINB>(a, s);
}

// levels of at least this many points are "large" (the bench's 1026^2; its
// 513^2 and 257^2 are not)
constexpr long kLargeLevel = 600L * 600;

// The block shape is chosen from the level's size and the variant, each
// the fastest of the shapes tried at the bench V-cycle's launches on an
// H100. On a large (5-point) level: the restriction phase takes 256
// threads with four rows each over a 32 x 64 region (96 registers, two
// blocks an SM), the other phases 512 threads with two rows each over the
// same region (64 registers, two blocks an SM). On a smaller (9-point)
// level: the restriction phase takes the 512-thread shape, the others 256
// threads over a 32 x 32 region (more, smaller blocks for the 132 SMs).
// f64 always takes the 32 x 32 region (its registers and shared memory are
// twice f32's). bf16 storage computes in float, so it takes f32's shapes
// (same registers and shared memory).
template <typename S, int NC>
cudaError_t dispatch(const SmoothArgs<S>& a, int mode, cudaStream_t s) {
  if constexpr (sizeof(typename Compute<S>::type) == 4) {
    const bool large = (long)a.op.N * a.op.M >= kLargeLevel;
    if (large && mode == kRestrict) return launch_kernel<S, NC, kRestrict, false, 32, 8, 4, 2>(a, s);
    if (large || mode == kRestrict) return launch_shape<S, NC, 32, 16, 2, 1>(a, mode, s);
  }
  return launch_shape<S, NC, 16, 16, 2, 1>(a, mode, s);
}

template <typename S>
int launch(int ncoef, const void* const* op, const void* b, const void* x0,
           const void* const* tr, const void* ec, int Nc, int Mc, void* x_out,
           void* r_out, int N, int M, unsigned colors, int n_colors, int mode,
           cudaStream_t stream) {
  SmoothArgs<S> a{};
  for (int k = 0; k < ncoef; ++k) a.op.a[k] = static_cast<const S*>(op[k]);
  a.op.N = N;
  a.op.M = M;
  a.b = static_cast<const S*>(b);
  a.x0 = static_cast<const S*>(x0);
  if (tr)
    for (int q = 0; q < 8; ++q) a.tr.w[q] = static_cast<const S*>(tr[q]);
  a.tr.Nc = Nc;
  a.tr.Mc = Mc;
  a.ec = static_cast<const S*>(ec);
  a.x_out = static_cast<S*>(x_out);
  a.r_out = static_cast<S*>(r_out);
  a.colors = colors;
  a.n_colors = n_colors;
  a.halo = n_colors + (mode == kRestrict ? 2 : mode == kResidual ? 1 : 0);
  if (a.halo > kMaxHalo || (ec && mode != kPlain) || (mode == kRestrict && !tr) ||
      (ec && !tr) || (mode != kPlain && !r_out) || (ncoef != 5 && ncoef != 9))
    return cudaErrorInvalidValue;
  return ncoef == 5 ? dispatch<S, 5>(a, mode, stream) : dispatch<S, 9>(a, mode, stream);
}

}  // namespace
}  // namespace fs

// One smoothing phase. op: ncoef (5 or 9) planes (N, M); b, x0 (or null):
// (N, M); tr: 8 weight planes (Nc, Mc) or null; ec: (Nc, Mc) or null.
// mode 0: x only (with the ec prologue if ec is given); 1: also r_out =
// b - A x (N, M); 2: also r_out = P^T (b - A x) (Nc, Mc). Half-step s
// updates red points ((i + j) even) if bit s of colors is set, else black.
// dtype 0 = float, 1 = double, 2 = bf16 storage with float arithmetic.
// Returns a cudaError_t (0 = launched).
extern "C" int fs_fused_smooth(int dtype, int ncoef, const void* const* op, const void* b,
                               const void* x0, const void* const* tr, const void* ec,
                               int Nc, int Mc, void* x_out, void* r_out, int N, int M,
                               unsigned colors, int n_colors, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return fs::launch<float>(ncoef, op, b, x0, tr, ec, Nc, Mc, x_out, r_out, N, M, colors,
                               n_colors, mode, s);
    case 1:
      return fs::launch<double>(ncoef, op, b, x0, tr, ec, Nc, Mc, x_out, r_out, N, M, colors,
                                n_colors, mode, s);
    case 2:
      return fs::launch<__nv_bfloat16>(ncoef, op, b, x0, tr, ec, Nc, Mc, x_out, r_out, N, M,
                                       colors, n_colors, mode, s);
    default:
      return cudaErrorInvalidValue;
  }
}
