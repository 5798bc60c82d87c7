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
// (pallas_vcycle.py:118-125): operands stored as bf16, all arithmetic in
// float, x and r rounded once, to nearest even, on the store. The first
// bf16 form ran this kernel on bf16 storage with the float design's shapes
// and float registers: 0.0271 ms at the 1026^2 restriction against a bound
// of 0.0058
// (0.956x the float kernel on half its bytes), held by the same chains as
// the float kernel: its blocks' loads, issued in 2-byte pieces behind a
// stall on the restriction's weights, then four barriers. The bf16 form is
// fused_smooth_bf16_kernel (below): the same map and arithmetic on
// operands packed two to a 4-byte word, which frees registers for more
// resident blocks, with every load issued before any is used. Measured
// (NVIDIA H100 80GB HBM3, 700 W, in turns with the first bf16 form): the
// 1026^2 restriction 0.0233 ms (0.86x), ec 0.0193 (0.83x), one BoxMG
// cycle's 14 launches 0.1308 against 0.1409 ms (0.93x); the 257^2
// restriction 1.06x (PERF.md).
#include <cuda_bf16.h>
#include <cuda_pipeline.h>

#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kMaxHalo = 8;

enum Mode { kPlain = 0, kResidual = 1, kRestrict = 2 };

// operands, stored as S
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

// p[(i, j)], zero outside the (N, M) grid
template <typename T>
__device__ __forceinline__ T ldw(const T* p, int i, int j, int N, int M) {
  return (i >= 0 && i < N && j >= 0 && j < M) ? p[(size_t)i * M + j] : T(0);
}

template <typename T, int NC, int MODE, bool EC, int BX, int BY, int P, int MINB>
__global__ void __launch_bounds__(BX * BY, MINB) fused_smooth_kernel(SmoothArgs<T> A) {
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
      __pipeline_memcpy_async(&ws[(q * 8 + w) * NT + tid], A.tr.w[w] + (in ? (size_t)k * Mc + l : 0),
                              sizeof(T), in ? 0 : sizeof(T));
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
        if (A.x0) v = __ldg(A.x0 + offset(ri, rj));
        if (EC) {
          const int Nc = A.tr.Nc, Mc = A.tr.Mc;
          const T* ec = A.ec;
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
      for (int k = 0; k < NC; ++k) pt.a[p][k] = used ? __ldg(A.op.a[k] + o) : T(0);
      pt.b[p] = used ? __ldg(A.b + o) : T(0);
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
        A.x_out[o] = Xn(0, 0);
        if (MODE == kResidual) A.r_out[o] = r;
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
        A.r_out[(size_t)k * A.tr.Mc + l_c] =
            restrict_at<T>(k, l_c, Rs, [&](int w, int, int) { return ws[(8 * q + w) * NT + tid]; });
    }
  }
}

// ---- bf16 storage (dtype 2) -------------------------------------------------
// A word holds two bf16 values, the lower-addressed one in bits 0-15.
// half_f(w, kLo) and half_f(w, kHi) widen one of them to float (exact).
constexpr unsigned kLo = 0x1044u, kHi = 0x3244u;
__device__ __forceinline__ float half_f(unsigned w, unsigned sel) {
  return __uint_as_float(__byte_perm(w, 0u, sel));
}
__device__ __forceinline__ unsigned short bits_rn(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// a colour (0 red, 1 black) as a compile-time value, or as an int
template <int C> struct Colour {};
template <int C> __device__ __forceinline__ constexpr int colour_of(Colour<C>) { return C; }
__device__ __forceinline__ constexpr int colour_of(int c) { return c; }

// The bf16 form of fused_smooth_kernel: the same thread-to-point map,
// half-steps, lims and arithmetic (so the same bits), on operands held as
// bf16 words. What differs:
// - the region's columns start on an even level column (the column halo HJ
//   is H rounded up to even), so a thread's column pair is one 4-byte word
//   of each plane on every row whose linear start is even (every row of a
//   level of even width, EVEN, and every other row of one of odd width);
// - every load of the block is issued before any loaded value is used: the
//   operands', x0's, the ec prologue's (its four coarse values and the
//   weights its row parity needs, once for the pair) and the restriction's
//   weights (kept in registers and read there by the restriction; no
//   shared copy);
// - with PACKED, a row's red and black coefficients and b stay packed, one
//   word each, and are widened where they are used: NC + 1 registers a row
//   instead of 2 (NC + 1), so that more blocks fit an SM (the large
//   levels); without, they are widened once after the loads (the small
//   levels, where a block's chain is what the time is and nothing hides the
//   extra instructions);
// - x (and the fine residual) are stored as one word where both points of
//   a pair lie on the tile and the word is aligned.
template <int NC, int MODE, bool EC, bool EVEN, bool PACKED, int BX, int BY, int P, int MINB>
__global__ void __launch_bounds__(BX * BY, MINB) fused_smooth_bf16_kernel(SmoothArgs<__nv_bfloat16> A) {
  using U = unsigned short;
  constexpr int NT = BX * BY, RJ = 2 * BX, RI = BY * P;
  constexpr int KQ = (P + 1) / 2;
  static_assert(P % 2 == 0 && P <= 4, "rows of one parity a step of P; lims holds 2 P limits of 4 bits");
  __shared__ float xs_raw[RI * RJ + 2 * (RJ + 1)];
  float* const xs = xs_raw + RJ + 1;
  constexpr bool kR = MODE == kRestrict;
  __shared__ float rs[kR ? RI * RJ : 1];
  auto X = [&](int ri, int rj) -> float& { return xs[ri * RJ + (rj & 1) * BX + (rj >> 1)]; };
  auto raw = [](const __nv_bfloat16* p) { return reinterpret_cast<const U*>(p); };

  const int N = A.op.N, M = A.op.M, H = A.halo, HJ = (H + 1) & ~1;
  const int TI = RI - 2 * H, TJ = RJ - 2 * HJ;   // the output tile
  const int ti0 = blockIdx.y * TI, tj0 = blockIdx.x * TJ;
  const int gi0 = ti0 - H, gj0 = tj0 - HJ;        // the region's origin (gj0 even)
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  auto row = [&](int p) { return P * ty + p; };
  const int c_red0 = (gi0 + gj0) & 1;             // P even: every thread's rows alike
  auto col = [&](int p, int ci) { return c_red0 ^ (p & 1) ^ ci; };
  auto sel = [&](int p, int ci) { return col(p, ci) ? kHi : kLo; };
  auto in_level = [&](int ri, int rj) {
    const int gi = gi0 + ri, gj = gj0 + rj;
    return gi >= 0 && gi < N && gj >= 0 && gj < M;
  };
  // Every load is issued before any loaded value is used (a use waits on
  // its load). The pair (gi, gj), (gi, gj + 1) of a plane, gj even, is
  // loaded as raw words a, b and combined after the last load: on a row
  // whose linear start is even, a is the pair's word (b the first point
  // alone at the level's right edge); on the other rows (odd width, odd
  // row) a and b are the words that end and start at the pair, joined by a
  // byte permutation. With EVEN (the level's width is even) every row is
  // of the first kind and no pair meets the right edge: one load a pair.
  // `in`: the pair's first point lies in the level (and is to be loaded).
  auto ld_pair = [&](const U* p, int gi, int gj, bool in, unsigned& a, unsigned& b) {
    const long long o = (long long)gi * M + gj;
    if constexpr (EVEN) {
      a = in ? __ldg(reinterpret_cast<const unsigned*>(p + o)) : 0u;
    } else {
      const bool in1 = in && gj + 1 < M;
      if (!(o & 1)) {
        a = in1 ? __ldg(reinterpret_cast<const unsigned*>(p + o)) : 0u;
        b = in && !in1 ? (unsigned)__ldg(p + o) : 0u;
      } else {
        a = in ? __ldg(reinterpret_cast<const unsigned*>(p + o - 1)) : 0u;
        b = in1 ? __ldg(reinterpret_cast<const unsigned*>(p + o + 1)) : 0u;
      }
    }
  };
  auto pair_of = [&](int gi, unsigned a, unsigned b) -> unsigned {
    if constexpr (EVEN) return a;
    else return ((long long)gi * M) & 1 ? __byte_perm(a, b, 0x5432) : a | b;
  };
  auto ld1 = [&](const U* p, size_t o, bool in) { return in ? (unsigned)__ldg(p + o) : 0u; };

  // the restriction's weights of this thread's coarse points (k, l), at the
  // positions restrict_at reads them, in the order kPW .. kPNE
  const int l_c = tj0 / 2 + tx;
  unsigned wr[KQ][8];
  if constexpr (MODE == kRestrict) {
    const int Nc = A.tr.Nc, Mc = A.tr.Mc;
    auto wt = [&](int w, int k, int l) {
      return ld1(raw(A.tr.w[w]), (size_t)k * Mc + l, tx < TJ / 2 && k >= 0 && k < Nc && l >= 0 && l < Mc);
    };
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int k = ti0 / 2 + ty + BY * q;
      wr[q][kPW] = wt(kPW, k, l_c);
      wr[q][kPE] = wt(kPE, k - 1, l_c);
      wr[q][kPS] = wt(kPS, k, l_c);
      wr[q][kPN] = wt(kPN, k, l_c - 1);
      wr[q][kPSW] = wt(kPSW, k, l_c);
      wr[q][kPSE] = wt(kPSE, k - 1, l_c);
      wr[q][kPNW] = wt(kPNW, k, l_c - 1);
      wr[q][kPNE] = wt(kPNE, k - 1, l_c - 1);
    }
  }

  // this thread's operands: the words of row p's pair (zero off the level
  // and where neither point is used), and the points' lims as in
  // fused_smooth_kernel (the column distance counted from HJ)
  constexpr int P2 = EVEN ? 1 : P;   // the second raw words (none with EVEN)
  unsigned pa[P][NC], pb[P], pa2[P2][NC], pb2[P2];
  unsigned lims = 0;
  auto lim = [&](int p, int ci) { return (int)(lims >> (4 * (2 * p + ci))) & 15; };
  const int gj = gj0 + 2 * tx;   // the pair's first column
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ri = row(p), q = EVEN ? 0 : p;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int rj = 2 * tx + col(p, ci);
      const int di = max(max(H - ri, ri - (H + TI - 1)), 0);
      const int dj = max(max(HJ - rj, rj - (HJ + TJ - 1)), 0);
      const int l = in_level(ri, rj) ? max(H + 1 - max(di, dj), 0) : 0;
      lims |= (unsigned)l << (4 * (2 * p + ci));
    }
    const bool used = lim(p, 0) > 1 || lim(p, 1) > 1;
#pragma unroll
    for (int k = 0; k < NC; ++k) ld_pair(raw(A.op.a[k]), gi0 + ri, gj, used, pa[p][k], pa2[q][k]);
    ld_pair(raw(A.b), gi0 + ri, gj, used, pb[p], pb2[q]);
  }

  // the initial iterate x0 (+ P ec), zero off the level: the loads of all
  // rows first, then the values
  unsigned x0w[P], x0w2[P2];
  unsigned ecv[P][4], wcv[P][6];   // the ec prologue's coarse values and weights of a row
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int gi = gi0 + row(p);
    const bool in = gi >= 0 && gi < N && gj >= 0 && gj < M;
    ld_pair(raw(A.x0), gi, gj, in && A.x0 != nullptr, x0w[p], x0w2[EVEN ? 0 : p]);
    if constexpr (EC) {
      // prolong_at reads, for the pair (gi, gj) and (gi, gj + 1), the coarse
      // values (k, l), (k, l + 1) and on an odd row (k + 1, l), (k + 1, l +
      // 1); the weights at (k, l): kPS, kPN on an even row, the other six
      // on an odd one
      const int Nc = A.tr.Nc, Mc = A.tr.Mc, k = gi >> 1, l = gj >> 1;
      const bool odd = gi & 1, l1 = l + 1 < Mc, k1 = k + 1 < Nc;
      const size_t o = (size_t)k * Mc + l;
      const U* ec = raw(A.ec);
      ecv[p][0] = ld1(ec, o, in);
      ecv[p][1] = ld1(ec, o + 1, in && l1);
      ecv[p][2] = ld1(ec, o + Mc, in && odd && k1);
      ecv[p][3] = ld1(ec, o + Mc + 1, in && odd && k1 && l1);
      const U* const wodd[6] = {raw(A.tr.w[kPW]), raw(A.tr.w[kPE]), raw(A.tr.w[kPSW]),
                                raw(A.tr.w[kPSE]), raw(A.tr.w[kPNW]), raw(A.tr.w[kPNE])};
      wcv[p][0] = ld1(odd ? wodd[0] : raw(A.tr.w[kPS]), o, in);
      wcv[p][1] = ld1(odd ? wodd[1] : raw(A.tr.w[kPN]), o, in);
#pragma unroll
      for (int q = 2; q < 6; ++q) wcv[p][q] = ld1(wodd[q], o, in && odd);
    }
  }
  // every load is issued: the pairs' words
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int gi = gi0 + row(p), q = EVEN ? 0 : p;
#pragma unroll
    for (int k = 0; k < NC; ++k) pa[p][k] = pair_of(gi, pa[p][k], pa2[q][k]);
    pb[p] = pair_of(gi, pb[p], pb2[q]);
    x0w[p] = pair_of(gi, x0w[p], x0w2[q]);
  }
  // operand k of row p's point of colour ci (k = NC: b), widened
  float wv[PACKED ? 1 : P][2][NC + 1];
  if constexpr (!PACKED) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int ci = 0; ci < 2; ++ci)
#pragma unroll
        for (int k = 0; k <= NC; ++k) wv[p][ci][k] = half_f(k < NC ? pa[p][k] : pb[p], sel(p, ci));
  }
  auto opnd = [&](int p, int ci, int k) -> float {
    if constexpr (PACKED) return half_f(k < NC ? pa[p][k] : pb[p], sel(p, ci));
    else return wv[p][ci][k];
  };
  for (int e = tid; e < RJ + 1; e += NT) xs_raw[e] = xs[RI * RJ + e] = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ri = row(p), gi = gi0 + ri;
    float v0 = half_f(x0w[p], kLo), v1 = half_f(x0w[p], kHi);
    if (EC && gi >= 0 && gi < N && gj >= 0 && gj < M) {
      const int k = gi >> 1, l = gj >> 1;
      const bool odd = gi & 1;
      float wc[8] = {};
      if (odd) {
        wc[kPW] = half_f(wcv[p][0], kLo);
        wc[kPE] = half_f(wcv[p][1], kLo);
        wc[kPSW] = half_f(wcv[p][2], kLo);
        wc[kPSE] = half_f(wcv[p][3], kLo);
        wc[kPNW] = half_f(wcv[p][4], kLo);
        wc[kPNE] = half_f(wcv[p][5], kLo);
      } else {
        wc[kPS] = half_f(wcv[p][0], kLo);
        wc[kPN] = half_f(wcv[p][1], kLo);
      }
      const float e00 = half_f(ecv[p][0], kLo), e01 = half_f(ecv[p][1], kLo);
      const float e10 = half_f(ecv[p][2], kLo), e11 = half_f(ecv[p][3], kLo);
      auto E = [&](int kk, int ll) { return kk == k ? (ll == l ? e00 : e01) : (ll == l ? e10 : e11); };
      auto W = [&](int q, int, int) { return wc[q]; };
      v0 = v0 + prolong_at<float>(gi, gj, E, W);
      if (gj + 1 < M) v1 = v1 + prolong_at<float>(gi, gj + 1, E, W);
    }
    X(ri, 2 * tx) = v0;
    X(ri, 2 * tx + 1) = v1;
  }
  __syncthreads();

  // the iterate around a point (as in fused_smooth_kernel)
  auto around = [&](int p, int c) {
    const int base = row(p) * RJ;
    const int self = base + c * BX + tx, left = base + (c ^ 1) * BX + tx - (c == 0);
    return [xs, self, left](int di, int dj) -> float& {
      return xs[(dj == 0 ? self : left + (dj > 0)) + di * RJ];
    };
  };
  // colour: an int, or a Colour where the operands are widened (!PACKED),
  // so that wv is indexed by constants
  auto half_step = [&](auto colour, int s) {
    const int ci = colour_of(colour);
    bool any = false;
#pragma unroll
    for (int p = 0; p < P; ++p) any |= s < lim(p, ci) - 1;
    float v[P];
    if (any) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        v[p] = gs_coefs<float, NC>([&](int k) { return opnd(p, ci, k); }, 0, 0, opnd(p, ci, NC),
                                   around(p, col(p, ci)));
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
    const int ci = ((A.colors >> s) & 1u) ? 0 : 1;
    if constexpr (PACKED) half_step(ci, s);
    else if (ci == 0) half_step(Colour<0>{}, s);
    else half_step(Colour<1>{}, s);
  }

  // the smoothed iterate on the tile, and the residual where it is needed
  // (as in fused_smooth_kernel); a pair on the tile is stored as one word
  // where it is aligned
  U* const xo = reinterpret_cast<U*>(A.x_out);
  U* const ro = reinterpret_cast<U*>(A.r_out);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // x and r of the pair's columns 0 and 1
    float x0v = 0.0f, x1v = 0.0f, r0v = 0.0f, r1v = 0.0f;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int c = col(p, ci);
      auto Xn = around(p, c);
      const int l = lim(p, ci);
      float r = 0.0f;
      if (MODE != kPlain && l >= (MODE == kRestrict ? H : H + 1))
        r = opnd(p, ci, NC) - apply_coefs<float, NC>([&](int k) { return opnd(p, ci, k); }, 0, 0, Xn);
      if (MODE == kRestrict) rs[&Xn(0, 0) - xs] = r;
      if (c == 0) {
        x0v = Xn(0, 0);
        r0v = r;
      } else {
        x1v = Xn(0, 0);
        r1v = r;
      }
    }
    const long long o = (long long)(gi0 + row(p)) * M + gj;
    const int ci0 = col(p, 0);   // column 0's colour
    const bool on0 = lim(p, ci0) == H + 1, on1 = lim(p, ci0 ^ 1) == H + 1;
    if (on0 && on1 && !(o & 1)) {
      *reinterpret_cast<unsigned*>(xo + o) = (unsigned)bits_rn(x0v) | (unsigned)bits_rn(x1v) << 16;
      if (MODE == kResidual)
        *reinterpret_cast<unsigned*>(ro + o) = (unsigned)bits_rn(r0v) | (unsigned)bits_rn(r1v) << 16;
    } else {
      if (on0) {
        xo[o] = bits_rn(x0v);
        if (MODE == kResidual) ro[o] = bits_rn(r0v);
      }
      if (on1) {
        xo[o + 1] = bits_rn(x1v);
        if (MODE == kResidual) ro[o + 1] = bits_rn(r1v);
      }
    }
  }
  if (MODE != kRestrict) return;

  // each coarse point whose injection point (2k, 2l) lies on the tile
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
        ro[(size_t)k * A.tr.Mc + l_c] = bits_rn(
            restrict_at<float>(k, l_c, Rs, [&](int w, int, int) { return half_f(wr[q][w], kLo); }));
    }
  }
}

template <int NC, int MODE, bool EC, bool PACKED, int BX, int BY, int P, int MINB>
cudaError_t launch_bf16(const SmoothArgs<__nv_bfloat16>& a, cudaStream_t s) {
  const int TI = BY * P - 2 * a.halo, TJ = 2 * BX - 2 * ((a.halo + 1) & ~1);
  const dim3 grid((a.op.M + TJ - 1) / TJ, (a.op.N + TI - 1) / TI), block(BX, BY);
  if (a.op.M % 2 == 0)
    fused_smooth_bf16_kernel<NC, MODE, EC, true, PACKED, BX, BY, P, MINB><<<grid, block, 0, s>>>(a);
  else
    fused_smooth_bf16_kernel<NC, MODE, EC, false, PACKED, BX, BY, P, MINB><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

template <int NC, bool PACKED, int BX, int BY, int P, int MINB>
cudaError_t launch_shape_bf16(const SmoothArgs<__nv_bfloat16>& a, int mode, cudaStream_t s) {
  if (mode == kPlain && !a.ec) return launch_bf16<NC, kPlain, false, PACKED, BX, BY, P, MINB>(a, s);
  if (mode == kPlain) return launch_bf16<NC, kPlain, true, PACKED, BX, BY, P, MINB>(a, s);
  if (mode == kResidual) return launch_bf16<NC, kResidual, false, PACKED, BX, BY, P, MINB>(a, s);
  return launch_bf16<NC, kRestrict, false, PACKED, BX, BY, P, MINB>(a, s);
}

// one launch with a BX x BY thread block over a region of (BY * P) x
// (2 * BX) points, at least MINB blocks resident on an SM
template <typename T, int NC, int MODE, bool EC, int BX, int BY, int P, int MINB>
cudaError_t launch_kernel(const SmoothArgs<T>& a, cudaStream_t s) {
  const int TI = BY * P - 2 * a.halo, TJ = 2 * BX - 2 * a.halo;
  const dim3 grid((a.op.M + TJ - 1) / TJ, (a.op.N + TI - 1) / TI), block(BX, BY);
  fused_smooth_kernel<T, NC, MODE, EC, BX, BY, P, MINB><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int NC, int BX, int BY, int P, int MINB>
cudaError_t launch_shape(const SmoothArgs<T>& a, int mode, cudaStream_t s) {
  if (mode == kPlain && !a.ec) return launch_kernel<T, NC, kPlain, false, BX, BY, P, MINB>(a, s);
  if (mode == kPlain) return launch_kernel<T, NC, kPlain, true, BX, BY, P, MINB>(a, s);
  if (mode == kResidual) return launch_kernel<T, NC, kResidual, false, BX, BY, P, MINB>(a, s);
  return launch_kernel<T, NC, kRestrict, false, BX, BY, P, MINB>(a, s);
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
// twice f32's). bf16 takes dispatch_bf16's shapes.
template <typename T, int NC>
cudaError_t dispatch(const SmoothArgs<T>& a, int mode, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    const bool large = (long)a.op.N * a.op.M >= kLargeLevel;
    if (large && mode == kRestrict) return launch_kernel<T, NC, kRestrict, false, 32, 8, 4, 2>(a, s);
    if (large || mode == kRestrict) return launch_shape<T, NC, 32, 16, 2, 1>(a, mode, s);
  }
  return launch_shape<T, NC, 16, 16, 2, 1>(a, mode, s);
}

// bf16: the fastest of the shapes tried on an H100 at the bench cycle's
// launches. 1026^2: the restriction on 256 threads, four rows each, packed
// operands, three blocks an SM (80 registers); the other forms on 512
// threads, two rows each, two blocks an SM (64 registers). Below: the
// restriction of 513^2 on the 256-thread shape (two blocks an SM), of
// 257^2 on the 512-thread shape with widened operands (one block an SM), of
// the rest and the other forms on 256 threads over 32 x 32 with widened
// operands.
template <int NC>
cudaError_t dispatch_bf16(const SmoothArgs<__nv_bfloat16>& a, int mode, cudaStream_t s) {
  const bool large = (long)a.op.N * a.op.M >= kLargeLevel;
  if (large && mode == kRestrict) return launch_bf16<NC, kRestrict, false, true, 32, 8, 4, 3>(a, s);
  if (large) return launch_shape_bf16<NC, true, 32, 16, 2, 2>(a, mode, s);
  const long n = (long)a.op.N * a.op.M;
  if (mode == kRestrict && n >= 400L * 400) return launch_bf16<NC, kRestrict, false, true, 32, 8, 4, 2>(a, s);
  if (mode == kRestrict && n >= 200L * 200) return launch_bf16<NC, kRestrict, false, false, 32, 16, 2, 1>(a, s);
  return launch_shape_bf16<NC, false, 16, 16, 2, 2>(a, mode, s);
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
  if constexpr (sizeof(S) == 2)
    return ncoef == 5 ? dispatch_bf16<5>(a, mode, stream) : dispatch_bf16<9>(a, mode, stream);
  else
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
