// Device functions shared by the BoxMG kernels (fused_rap.cu,
// fused_smooth.cu, tail.cu).
//
// Array conventions follow fluidsolver_tpu_torch/poisson/boxmg.py: a level
// is an (N, M) row-major grid (axis 0 = i, axis 1 = j contiguous); an
// operator is 5 or 9 coefficient planes in Stencil9 order
// (aC, aL, aR, aB, aT, aSW, aSE, aNW, aNE); transfer weights are 8 coarse
// planes in BoxTransfer order (pW, pE, pS, pN, pSW, pSE, pNW, pNE). Reads
// outside a level are zero, as in the PyTorch and XLA versions.
//
// Every expression keeps the operand order of the PyTorch version, and the
// library is compiled with --fmad=false, so the kernels round like the
// plain version (a mul+add is never contracted into an FMA).
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace fs {

constexpr int kMaxTailLevels = 6;

// coefficient offsets in Stencil9 order:
// aC (0,0) aL (-1,0) aR (1,0) aB (0,-1) aT (0,1) aSW (-1,-1) aSE (1,-1)
// aNW (-1,1) aNE (1,1)
__host__ __device__ constexpr int off_i(int k) {
  return (k == 1 || k == 5 || k == 7) ? -1 : (k == 2 || k == 6 || k == 8) ? 1 : 0;
}
__host__ __device__ constexpr int off_j(int k) {
  return (k == 3 || k == 5 || k == 6) ? -1 : (k == 4 || k == 7 || k == 8) ? 1 : 0;
}
// inverse: Stencil9 index of offset (di, dj)
__host__ __device__ constexpr int coef_index(int di, int dj) {
  return di == 0 ? (dj == 0 ? 0 : dj < 0 ? 3 : 4)
       : di < 0  ? (dj == 0 ? 1 : dj < 0 ? 5 : 7)
                 : (dj == 0 ? 2 : dj < 0 ? 6 : 8);
}

enum { kPW = 0, kPE, kPS, kPN, kPSW, kPSE, kPNW, kPNE, kOne = -1 };

template <typename T>
struct Level {
  const T* a[9];   // coefficient planes (corners unused for 5-point)
  int N, M;
};

// p[o]; kL2: through L2 only (__ldcg), for values that other blocks of the
// same launch write (an SM's L1 is not kept coherent with them)
template <typename T, bool kL2 = false, typename I>
__device__ __forceinline__ T ldo(const T* p, I o) {
  if constexpr (kL2) return __ldcg(p + o);
  else return p[o];
}

template <typename T, bool kL2 = false>
__device__ __forceinline__ T ld(const T* p, int i, int j, int N, int M) {
  return (i >= 0 && i < N && j >= 0 && j < M) ? ldo<T, kL2>(p, (size_t)i * M + j) : T(0);
}

template <typename T>
__device__ __forceinline__ T safe(T d) { return d == T(0) ? T(1) : d; }

// ---- operator application ---------------------------------------------------
// (A x)(i, j) for a point inside the level; C(k) returns the point's
// coefficient k, X(i, j) the current iterate (zero outside the level).
template <typename T, int NC, typename CAcc, typename XAcc>
__device__ __forceinline__ T apply_coefs(CAcc C, int i, int j, XAcc X) {
  T acc = C(0) * X(i, j);
#pragma unroll
  for (int k = 1; k < NC; ++k) acc = acc + C(k) * X(i + off_i(k), j + off_j(k));
  return acc;
}

// Gauss-Seidel value of one point: (b - (A x - aC x)) / safe(aC)
template <typename T, int NC, typename CAcc, typename XAcc>
__device__ __forceinline__ T gs_coefs(CAcc C, int i, int j, T b, XAcc X) {
  const T c = C(0);
  const T ax_off = apply_coefs<T, NC>(C, i, j, X) - c * X(i, j);
  return (b - ax_off) / safe(c);
}

// the same with the coefficients read from the level's planes at offset o
template <typename T, int NC, typename XAcc>
__device__ __forceinline__ T apply_at(const Level<T>& L, size_t o, int i, int j, XAcc X) {
  return apply_coefs<T, NC>([&](int k) { return L.a[k][o]; }, i, j, X);
}

template <typename T, int NC, typename XAcc>
__device__ __forceinline__ T gs_value(const Level<T>& L, size_t o, int i, int j, T b, XAcc X) {
  return gs_coefs<T, NC>([&](int k) { return L.a[k][o]; }, i, j, b, X);
}

// ---- operator-collapsed weights (boxmg.collapse_weights) --------------------
// the coefficients of fine point o: c[0..4], and c[5..8] for a 9-point
// operator (zero for a 5-point one)
template <typename T, int NC, bool kL2>
__device__ __forceinline__ void coefs_at(const Level<T>& L, size_t o, T c[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) c[k] = k < NC ? ldo<T, kL2>(L.a[k], o) : T(0);
}

// line weights of a fine point from its coefficients a: x-line
// (pW_full, pE_full) and y-line (pS_full, pN_full)
template <typename T>
__device__ __forceinline__ void line_x_of(const T a[9], T& pW, T& pE) {
  const T c = a[0], w = a[1], e = a[2], s = a[3], n = a[4];
  const T asw = a[5], ase = a[6], anw = a[7], ane = a[8];
  const T den = safe(c + n + s);
  pW = -(w + anw + asw) / den;
  pE = -(e + ane + ase) / den;
}

template <typename T>
__device__ __forceinline__ void line_y_of(const T a[9], T& pS, T& pN) {
  const T c = a[0], w = a[1], e = a[2], s = a[3], n = a[4];
  const T asw = a[5], ase = a[6], anw = a[7], ane = a[8];
  const T den = safe(c + w + e);
  pS = -(s + asw + ase) / den;
  pN = -(n + anw + ane) / den;
}

// the same of fine point (i, j) of L; zero outside the level. kL2: the
// level's planes are read through L2 only (ldo).
template <typename T, int NC, bool kL2 = false>
__device__ __forceinline__ void line_x(const Level<T>& L, int i, int j, T& pW, T& pE) {
  if (i < 0 || i >= L.N || j < 0 || j >= L.M) { pW = pE = T(0); return; }
  T a[9];
  coefs_at<T, NC, kL2>(L, (size_t)i * L.M + j, a);
  line_x_of(a, pW, pE);
}

template <typename T, int NC, bool kL2 = false>
__device__ __forceinline__ void line_y(const Level<T>& L, int i, int j, T& pS, T& pN) {
  if (i < 0 || i >= L.N || j < 0 || j >= L.M) { pS = pN = T(0); return; }
  T a[9];
  coefs_at<T, NC, kL2>(L, (size_t)i * L.M + j, a);
  line_y_of(a, pS, pN);
}

// the corner weights w[kPSW..kPNE] of a coarse point from the coefficients
// a of fine (2k+1, 2l+1), its line weights w[kPW..kPN] (those of fine
// (2k+1, 2l) and (2k, 2l+1)) and the line weights at the other two
// neighbours of (2k+1, 2l+1): (pS_b, pN_b) of (2k+2, 2l+1) and (pW_b, pE_b)
// of (2k+1, 2l+2)
template <typename T>
__device__ __forceinline__ void corners_of(const T a[9], T pS_b, T pN_b, T pW_b, T pE_b, T w[8]) {
  const T c = a[0], we = a[1], e = a[2], s = a[3], n = a[4];
  const T asw = a[5], ase = a[6], anw = a[7], ane = a[8];
  const T pS_a = w[kPS], pN_a = w[kPN], pW_a = w[kPW], pE_a = w[kPE];
  const T cden = safe(c);
  const T vSW = asw + we * pS_a + s * pW_a;
  const T vSE = ase + e * pS_b + s * pE_a;
  const T vNW = anw + we * pN_a + n * pW_b;
  const T vNE = ane + e * pN_b + n * pE_b;
  w[kPSW] = -vSW / cden;
  w[kPSE] = -vSE / cden;
  w[kPNW] = -vNW / cden;
  w[kPNE] = -vNE / cden;
}

// all 8 weights of coarse point (k, l); zero outside the coarse grid and
// where the defining fine point lies beyond the level (boxmg._pad_to)
template <typename T, int NC, bool kL2 = false>
__device__ void collapse_point(const Level<T>& L, int k, int l, T w[8]) {
  const int Nc = (L.N + 1) / 2, Mc = (L.M + 1) / 2;
#pragma unroll
  for (int q = 0; q < 8; ++q) w[q] = T(0);
  if (k < 0 || k >= Nc || l < 0 || l >= Mc) return;
  line_x<T, NC, kL2>(L, 2 * k + 1, 2 * l, w[kPW], w[kPE]);
  line_y<T, NC, kL2>(L, 2 * k, 2 * l + 1, w[kPS], w[kPN]);
  const int i = 2 * k + 1, j = 2 * l + 1;
  if (i >= L.N || j >= L.M) return;   // (odd, odd) point beyond the level
  T a[9];
  coefs_at<T, NC, kL2>(L, (size_t)i * L.M + j, a);
  // line weights at the other two neighbours of (i, j)
  T pS_b, pN_b, pW_b, pE_b;
  line_y<T, NC, kL2>(L, i + 1, j, pS_b, pN_b);
  line_x<T, NC, kL2>(L, i, j + 1, pW_b, pE_b);
  corners_of(a, pS_b, pN_b, pW_b, pE_b, w);
}

// ---- closed-form Galerkin product (boxmg.galerkin_closed) -------------------
// P entries per fine parity class pc = a + 2 b, in the enumeration order of
// boxmg._P_ENTRIES: fine (2k+a, 2l+b) <- coarse (k+sI, l+sJ) with weight w
struct PEntry { int sI, sJ, w; };
__host__ __device__ constexpr int p_count(int pc) { return pc == 0 ? 1 : pc == 3 ? 4 : 2; }
__host__ __device__ constexpr PEntry p_entry(int pc, int e) {
  return pc == 0 ? PEntry{0, 0, kOne}
       : pc == 1 ? (e == 0 ? PEntry{0, 0, kPW} : PEntry{1, 0, kPE})
       : pc == 2 ? (e == 0 ? PEntry{0, 0, kPS} : PEntry{0, 1, kPN})
       : (e == 0 ? PEntry{0, 0, kPSW} : e == 1 ? PEntry{1, 0, kPSE}
          : e == 2 ? PEntry{0, 1, kPNW} : PEntry{1, 1, kPNE});
}

// the 9 coarse coefficients of coarse point (K, L) of a level of N x M fine
// points; A(k, i, j) is coefficient k of fine point (i, j), zero outside the
// level, and W(q, kk, ll) weight q at coarse (kk, ll), zero outside the
// coarse grid. Only the coefficients q with bit q of kMask set are formed
// (each one's sum in the same order); the others stay 0.
template <typename T, int NC, unsigned kMask = 0x1ffu, typename AAcc, typename WAcc>
__device__ __forceinline__ void rap_from(AAcc A, int N, int M, int K, int Lc, WAcc W, T out[9]) {
  const int Nc = (N + 1) / 2, Mc = (M + 1) / 2;
  T acc[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q] = T(0);
#pragma unroll
  for (int pc = 0; pc < 4; ++pc) {
    const int a1 = pc & 1, b1 = pc >> 1;
#pragma unroll
    for (int e1 = 0; e1 < 4; ++e1) {
      if (e1 >= p_count(pc)) break;
      const PEntry p1 = p_entry(pc, e1);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int di = off_i(k), dj = off_j(k);
        const int a2 = (a1 + di + 2) & 1, b2 = (b1 + dj + 2) & 1;
        const int pc2 = a2 + 2 * b2;
        const int g1 = -p1.sI, d1 = -p1.sJ;
        const int alpha = a1 - 2 * p1.sI, beta = b1 - 2 * p1.sJ;
        const int g2 = -p1.sI + (a1 + di - a2) / 2;
        const int d2 = -p1.sJ + (b1 + dj - b2) / 2;
        const T av = A(k, 2 * K + alpha, 2 * Lc + beta);
        const T w1 = p1.w == kOne ? T(1) : W(p1.w, K + g1, Lc + d1);
#pragma unroll
        for (int e2 = 0; e2 < 4; ++e2) {
          if (e2 >= p_count(pc2)) break;
          const PEntry p2 = p_entry(pc2, e2);
          const int ci = coef_index(g2 + p2.sI, d2 + p2.sJ);
          if (!((kMask >> ci) & 1u)) continue;
          const T w2 = p2.w == kOne ? T(1) : W(p2.w, K + g2, Lc + d2);
          acc[ci] = acc[ci] + (av * w1) * w2;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int KK = K + off_i(q), LL = Lc + off_j(q);
    out[q] = (KK >= 0 && KK < Nc && LL >= 0 && LL < Mc) ? acc[q] : T(0);
  }
}

// rap_from on a level's planes in device memory; kL2: F's planes are read
// through L2 only (ldo)
template <typename T, int NC, bool kL2 = false, typename WAcc>
__device__ void rap_point(const Level<T>& F, int K, int Lc, WAcc W, T out[9]) {
  rap_from<T, NC>([&](int k, int i, int j) { return ld<T, kL2>(F.a[k], i, j, F.N, F.M); }, F.N, F.M, K, Lc,
                  W, out);
}

// ---- grid transfers (boxmg.restrict_box / prolong_box) -----------------------
// (P e)(i, j) for fine point (i, j) >= 0; E(k, l) is the coarse error (zero
// beyond the coarse grid), Wt(q, k, l) the weights
template <typename T, typename EAcc, typename WAcc>
__device__ __forceinline__ T prolong_at(int i, int j, EAcc E, WAcc Wt) {
  const int k = i >> 1, l = j >> 1;
  const int pi = i & 1, pj = j & 1;
  if (!pi && !pj) return E(k, l);
  if (pi && !pj) return Wt(kPW, k, l) * E(k, l) + Wt(kPE, k, l) * E(k + 1, l);
  if (!pi && pj) return Wt(kPS, k, l) * E(k, l) + Wt(kPN, k, l) * E(k, l + 1);
  return Wt(kPSW, k, l) * E(k, l) + Wt(kPSE, k, l) * E(k + 1, l)
       + Wt(kPNW, k, l) * E(k, l + 1) + Wt(kPNE, k, l) * E(k + 1, l + 1);
}

// (P^T r)(k, l); R(i, j) is the fine residual (zero outside the level)
template <typename T, typename RAcc, typename WAcc>
__device__ __forceinline__ T restrict_at(int k, int l, RAcc R, WAcc Wt) {
  const int i = 2 * k, j = 2 * l;
  T out = R(i, j);
  out = (out + Wt(kPW, k, l) * R(i + 1, j)) + (k > 0 ? Wt(kPE, k - 1, l) * R(i - 1, j) : T(0));
  out = (out + Wt(kPS, k, l) * R(i, j + 1)) + (l > 0 ? Wt(kPN, k, l - 1) * R(i, j - 1) : T(0));
  out = (out + Wt(kPSW, k, l) * R(i + 1, j + 1))
      + (k > 0 ? Wt(kPSE, k - 1, l) * R(i - 1, j + 1) : T(0));
  out = (out + (l > 0 ? Wt(kPNW, k, l - 1) * R(i + 1, j - 1) : T(0)))
      + (k > 0 && l > 0 ? Wt(kPNE, k - 1, l - 1) * R(i - 1, j - 1) : T(0));
  return out;
}

// weights stored as 8 coarse planes of an (Nc, Mc) grid
template <typename T>
struct WeightPlanes {
  const T* w[8];
  int Nc, Mc;
  __device__ __forceinline__ T operator()(int q, int k, int l) const {
    return ld(w[q], k, l, Nc, Mc);
  }
};

}  // namespace fs
