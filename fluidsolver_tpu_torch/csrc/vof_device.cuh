// PLIC geometry shared by the ELVIRA and curvature kernels: the per-element
// functions of fluidsolver_tpu_torch/vof/plic.py, in the same operand order.
//
// Every constant that the Python code forms from Python floats (w * h,
// w + eps, 4 (w + h), ...) is formed here in double and rounded once to T,
// as a Python float is rounded when it meets a tensor. The library is built
// with --fmad=false, so no product is fused into a sum: with IEEE division
// and square root, each value is the one the plain PyTorch version computes
// with one kernel per operation.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fs {
namespace vof {

constexpr double kDegEps = 1e-12;  // plic._DEG_EPS

// 1e-300 in T: the bound below which segment_endpoints treats an edge as
// parallel to the line; it rounds to 0 in float
template <typename T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ float tiny<float>() { return 0.0f; }
template <>
__device__ __forceinline__ double tiny<double>() { return 1e-300; }

// The cell size and the constants derived from it.
template <typename T>
struct Cell {
  T w, h;         // dx, dy
  T wh;           // w * h
  T neg_eps;      // -eps_rel * max(w, h)
  T w_eps, h_eps; // w + eps, h + eps
  T big;          // 4 (w + h)
  T two_w, two_h; // 2 w, 2 h

  static Cell make(double w, double h) {
    const double eps = 1e-6 * (w > h ? w : h);
    Cell c;
    c.w = T(w);
    c.h = T(h);
    c.wh = T(w * h);
    c.neg_eps = T(-eps);
    c.w_eps = T(w + eps);
    c.h_eps = T(h + eps);
    c.big = T(4.0 * (w + h));
    c.two_w = T(2.0 * w);
    c.two_h = T(2.0 * h);
    return c;
  }
};

template <typename T>
__device__ __forceinline__ T max0(T x) { return x > T(0) ? x : T(0); }
template <typename T>
__device__ __forceinline__ T min0(T x) { return x < T(0) ? x : T(0); }
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  x = x > lo ? x : lo;
  return x < hi ? x : hi;
}

// Area of {a x + b y <= c} in [0,w]x[0,h] for a, b >= 0 (plic._pos_area).
template <typename T>
__device__ __forceinline__ T pos_area(T a, T b, T c, const Cell<T>& g) {
  const T aw = a * g.w;
  const T bh = b * g.h;
  const T scale = aw + bh;
  const bool a_deg = aw <= T(kDegEps) * scale;
  const bool b_deg = bh <= T(kDegEps) * scale;
  const T ab = (a_deg || b_deg) ? T(1) : a * b;
  const T p0 = max0(c);
  const T p1 = max0(c - aw);
  const T p2 = max0(c - bh);
  const T p3 = max0(c - aw - bh);
  const T area_gen = (p0 * p0 - p1 * p1 - p2 * p2 + p3 * p3) / (T(2) * ab);
  const T safe_b = b_deg ? T(1) : b;
  const T safe_a = a_deg ? T(1) : a;
  const T area_a0 = g.w * clamp(c / safe_b, T(0), g.h);
  const T area_b0 = g.h * clamp(c / safe_a, T(0), g.w);
  const T area_both = c >= T(0) ? g.wh : T(0);
  return (a_deg && b_deg) ? area_both : a_deg ? area_a0 : b_deg ? area_b0 : area_gen;
}

// Fraction of the cell under {nx x + ny y <= d} (plic.area_fraction).
template <typename T>
__device__ __forceinline__ T area_fraction(T nx, T ny, T d, const Cell<T>& g) {
  const T c = d - min0(nx) * g.w - min0(ny) * g.h;
  return pos_area(fabs(nx), fabs(ny), c, g) / g.wh;
}

// The d with area_fraction(nx, ny, d) == frac (plic.plane_constant).
template <typename T>
__device__ __forceinline__ T plane_constant(T nx, T ny, T frac, const Cell<T>& g) {
  frac = clamp(frac, T(0), T(1));
  const T a = fabs(nx);
  const T b = fabs(ny);
  const T aw = a * g.w;
  const T bh = b * g.h;
  const T scale = aw + bh;
  const bool a_deg = aw <= T(kDegEps) * scale;
  const bool b_deg = bh <= T(kDegEps) * scale;

  const T A = frac * g.w * g.h;
  const T n1 = aw < bh ? aw : bh;
  const T n2 = aw > bh ? aw : bh;
  const T ab = (a_deg || b_deg) ? T(1) : a * b;
  const T A_tri = n1 * n1 / (T(2) * ab);

  const T c_tri = sqrt(max0(T(2) * ab * A));
  const T safe_n1 = n1 <= T(0) ? T(1) : n1;
  const T c_mid = A * ab / safe_n1 + T(0.5) * n1;
  const T c_top = (n1 + n2) - sqrt(max0(T(2) * ab * (g.wh - A)));
  T c = A <= A_tri ? c_tri : (A <= g.wh - A_tri ? c_mid : c_top);

  const T safe_b = b_deg ? T(1) : b;
  const T safe_a = a_deg ? T(1) : a;
  if (a_deg && !b_deg) c = frac * g.h * safe_b;
  if (b_deg && !a_deg) c = frac * g.w * safe_a;
  if (a_deg && b_deg) c = frac > T(0.5) ? T(1) : T(-1);
  return c + min0(nx) * g.w + min0(ny) * g.h;
}

// The PLIC line's segment in the cell (plic.segment_endpoints_vals): the
// crossings with the 4 edges that lie in the cell (to eps), and of those
// the pair with the largest separation (the first of the 6 pairs on a tie).
template <typename T>
__device__ __forceinline__ void segment_endpoints(T pnx, T pny, T pd, const Cell<T>& g,
                                                  T& x0, T& y0, T& x1, T& y1) {
  // edge k runs from corner k to corner k+1: (0,0) (w,0) (w,h) (0,h)
  const T cx[4] = {T(0), g.w, g.w, T(0)};
  const T cy[4] = {T(0), T(0), g.h, g.h};
  const T ex[4] = {g.w, T(0), -g.w, T(0)};   // x1 - x0 of edge k
  const T ey[4] = {T(0), g.h, T(0), -g.h};   // y1 - y0 of edge k
  T px[4], py[4];
  bool ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    const T d0 = pnx * cx[k] + pny * cy[k] - pd;
    const T d1 = pnx * cx[k1] + pny * cy[k1] - pd;
    const T denom = d0 - d1;
    const T t = fabs(denom) > tiny<T>() ? d0 / (denom == T(0) ? T(1) : denom) : g.big;
    px[k] = cx[k] + t * ex[k];
    py[k] = cy[k] + t * ey[k];
    ok[k] = (px[k] >= g.neg_eps) && (px[k] <= g.w_eps) && (py[k] >= g.neg_eps) && (py[k] <= g.h_eps);
  }
  T best = T(0);
  bool first = true;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      const T dxab = px[a] - px[b];
      const T dyab = py[a] - py[b];
      T d2 = dxab * dxab + dyab * dyab;
      d2 = (ok[a] && ok[b]) ? d2 : T(-1);
      if (first || d2 > best) {
        best = d2;
        x0 = px[a];
        y0 = py[a];
        x1 = px[b];
        y1 = py[b];
        first = false;
      }
    }
  }
}

}  // namespace vof
}  // namespace fs
