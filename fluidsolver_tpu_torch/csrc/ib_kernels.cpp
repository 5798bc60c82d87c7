// Native host-side kernels: immersed-boundary geometry precompute.
//
// The per-node wall classification + exact circle/line intersection sweeps
// (reference: src/IB.hpp:45-108, examples/SharpIB.cpp:148-271) are O(nx*ny)
// host work at setup; the Python loops become the setup bottleneck at
// production grid sizes (>= 1024^2), so they are implemented here in C++
// and loaded through ctypes (fluidsolver_tpu_torch/ib/_native.py, which
// builds this file with g++ -O3 -fPIC -shared -std=c++17 at first use).
// A copy of fluidsolver_tpu/native/ib_kernels.cpp; the port's Python
// builders serve other shapes than a circle, not a failed build.

#include <cmath>
#include <cstdint>
#include <limits>

namespace {

struct Circle {
  double cx, cy, r;

  bool contains(double x, double y) const {
    const double dx = x - cx, dy = y - cy;
    return dx * dx + dy * dy <= r * r;
  }

  // Intersection of segment p1-p2 with the circle boundary; requires that
  // exactly one endpoint is inside. Returns parameter t in [0,1].
  double intersect_t(double x1, double y1, double x2, double y2) const {
    const double dx = x2 - x1, dy = y2 - y1;
    const double fx = x1 - cx, fy = y1 - cy;
    const double a = dx * dx + dy * dy;
    const double b = 2.0 * (fx * dx + fy * dy);
    const double c = fx * fx + fy * fy - r * r;
    const double disc = b * b - 4.0 * a * c;
    if (disc < 0.0) return -1.0;
    const double s = std::sqrt(disc);
    const double t1 = (-b - s) / (2.0 * a);
    const double t2 = (-b + s) / (2.0 * a);
    if (0.0 <= t1 && t1 <= 1.0) return t1;
    if (0.0 <= t2 && t2 <= 1.0) return t2;
    return -1.0;
  }
};

}  // namespace

extern "C" {

// Luchini lambda-correction field on one staggered mesh
// (src/IB.hpp:45-108). xs: nx node coords, ys: ny node coords; corr: nx*ny
// output (row-major, x-fastest-last). Returns 0 on success.
int luchini_correction_circle(const double* xs, int64_t nx, const double* ys,
                              int64_t ny, double dx, double dy, double cx,
                              double cy, double r, double* corr) {
  const Circle wall{cx, cy, r};
  const double inf = std::numeric_limits<double>::infinity();

  for (int64_t i = 0; i < nx; ++i)
    for (int64_t j = 0; j < ny; ++j) corr[i * ny + j] = 0.0;

  for (int64_t i = 1; i < nx - 1; ++i) {
    for (int64_t j = 1; j < ny - 1; ++j) {
      const double x = xs[i], y = ys[j];
      if (wall.contains(x, y)) {
        corr[i * ny + j] = inf;
        continue;
      }
      double acc = 0.0;
      if (wall.contains(xs[i + 1], y)) {
        const double t = wall.intersect_t(x, y, xs[i + 1], y);
        const double dist = t * (xs[i + 1] - x);
        acc += (dx - dist) / (dist * dx * dx);
      }
      if (wall.contains(xs[i - 1], y)) {
        const double t = wall.intersect_t(x, y, xs[i - 1], y);
        const double dist = t * (x - xs[i - 1]);
        acc += (dx - dist) / (dist * dx * dx);
      }
      if (wall.contains(x, ys[j + 1])) {
        const double t = wall.intersect_t(x, y, x, ys[j + 1]);
        const double dist = t * (ys[j + 1] - y);
        acc += (dy - dist) / (dist * dy * dy);
      }
      if (wall.contains(x, ys[j - 1])) {
        const double t = wall.intersect_t(x, y, x, ys[j - 1]);
        const double dist = t * (y - ys[j - 1]);
        acc += (dy - dist) / (dist * dy * dy);
      }
      corr[i * ny + j] = acc;
    }
  }
  return 0;
}

// Sharp-IB ghost-cell stencil build for a circular wall
// (examples/SharpIB.cpp:148-271). Outputs flat-index stencils; n_out/
// n_deep are capacities on input, counts on output. scheme: 0 = linear,
// 1 = bounded quadratic. Returns 0 on success, 1 if capacity exceeded.
int sharp_stencil_circle(const double* xs, int64_t nx, const double* ys,
                         int64_t ny, double dx, double dy, double cx,
                         double cy, double r, int scheme, int64_t* tgt,
                         int64_t* nb1, int64_t* nb2, double* w1, double* w2,
                         int64_t* n_out, int64_t* deep, int64_t* n_deep) {
  const Circle wall{cx, cy, r};
  const int64_t cap = *n_out;
  const int64_t cap_deep = *n_deep;
  int64_t n = 0, nd = 0;

  for (int64_t i = 1; i < nx - 1; ++i) {
    for (int64_t j = 1; j < ny - 1; ++j) {
      const double x = xs[i], y = ys[j];
      if (!wall.contains(x, y)) continue;
      const bool fluid_nb =
          !wall.contains(xs[i + 1], y) || !wall.contains(xs[i - 1], y) ||
          !wall.contains(x, ys[j + 1]) || !wall.contains(x, ys[j - 1]);
      if (!fluid_nb) {
        if (nd >= cap_deep) return 1;
        deep[nd++] = i * ny + j;
        continue;
      }
      // outward (solid->fluid) normal: radial
      const double nxn = x - cx, nyn = y - cy;
      int64_t di = 0, dj = 0;
      double h;
      if (std::abs(nxn) > std::abs(nyn)) {
        di = nxn > 0.0 ? 1 : -1;
        h = dx;
      } else {
        dj = nyn > 0.0 ? 1 : -1;
        h = dy;
      }
      const double qx = xs[i + di], qy = ys[j + dj];
      const double t = wall.intersect_t(x, y, qx, qy);
      const double beta = (t < 0.0) ? 0.5 : t;  // defensive fallback
      double w1v, w2v;
      if (scheme == 0) {
        w1v = -beta / (1.0 - beta);
        w2v = 0.0;
      } else {
        const double beta1 = 0.5;
        if (beta < beta1) {
          w1v = -2.0 * beta / (1.0 - beta);
          w2v = beta / (2.0 - beta);
        } else {
          const double w0 = 2.0 / ((1.0 - beta1) * (2.0 - beta1));
          w1v = 2.0 - (2.0 - beta) * w0;
          w2v = -1.0 + (1.0 - beta) * w0;
        }
      }
      if (n >= cap) return 1;
      auto clampi = [](int64_t v, int64_t lo, int64_t hi) {
        return v < lo ? lo : (v > hi ? hi : v);
      };
      tgt[n] = i * ny + j;
      nb1[n] = (i + di) * ny + (j + dj);
      nb2[n] = clampi(i + 2 * di, 0, nx - 1) * ny + clampi(j + 2 * dj, 0, ny - 1);
      w1[n] = w1v;
      w2[n] = w2v;
      ++n;
    }
  }
  *n_out = n;
  *n_deep = nd;
  return 0;
}

}  // extern "C"
