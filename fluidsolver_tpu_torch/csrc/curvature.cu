// curvature: the volume-matching quadratic curvature of every interior mixed
// cell (fluidsolver_tpu_torch/vof/curvature.py vm_core).
//
// Replaces the TPU kernel fluidsolver_tpu/vof/pallas_curvature.py:92
// (curvature_vm_pallas, pallas_call at :215). One thread owns one cell and
// exits with 0 unless the cell is valid; a valid cell computes the PLIC
// segments of its 3x3 neighbourhood itself (the 9x recompute is a few dozen
// flops per neighbour), rotates them about its own segment midpoint so that
// its normal points to (0, -1) -- with acos/cos/sin, as the plain path does,
// not the TPU kernel's trig-free form, which agrees with it only to ~1e-6 --
// accumulates the symmetric 3x3 normal equations in neighbour order and
// solves them by Cramer's rule. Invalid neighbours are skipped: the plain
// version adds an exact +0 for them.
//
// Bound: memory. A byte plane is read and one plane written for every cell
// (5 bytes per cell in f32); the ~0.3% valid cells read 3 planes of their
// neighbourhood and do ~600 flops each.
#include "vof_device.cuh"

namespace fs {
namespace {

using vof::Cell;

template <typename T>
__global__ void __launch_bounds__(256)
curvature_kernel(const T* __restrict__ pnx, const T* __restrict__ pny,
                 const T* __restrict__ pd, const uint8_t* __restrict__ valid, int N, int M,
                 Cell<T> g, T* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= N || j >= M) return;
  const size_t o = (size_t)i * M + j;
  // the ghost ring carries no curvature (and no reconstruction)
  if (i < 1 || i > N - 2 || j < 1 || j > M - 2 || !valid[o]) {
    out[o] = T(0);
    return;
  }
  const T t_nx = pnx[o], t_ny = pny[o];
  T tx0, ty0, tx1, ty1;
  vof::segment_endpoints(t_nx, t_ny, pd[o], g, tx0, ty0, tx1, ty1);

  T angle = acos(vof::clamp(-t_ny, T(-1), T(1)));
  angle = t_nx > T(0) ? T(2.0 * 3.141592653589793) - angle : angle;
  const T ca = cos(angle);
  const T sa = sin(angle);
  const T cx = T(0.5) * (tx0 + tx1);
  const T cy = T(0.5) * (ty0 + ty1);

  T A00 = 0, A01 = 0, A02 = 0, A11 = 0, A12 = 0, A22 = 0, D0 = 0, D1 = 0, D2 = 0;
  int count = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const size_t q = (size_t)(i + a - 1) * M + (j + b - 1);
      if (!valid[q]) continue;
      T x0, y0, x1, y1;
      vof::segment_endpoints(pnx[q], pny[q], pd[q], g, x0, y0, x1, y1);
      const T ox = T(a - 1) * g.w, oy = T(b - 1) * g.h;
      const T xs0 = x0 + ox - cx, ys0 = y0 + oy - cy;
      const T xs1 = x1 + ox - cx, ys1 = y1 + oy - cy;
      const T rx0 = ca * xs0 - sa * ys0, ry0 = sa * xs0 + ca * ys0;
      const T rx1 = ca * xs1 - sa * ys1, ry1 = sa * xs1 + ca * ys1;
      const bool swap = rx0 > rx1;
      const T bx = swap ? rx1 : rx0, by = swap ? ry1 : ry0;
      const T ex = swap ? rx0 : rx1, ey = swap ? ry0 : ry1;
      const T b1 = (ey - by) / (ex - bx);
      const T b0 = by - b1 * bx;
      const T S0 = ex - bx;
      const T S1 = T(0.5) * (ex * ex - bx * bx);
      const T S2 = (ex * ex * ex - bx * bx * bx) / T(3);
      A00 = A00 + S0 * S0;
      A01 = A01 + S0 * S1;
      A02 = A02 + S0 * S2;
      A11 = A11 + S1 * S1;
      A12 = A12 + S1 * S2;
      A22 = A22 + S2 * S2;
      const T rhs = b0 * S0 + b1 * S1;
      D0 = D0 + S0 * rhs;
      D1 = D1 + S1 * rhs;
      D2 = D2 + S2 * rhs;
      ++count;
    }
  }
  // Cramer's rule on [[a b c] [b e f] [c f i]] (curvature.solve3_cramer)
  const T a_ = A00, b_ = A01, c_ = A02, e_ = A11, f_ = A12, i_ = A22;
  const T det = a_ * (e_ * i_ - f_ * f_) - b_ * (b_ * i_ - f_ * c_) + c_ * (b_ * f_ - e_ * c_);
  const T det1 = a_ * (D1 * i_ - f_ * D2) - D0 * (b_ * i_ - f_ * c_) + c_ * (b_ * D2 - D1 * c_);
  const T det2 = a_ * (e_ * D2 - D1 * f_) - b_ * (b_ * D2 - D1 * c_) + D0 * (b_ * f_ - e_ * c_);
  const T c1 = det1 / det;
  const T c2 = det2 / det;
  T curv = T(2) * c2 / pow(T(1) + c1 * c1, T(1.5));
  curv = isfinite(curv) ? curv : T(0);
  out[o] = count > 1 ? curv : T(0);
}

template <typename T>
int launch(const void* nx, const void* ny, const void* d, const void* valid, int N, int M,
           double dx, double dy, void* out, cudaStream_t stream) {
  const dim3 block(32, 8), grid((M + 31) / 32, (N + 7) / 8);
  curvature_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(nx), static_cast<const T*>(ny), static_cast<const T*>(d),
      static_cast<const uint8_t*>(valid), N, M, Cell<T>::make(dx, dy), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// nx, ny, d: (N, M) PLIC planes; valid: (N, M) bytes (0/1); out: (N, M).
// dtype 0 = float, 1 = double. Returns a cudaError_t (0 = launched).
extern "C" int fs_curvature(int dtype, const void* nx, const void* ny, const void* d,
                            const void* valid, int N, int M, double dx, double dy, void* out,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float>(nx, ny, d, valid, N, M, dx, dy, out, s)
                    : fs::launch<double>(nx, ny, d, valid, N, M, dx, dy, out, s);
}
