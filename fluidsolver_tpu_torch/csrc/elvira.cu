// elvira: the 12-candidate ELVIRA reconstruction of every interior mixed
// cell of a VOF field (fluidsolver_tpu_torch/vof/plic.py elvira_candidates).
//
// Replaces the TPU kernel fluidsolver_tpu/vof/pallas_elvira.py:51
// (elvira_pallas, pallas_call at :148), which streams row bands with 8-row
// halos through VMEM and evaluates every candidate on every cell. Here one
// thread owns one cell of the ghost box: a cell that is not interior-mixed
// writes the fills (nx, ny, d, valid) = (0, 1, 0, 0) and exits; a mixed cell
// reads its 3x3 fractions (L1 hits) and runs the 12 candidates in the JAX
// package's order with a running strict-< minimum, which is argmin's
// first-wins tie-break.
//
// Bound: memory. The field is read once and 3 planes plus a byte plane are
// written (17 bytes per cell in f32, 1026^2: ~18 MB, ~5 us at 3.35 TB/s);
// the candidate search (~3 kflop per mixed cell) touches ~0.3% of the cells.
#include "vof_device.cuh"

namespace fs {
namespace {

using vof::Cell;

template <typename T>
__global__ void __launch_bounds__(256)
elvira_kernel(const T* __restrict__ vf, int N, int M, Cell<T> g, T lo, T hi,
              T* __restrict__ onx, T* __restrict__ ony, T* __restrict__ od,
              uint8_t* __restrict__ ovalid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= N || j >= M) return;
  const size_t o = (size_t)i * M + j;
  const T v0 = vf[o];
  const bool mixed = i >= 1 && i <= N - 2 && j >= 1 && j <= M - 2 && v0 > lo && v0 < hi;
  if (!mixed) {
    onx[o] = T(0);
    ony[o] = T(1);
    od[o] = T(0);
    ovalid[o] = 0;
    return;
  }
  T v[3][3];  // v[di + 1][dj + 1] = vf(i + di, j + dj)
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) v[a][b] = vf[(size_t)(i + a - 1) * M + (j + b - 1)];

  T col[3], row[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    col[a] = (v[a][0] + v[a][1] + v[a][2]) * g.h;
    row[a] = (v[0][a] + v[1][a] + v[2][a]) * g.w;
  }
  const T slopes[6] = {
      (col[1] - col[0]) / g.w, (col[2] - col[0]) / g.two_w, (col[2] - col[1]) / g.w,
      (row[1] - row[0]) / g.h, (row[2] - row[0]) / g.two_h, (row[2] - row[1]) / g.h,
  };

  T best_err = T(INFINITY), best_nx = T(0), best_ny = T(1), best_d = T(0);
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    const T s = slopes[c / 2];
    const T norm = sqrt(s * s + T(1));
    T cnx, cny;
    if (c < 6) {  // column heights: (-s, +-1) / norm
      cnx = -s / norm;
      cny = (c % 2 == 0) ? T(1) / norm : T(-1) / norm;
    } else {      // row heights: (+-1, -s) / norm
      cnx = (c % 2 == 0) ? T(1) / norm : T(-1) / norm;
      cny = -s / norm;
    }
    const T d = vof::plane_constant(cnx, cny, v0, g);
    T err = T(0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T d_n = d - (cnx * T(a - 1) * g.w + cny * T(b - 1) * g.h);
        const T e = vof::area_fraction(cnx, cny, d_n, g) - v[a][b];
        err = err + e * e;
      }
    }
    if (err < best_err) {
      best_err = err;
      best_nx = cnx;
      best_ny = cny;
      best_d = d;
    }
  }
  onx[o] = best_nx;
  ony[o] = best_ny;
  od[o] = best_d;
  ovalid[o] = 1;
}

template <typename T>
int launch(const void* vf, int N, int M, double dx, double dy, double lo, double hi,
           void* out, void* valid, cudaStream_t stream) {
  const size_t plane = (size_t)N * M;
  T* o = static_cast<T*>(out);
  const dim3 block(32, 8), grid((M + 31) / 32, (N + 7) / 8);
  elvira_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(vf), N, M,
                                                Cell<T>::make(dx, dy), T(lo), T(hi), o,
                                                o + plane, o + 2 * plane,
                                                static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// vf: (N, M) contiguous; out: (3, N, M) = nx, ny, d; valid: (N, M) uint8.
// dtype 0 = float, 1 = double. Returns a cudaError_t (0 = launched).
extern "C" int fs_elvira(int dtype, const void* vf, int N, int M, double dx, double dy,
                         double lo, double hi, void* out, void* valid, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float>(vf, N, M, dx, dy, lo, hi, out, valid, s)
                    : fs::launch<double>(vf, N, M, dx, dy, lo, hi, out, valid, s);
}
