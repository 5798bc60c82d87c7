// overlap: the overlap accumulation of the sparse VOF advection
// (fluidsolver_tpu_torch/vof/advect.py overlap_from_neighbors).
//
// Replaces the TPU kernel fluidsolver_tpu/vof/pallas_advect.py:157
// (overlap_pallas, pallas_call at :220). Per active lane the start polygon
// (the flux-corrected octagon, 8 vertices) is clipped against each of the 9
// neighbour cells -- the W, E, S, N edges, then the neighbour's PLIC liquid
// half-plane -- and the areas of the neighbours whose fraction exceeds the
// mixed-cell cutoff are summed; the start polygon's own area comes out too.
//
// One thread owns one (lane, neighbour) pair and a block holds whole lanes
// (9 threads each), so the 9 areas of a lane are summed in neighbour order
// from shared memory. The clips are sequential Sutherland-Hodgman passes:
// vertex i is emitted if inside, then the crossing on edge i, which is the
// stable "flagged first, order preserved" compaction of the plain version.
// The polygon lives in shared memory, [buffer][x|y][slot][thread], so that a
// vertex index that differs from thread to thread needs no local memory.
// A non-convex octagon can gain more than one vertex per clip, so the
// buffers hold kSlots = 16 vertices like the plain version's K; a polygon
// with more emissions keeps its first 16, as the plain version does. The
// TPU kernel's 13 register slots assume one insertion per clip.
//
// Bound: bytes, at the main path's size. Per lane it reads 16 slot values,
// two indices and 5 values of each of 9 neighbours, and writes 2 values
// (~250 bytes in f32); the clips need a few hundred flops per lane, since
// only the neighbours above the cutoff count (chip_smoke.py overlap_flops).
#include <cuda_runtime.h>

#include <cstdint>

namespace fs {
namespace {

constexpr int kSlots = 16;  // advect.K
constexpr int kStart = 8;   // the octagon

template <typename T, int L>
__global__ void __launch_bounds__(9 * L)
overlap_kernel(const T* __restrict__ sx, const T* __restrict__ sy,
               const int64_t* __restrict__ li, const int64_t* __restrict__ lj,
               const T* __restrict__ vf, const uint8_t* __restrict__ valid,
               const T* __restrict__ pnx, const T* __restrict__ pny, const T* __restrict__ pd,
               int M, int m, T dx, T dy, T lo, T* __restrict__ overlap, T* __restrict__ area) {
  constexpr int NT = 9 * L;
  __shared__ T poly[2][2][kSlots][NT];
  __shared__ T contrib[NT];
  const int t = threadIdx.x;
  const int nb = t % 9;
  const int lane = blockIdx.x * L + t / 9;
  T mine = T(0);
  if (lane < m) {
#pragma unroll
    for (int s = 0; s < kStart; ++s) {
      poly[0][0][s][t] = sx[(size_t)s * m + lane];
      poly[0][1][s][t] = sy[(size_t)s * m + lane];
    }
    if (nb == 0) {  // shoelace of the start polygon
      T acc = T(0);
#pragma unroll
      for (int s = 0; s < kStart; ++s) {
        const int sn = (s + 1) % kStart;
        acc = acc + (poly[0][0][s][t] * poly[0][1][sn][t] - poly[0][0][sn][t] * poly[0][1][s][t]);
      }
      area[lane] = T(0.5) * acc;
    }

    int n = kStart, cur = 0;
    // clip against {a x + b y <= c} from buffer cur into the other one
    auto clip = [&](T a, T b, T c) {
      const int nn = n < kSlots ? n : kSlots;
      const int out = 1 - cur;
      int k = 0;
      if (nn > 0) {
        const T x0 = poly[cur][0][0][t], y0 = poly[cur][1][0][t];
        const T d0 = a * x0 + b * y0 - c;
        T xi = x0, yi = y0, dv = d0;
        for (int s = 0; s < nn; ++s) {
          T xn = x0, yn = y0, dn = d0;
          if (s + 1 < nn) {
            xn = poly[cur][0][s + 1][t];
            yn = poly[cur][1][s + 1][t];
            dn = a * xn + b * yn - c;
          }
          const bool in_i = dv <= T(0), in_n = dn <= T(0);
          if (in_i) {
            if (k < kSlots) {
              poly[out][0][k][t] = xi;
              poly[out][1][k][t] = yi;
            }
            ++k;
          }
          if (in_i != in_n) {
            const T denom = dv - dn;
            const T tt = fabs(denom) > T(0) ? dv / (denom == T(0) ? T(1) : denom) : T(0);
            if (k < kSlots) {
              poly[out][0][k][t] = xi + tt * (xn - xi);
              poly[out][1][k][t] = yi + tt * (yn - yi);
            }
            ++k;
          }
          xi = xn;
          yi = yn;
          dv = dn;
        }
      }
      n = k;
      cur = out;
    };

    const int di = nb / 3 - 1, dj = nb % 3 - 1;
    const T x_lo = T(di) * dx, y_lo = T(dj) * dy;
    clip(T(-1), T(0), -x_lo);
    clip(T(1), T(0), x_lo + dx);
    clip(T(0), T(-1), -y_lo);
    clip(T(0), T(1), y_lo + dy);
    const size_t q = (size_t)(1 + li[lane] + di) * M + (1 + lj[lane] + dj);
    const bool mixed = valid[q] != 0;
    const T qnx = pnx[q], qny = pny[q];
    clip(mixed ? qnx : T(0), mixed ? qny : T(0), mixed ? pd[q] + qnx * x_lo + qny * y_lo : T(1));

    const int nn = n < kSlots ? n : kSlots;
    T acc = T(0);
    for (int s = 0; s < nn; ++s) {
      const int sn = s + 1 == nn ? 0 : s + 1;
      acc = acc + (poly[cur][0][s][t] * poly[cur][1][sn][t] - poly[cur][0][sn][t] * poly[cur][1][s][t]);
    }
    mine = vf[q] > lo ? T(0.5) * acc : T(0);
  }
  contrib[t] = mine;
  __syncthreads();
  if (nb == 0 && lane < m) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) s = s + contrib[t + k];
    overlap[lane] = s;
  }
}

template <typename T, int L>
int launch(const void* sx, const void* sy, const void* li, const void* lj, const void* vf,
           const void* valid, const void* nx, const void* ny, const void* d, int M, int m,
           double dx, double dy, double lo, void* overlap, void* area, cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  const int blocks = (m + L - 1) / L;
  overlap_kernel<T, L><<<blocks, 9 * L, 0, stream>>>(
      static_cast<const T*>(sx), static_cast<const T*>(sy), static_cast<const int64_t*>(li),
      static_cast<const int64_t*>(lj), static_cast<const T*>(vf),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(nx), static_cast<const T*>(ny),
      static_cast<const T*>(d), M, m, T(dx), T(dy), T(lo), static_cast<T*>(overlap),
      static_cast<T*>(area));
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// sx, sy: (8, m) start-polygon vertices (cell-local); li, lj: (m,) int64
// clamped interior lane indices; vf, nx, ny, d: (N, M) with N unused beyond
// the indices; valid: (N, M) bytes; overlap, area: (m,). dtype 0 = float
// (16 lanes per block), 1 = double (8 lanes). Returns a cudaError_t.
extern "C" int fs_overlap(int dtype, const void* sx, const void* sy, const void* li,
                          const void* lj, const void* vf, const void* valid, const void* nx,
                          const void* ny, const void* d, int N, int M, int m, double dx,
                          double dy, double lo, void* overlap, void* area, void* stream) {
  (void)N;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? fs::launch<float, 16>(sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx, dy, lo,
                                     overlap, area, s)
             : fs::launch<double, 8>(sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx, dy, lo,
                                     overlap, area, s);
}
