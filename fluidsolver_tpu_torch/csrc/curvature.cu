// curvature: the volume-matching quadratic curvature of every interior mixed
// cell (fluidsolver_tpu_torch/vof/curvature.py vm_core).
//
// Replaces the TPU kernel fluidsolver_tpu/vof/pallas_curvature.py:92
// (curvature_vm_pallas, pallas_call at :215). A valid cell's 3x3
// neighbourhood's PLIC segments are rotated about its own segment midpoint
// so that its normal points to (0, -1) -- with acos/cos/sin, as the plain
// path does, not the TPU kernel's trig-free form, which agrees with it only
// to ~1e-6 -- the symmetric 3x3 normal equations are accumulated in
// neighbour order and solved by Cramer's rule. Invalid neighbours are
// skipped: the plain version adds an exact +0 for them, and an added +0
// could turn a -0 sum into +0.
//
// Bound: memory. A byte plane is read and one plane written for every cell
// (5 bytes per cell in f32, 1026^2: ~0.0016 ms at 3.35 TB/s); the valid
// cells (812 of 1026^2 on the bench drop) each need 10 segments, the trig,
// 9 rotations with two divisions each and a pow -- a chain that, run
// serially in one thread, held a warp ten times one segment's latency. So
// one block of kThreads threads per strip of kStrip consecutive cells (one
// row of the bench box: a strip meets a drop's interface in a few short
// runs, where a square tile of as many cells would hold more of it):
//   1. the strip's cells, kPer a thread: every cell that is not a valid
//      interior cell gets 0; a valid one joins the block's list;
//   2. per round of up to kChunk listed cells, one thread per (cell,
//      neighbour): it loads the cell's and the neighbour's planes together,
//      forms the cell's frame (its segment's midpoint, the angle's cos and
//      sin) and the neighbour's S0, S1, S2 and rhs, or marks it invalid;
//   3. one thread per cell sums the normal equations in neighbour order
//      from shared memory (a select keeps the sums at an invalid
//      neighbour, as the plain version's skip does) and solves them.
// A strip without a valid cell ends after step 1. On an NVIDIA H100 80GB
// HBM3 (700 W), bench drop, f32 (tools/torch_vof_times.py): 0.0061 ms
// against the one-thread-a-cell kernel's 0.0117 in turns;
// fs_curvature_fill_probe, which runs step 1 with every cell filled (the
// memory floor), 0.0029. Tiles of 32 x 8 cells took 0.0073-0.0081 (a fill
// floor of 0.0044), this strip with the frame in a step of its own 0.0064,
// strips of 2048 and 4096 cells 0.0093 and 0.0135 (more rounds a block).
#include <cstddef>

#include "vof_device.cuh"

namespace fs {
namespace {

using vof::Cell;

// a strip of kStrip consecutive cells (row-major) per block of kThreads
// threads, kPer cells a thread; kChunk listed cells per round of the fit
// (9 kChunk pairs, one a thread)
constexpr int kThreads = 256, kPer = 4, kStrip = kThreads * kPer, kChunk = kThreads / 9;

// kFit = false: the fill-only probe, which writes 0 on every cell and fits
// nothing (the kernel's memory floor; never called by the port)
template <typename T, bool kFit>
__global__ void __launch_bounds__(kThreads)
curvature_kernel(const T* __restrict__ pnx, const T* __restrict__ pny,
                 const T* __restrict__ pd, const uint8_t* __restrict__ valid, int N, int M,
                 Cell<T> g, T* __restrict__ out) {
  __shared__ int n_list;
  __shared__ int list[kStrip];          // the strip's valid cells (index in the strip)
  __shared__ T terms[kChunk][9][4];     // S0, S1, S2, rhs of a (cell, neighbour)
  __shared__ bool used[kChunk][9];      // the neighbour is valid
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * kStrip, cells = (size_t)N * M;
  if (tid == 0) n_list = 0;
  __syncthreads();

  // 1. the zeros (the ghost ring carries no curvature), and the list
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int c = r * kThreads + tid;
    const size_t o = base + c;
    if (o >= cells) break;
    bool fit = false;
    if (kFit && valid[o]) {
      const size_t i = o / M, j = o % M;
      fit = i >= 1 && i + 2 <= (size_t)N && j >= 1 && j + 2 <= (size_t)M;
    }
    if (fit) {
      list[atomicAdd(&n_list, 1)] = c;
    } else {
      out[o] = T(0);
    }
  }
  if (!kFit) return;
  __syncthreads();
  const int n = n_list;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int nc = n - c0 < kChunk ? n - c0 : kChunk;
    // 2. one neighbour's segment in the cell's frame per thread: the cell's
    // and the neighbour's planes are loaded together
    if (tid < 9 * nc) {
      const int c = tid / 9, k = tid % 9, a = k / 3, b = k % 3;
      const size_t o = base + list[c0 + c];
      const size_t q = (size_t)((ptrdiff_t)o + (ptrdiff_t)(a - 1) * M + (b - 1));
      const T t_nx = pnx[o], t_ny = pny[o], t_d = pd[o];
      const T q_nx = pnx[q], q_ny = pny[q], q_d = pd[q];
      const bool ok = valid[q] != 0;
      used[c][k] = ok;
      if (ok) {
        T tx0, ty0, tx1, ty1;
        vof::segment_endpoints(t_nx, t_ny, t_d, g, tx0, ty0, tx1, ty1);
        T angle = acos(vof::clamp(-t_ny, T(-1), T(1)));
        angle = t_nx > T(0) ? T(2.0 * 3.141592653589793) - angle : angle;
        const T ca = cos(angle);
        const T sa = sin(angle);
        const T cx = T(0.5) * (tx0 + tx1);
        const T cy = T(0.5) * (ty0 + ty1);
        T x0, y0, x1, y1;
        vof::segment_endpoints(q_nx, q_ny, q_d, g, x0, y0, x1, y1);
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
        terms[c][k][0] = S0;
        terms[c][k][1] = S1;
        terms[c][k][2] = S2;
        terms[c][k][3] = b0 * S0 + b1 * S1;
      }
    }
    __syncthreads();

    // 3. the normal equations in neighbour order, and Cramer's rule on
    // [[a b c] [b e f] [c f i]] (curvature.solve3_cramer)
    if (tid < nc) {
      T A00 = 0, A01 = 0, A02 = 0, A11 = 0, A12 = 0, A22 = 0, D0 = 0, D1 = 0, D2 = 0;
      int count = 0;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        // an invalid neighbour keeps the sums as they are (selects, no branch)
        const bool u = used[tid][k];
        const T S0 = terms[tid][k][0], S1 = terms[tid][k][1], S2 = terms[tid][k][2];
        const T rhs = terms[tid][k][3];
        A00 = u ? A00 + S0 * S0 : A00;
        A01 = u ? A01 + S0 * S1 : A01;
        A02 = u ? A02 + S0 * S2 : A02;
        A11 = u ? A11 + S1 * S1 : A11;
        A12 = u ? A12 + S1 * S2 : A12;
        A22 = u ? A22 + S2 * S2 : A22;
        D0 = u ? D0 + S0 * rhs : D0;
        D1 = u ? D1 + S1 * rhs : D1;
        D2 = u ? D2 + S2 * rhs : D2;
        count += u;
      }
      const T a_ = A00, b_ = A01, c_ = A02, e_ = A11, f_ = A12, i_ = A22;
      const T det = a_ * (e_ * i_ - f_ * f_) - b_ * (b_ * i_ - f_ * c_) + c_ * (b_ * f_ - e_ * c_);
      const T det1 = a_ * (D1 * i_ - f_ * D2) - D0 * (b_ * i_ - f_ * c_) + c_ * (b_ * D2 - D1 * c_);
      const T det2 = a_ * (e_ * D2 - D1 * f_) - b_ * (b_ * D2 - D1 * c_) + D0 * (b_ * f_ - e_ * c_);
      const T c1 = det1 / det;
      const T c2 = det2 / det;
      T curv = T(2) * c2 / pow(T(1) + c1 * c1, T(1.5));
      curv = isfinite(curv) ? curv : T(0);
      out[base + list[c0 + tid]] = count > 1 ? curv : T(0);
    }
    __syncthreads();  // the next round reuses terms and used
  }
}

template <typename T, bool kFit>
int launch(const void* nx, const void* ny, const void* d, const void* valid, int N, int M,
           double dx, double dy, void* out, cudaStream_t stream) {
  const size_t blocks = ((size_t)N * M + kStrip - 1) / kStrip;
  curvature_kernel<T, kFit><<<(unsigned)blocks, kThreads, 0, stream>>>(
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
  return dtype == 0 ? fs::launch<float, true>(nx, ny, d, valid, N, M, dx, dy, out, s)
                    : fs::launch<double, true>(nx, ny, d, valid, N, M, dx, dy, out, s);
}

// A measurement probe with fs_curvature's arguments: the same launch with
// 0 written on every cell and no fit (its time is the kernel's memory
// floor). Never called by the port.
extern "C" int fs_curvature_fill_probe(int dtype, const void* nx, const void* ny, const void* d,
                                       const void* valid, int N, int M, double dx, double dy,
                                       void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float, false>(nx, ny, d, valid, N, M, dx, dy, out, s)
                    : fs::launch<double, false>(nx, ny, d, valid, N, M, dx, dy, out, s);
}
