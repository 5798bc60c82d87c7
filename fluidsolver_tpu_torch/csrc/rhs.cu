// fused_rhs: one two-phase subiteration's pressure right-hand side in one
// launch: the divergence of the momentum stage's velocities, the capillary
// pressure jump sigma kappa_face grad(vf) on the interior faces
// (calc_pressure_jump) and the jump's increment over the face densities,
// folded into the divergence on the interior.
//
// Replaces no TPU kernel: the JAX package writes this stage in jnp
// (fluidsolver_tpu/solvers/twophase.py, the pressure_jump branch of the
// subiteration), and XLA fuses it into one pass on the TPU. Run eagerly in
// PyTorch it is about fifty elementwise kernels, many on strided slices.
//
// One thread owns centre (i, j) of the Nc x M box, j along the contiguous
// axis. It writes div (i, j), the jump on its own U face (i, j) (between
// centres i - 1 and i) and V face (i, j) (between centres j - 1 and j), and
// on the last row or column the far face's zero ghost value too. For the
// increment it recomputes the jump on the faces (i + 1, j) and (i, j + 1)
// from the neighbours' vf, curvature and interface length, which the
// neighbouring threads load again through L1 and L2, so every plane is read
// from device memory about once and there is no scratch plane and no second
// pass.
//
// Index conventions (as ops/momentum.py and ops/stencil.py): U is
// (Nc + 1, M), V is (Nc, M + 1); U face i lies between centres i - 1 and i.
// Every expression keeps the operand order of the plain PyTorch sequence,
// and the library is compiled with --fmad=false. PyTorch on CUDA divides by
// a Python scalar as a multiplication by its reciprocal, taken in double and
// rounded once to the data type, so / dx and / dy are * inv_dx, * inv_dy
// with inv_dx = T(1.0 / dx) (in float, T(1) / T(dx) can differ from it by
// an ulp). Outside the interior div is the raw divergence plus 0 (the plain
// sequence's zero pad turns -0 into +0), and the jumps are 0.
//
// Bound: device-memory bandwidth. Nine planes are read once (U, V, vf,
// curvature, interface length, the two face densities and the two old
// jumps) and three written (div and the two jumps): 12 planes, about 60
// flops per cell.
#include <cuda_runtime.h>

namespace fs {
namespace {

constexpr int kBx = 32, kBy = 8;

template <typename T>
struct RhsArgs {
  const T *U, *V, *vf, *curv, *len, *ru, *rv, *pju_old, *pjv_old;
  const T* dt;
  T *div, *pju, *pjv;
  int Nc, M;  // centre shape; U is (Nc + 1, M), V is (Nc, M + 1)
  T inv_dx, inv_dy, sigma;
};

// ((sigma kappa_face) (vf_p - vf_m)) * inv_h, kappa_face the interface-
// length-weighted curvature of centres m and p (0 where neither has one)
template <typename T>
__device__ __forceinline__ T jump(const RhsArgs<T>& A, size_t m, size_t p, T inv_h) {
  const T lm = A.len[m], lp = A.len[p];
  const T total = lm + lp;
  const T kappa = total > T(0) ? (A.curv[p] * lp + A.curv[m] * lm) / total : T(0);
  return A.sigma * kappa * (A.vf[p] - A.vf[m]) * inv_h;
}

template <typename T>
__global__ void __launch_bounds__(kBx * kBy) fused_rhs_kernel(RhsArgs<T> A) {
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  const int Nc = A.Nc, M = A.M;
  if (i >= Nc || j >= M) return;
  const size_t c = (size_t)i * M + j;           // centre (i, j) and U face (i, j)
  const size_t v = (size_t)i * (M + 1) + j;     // V face (i, j)

  // the jump on U face (i, j), interior 0 < i < Nc, 0 < j < M - 1, and on
  // V face (i, j), interior 0 < i < Nc - 1, 0 < j < M
  const bool in_j = j > 0 && j < M - 1, in_i = i > 0 && i < Nc - 1;
  const T ju = i > 0 && in_j ? jump(A, c - M, c, A.inv_dx) : T(0);
  const T jv = in_i && j > 0 ? jump(A, c - 1, c, A.inv_dy) : T(0);
  A.pju[c] = ju;
  A.pjv[v] = jv;
  if (i == Nc - 1) A.pju[c + M] = T(0);
  if (j == M - 1) A.pjv[v + 1] = T(0);

  const T raw = (A.U[c + M] - A.U[c]) * A.inv_dx + (A.V[v + 1] - A.V[v]) * A.inv_dy;
  T inc = T(0);
  if (in_i && in_j) {
    // (dpj / rho) on faces i + 1 and i, j + 1 and j
    const T ju1 = jump(A, c, c + M, A.inv_dx);
    const T jv1 = jump(A, c, c + 1, A.inv_dy);
    const T du = (ju1 - A.pju_old[c + M]) / A.ru[c + M] - (ju - A.pju_old[c]) / A.ru[c];
    const T dv = (jv1 - A.pjv_old[v + 1]) / A.rv[v + 1] - (jv - A.pjv_old[v]) / A.rv[v];
    inc = A.dt[0] * (du * A.inv_dx + dv * A.inv_dy);
  }
  A.div[c] = raw + inc;
}

template <typename T>
int launch(const void* const* in, const void* dt, void* const* out, int Nc, int M, double dx,
           double dy, double sigma, cudaStream_t s) {
  if (Nc < 1 || M < 1) return cudaErrorInvalidValue;
  RhsArgs<T> a;
  const T* const* x = reinterpret_cast<const T* const*>(in);
  a.U = x[0]; a.V = x[1]; a.vf = x[2]; a.curv = x[3]; a.len = x[4]; a.ru = x[5]; a.rv = x[6];
  a.pju_old = x[7]; a.pjv_old = x[8];
  a.dt = static_cast<const T*>(dt);
  T* const* y = reinterpret_cast<T* const*>(out);
  a.div = y[0]; a.pju = y[1]; a.pjv = y[2];
  a.Nc = Nc;
  a.M = M;
  a.inv_dx = T(1.0 / dx);
  a.inv_dy = T(1.0 / dy);
  a.sigma = T(sigma);
  const dim3 block(kBx, kBy), grid((M + kBx - 1) / kBx, (Nc + kBy - 1) / kBy);
  fused_rhs_kernel<T><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// The pressure right-hand side. in: U, V, vf_old, curv, interface_length,
// rho_u, rho_v, p_jump_u_old, p_jump_v_old (U-shaped (Nc + 1, M), V-shaped
// (Nc, M + 1), centre-shaped (Nc, M)); dt: one device value. out: div
// (centre-shaped), p_jump_u, p_jump_v. dtype 0 = float, 1 = double. Returns
// a cudaError_t (0 = launched).
extern "C" int fs_fused_rhs(int dtype, const void* const* in, const void* dt, void* const* out,
                            int Nc, int M, double dx, double dy, double sigma, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;  // float or double only
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float>(in, dt, out, Nc, M, dx, dy, sigma, s)
                    : fs::launch<double>(in, dt, out, Nc, M, dx, dy, sigma, s);
}
