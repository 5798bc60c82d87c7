// fused_momentum: one two-phase subiteration's momentum stage in one launch:
// consistent density transport (calc_drhodt + update_density), momentum
// fluxes with hybrid upwinding (calc_dmomdt), gravity and the velocity
// update (update_velocity).
//
// Replaces the TPU kernel fluidsolver_tpu/ops/pallas_momentum.py:247
// (fused_momentum, pallas_call at :307). The TPU kernel streams row bands of
// all twelve inputs through VMEM on a lane-padded canvas; none of that
// layout is kept. One thread owns cell (i, j) of the (Nc + 1) x (M + 1)
// canvas and writes the U face (i, j) (shape (Nc + 1, M)) and the V face
// (i, j) (shape (Nc, M + 1)) that fall on it. It recomputes the centre and
// corner fluxes its two faces difference from global memory (neighbouring
// threads read them again through L1), so there is no scratch plane and no
// second pass. Outside the interior masks of the TPU kernel (:122-123) the
// outputs keep the base values rho_u, rho_v, U and V.
//
// Index conventions (as ops/momentum.py): centre c pairs faces U[c] and
// U[c + 1]; corner (k, l) reads U[k+1, l], U[k+1, l+1], V[k, l+1] and
// V[k+1, l+1]. Every expression keeps the operand order of the plain
// PyTorch sequence, and the library is compiled with --fmad=false. PyTorch
// on CUDA divides by a Python scalar as a multiplication by its reciprocal
// (rounded once in the data type), so / dx and / dy are * inv_dx, * inv_dy.
//
// Bound: device-memory bandwidth. Twelve input planes are read once from
// device memory and four output planes written once (~150 flops per cell).
#include <cuda_runtime.h>

namespace fs {
namespace {

constexpr int kBx = 32, kBy = 8;

template <typename T>
struct MomArgs {
  const T *U, *V, *Uo, *Vo, *ruo, *rvo, *ru, *rv, *visc, *p, *pju, *pjv;
  const T* dt;
  T *ru_out, *rv_out, *U_out, *V_out;
  int Nc, M;  // centre shape; U is (Nc + 1, M), V is (Nc, M + 1)
  T inv_dx, inv_dy, eps, gx, gy;
  bool has_gx, has_gy;
};

// mom.hybrid_interp: central average, upwind where the density jumps
template <typename T>
__device__ __forceinline__ void hybrid(T eps, T rho_m, T rho_p, T velo_m, T velo_p, T tr_m, T tr_p,
                                       T& rho, T& velo) {
  const bool upwind_minus = tr_p + tr_m >= T(0);
  const T jump = rho_p - rho_m;
  const bool use_up = (jump < T(0) ? -jump : jump) > eps;
  rho = use_up ? (upwind_minus ? rho_m : rho_p) : T(0.5) * (rho_p + rho_m);
  velo = use_up ? (upwind_minus ? velo_m : velo_p) : T(0.5) * (velo_p + velo_m);
}

template <typename T>
struct Flux {
  T mom;  // momentum flux (calc_dmomdt)
  T rho;  // density flux (calc_drhodt)
};

// x fluxes of U on centre (c, j): FXU and the density flux
template <typename T>
__device__ __forceinline__ Flux<T> flux_xu(const MomArgs<T>& A, int c, int j) {
  const int M = A.M;
  const T um = A.U[(size_t)c * M + j], up = A.U[(size_t)(c + 1) * M + j];
  T rho_h, u_h;
  hybrid(A.eps, A.ruo[(size_t)c * M + j], A.ruo[(size_t)(c + 1) * M + j], um, up, um, up, rho_h,
         u_h);
  const T u_c = T(0.5) * (up + um);
  const T dudx = (up - um) * A.inv_dx;
  const size_t o = (size_t)c * M + j;
  Flux<T> f;
  f.mom = -rho_h * u_h * u_c + T(2) * A.visc[o] * dudx - A.p[o];
  f.rho = -rho_h * T(0.5) * (um + up);
  return f;
}

// y fluxes of V on centre (c, l): FYV and the density flux
template <typename T>
__device__ __forceinline__ Flux<T> flux_yv(const MomArgs<T>& A, int c, int l) {
  const int M = A.M;
  const size_t ov = (size_t)c * (M + 1) + l;
  const T vm = A.V[ov], vp = A.V[ov + 1];
  T rho_h, v_h;
  hybrid(A.eps, A.rvo[ov], A.rvo[ov + 1], vm, vp, vm, vp, rho_h, v_h);
  const T v_c = T(0.5) * (vp + vm);
  const T dvdy = (vp - vm) * A.inv_dy;
  const size_t o = (size_t)c * M + l;
  Flux<T> f;
  f.mom = -rho_h * v_h * v_c + T(2) * A.visc[o] * dvdy - A.p[o];
  f.rho = -rho_h * T(0.5) * (vm + vp);
  return f;
}

// corner (k, l): FYU and its density flux (u), FXV and its density flux (v)
template <typename T>
__device__ __forceinline__ void flux_corner(const MomArgs<T>& A, int k, int l, Flux<T>& fu,
                                            Flux<T>& fv) {
  const int M = A.M;
  const size_t ou = (size_t)(k + 1) * M + l;
  const size_t ov0 = (size_t)k * (M + 1) + l + 1, ov1 = (size_t)(k + 1) * (M + 1) + l + 1;
  const T u_lo = A.U[ou], u_hi = A.U[ou + 1];
  const T v_lo = A.V[ov0], v_hi = A.V[ov1];
  const size_t c00 = (size_t)k * M + l, c10 = (size_t)(k + 1) * M + l;
  const T mu_c =
      T(0.25) * (A.visc[c10 + 1] + A.visc[c00 + 1] + A.visc[c10] + A.visc[c00]);
  const T dudy = (u_hi - u_lo) * A.inv_dy;
  const T dvdx = (v_hi - v_lo) * A.inv_dx;
  T rho_h, w_h;
  hybrid(A.eps, A.ruo[ou], A.ruo[ou + 1], u_lo, u_hi, v_lo, v_hi, rho_h, w_h);
  fu.mom = -rho_h * w_h * T(0.5) * (v_lo + v_hi) + mu_c * (dudy + dvdx);
  fu.rho = -rho_h * T(0.5) * (v_lo + v_hi);
  hybrid(A.eps, A.rvo[ov0], A.rvo[ov1], v_lo, v_hi, u_lo, u_hi, rho_h, w_h);
  fv.mom = -rho_h * w_h * T(0.5) * (u_lo + u_hi) + mu_c * (dudy + dvdx);
  fv.rho = -rho_h * T(0.5) * (u_lo + u_hi);
}

template <typename T>
__device__ __forceinline__ T safe_rho(T r) { return r == T(0) ? T(1) : r; }

template <typename T>
__global__ void __launch_bounds__(kBx * kBy) fused_momentum_kernel(MomArgs<T> A) {
  const int j = blockIdx.x * kBx + threadIdx.x;
  const int i = blockIdx.y * kBy + threadIdx.y;
  const int Nc = A.Nc, M = A.M;
  const T dt = A.dt[0];

  // U face (i, j), interior 0 < i < Nc, 0 < j < M - 1
  if (i <= Nc && j < M) {
    const size_t o = (size_t)i * M + j;
    T ru = A.ru[o], u = A.U[o];
    if (i > 0 && i < Nc && j > 0 && j < M - 1) {
      // centres i and i - 1, corners (i - 1, j) and (i - 1, j - 1)
      const Flux<T> ce = flux_xu(A, i, j), cw = flux_xu(A, i - 1, j);
      Flux<T> kn, ks, unused;
      flux_corner(A, i - 1, j, kn, unused);
      flux_corner(A, i - 1, j - 1, ks, unused);
      const T drho = (ce.rho - cw.rho) * A.inv_dx + (kn.rho - ks.rho) * A.inv_dy;
      T dmom = (ce.mom - cw.mom) * A.inv_dx + (kn.mom - ks.mom) * A.inv_dy + A.pju[o];
      ru = A.ruo[o] + dt * drho;
      if (A.has_gx) dmom = dmom + ru * A.gx;
      u = (A.ruo[o] * A.Uo[o] + dt * dmom) / safe_rho(ru);
    }
    A.ru_out[o] = ru;
    A.U_out[o] = u;
  }

  // V face (i, j), interior 0 < i < Nc - 1, 0 < j < M
  if (i < Nc && j <= M) {
    const size_t o = (size_t)i * (M + 1) + j;
    T rv = A.rv[o], v = A.V[o];
    if (i > 0 && i < Nc - 1 && j > 0 && j < M) {
      // corners (i, j - 1) and (i - 1, j - 1), centres j and j - 1
      const Flux<T> cn = flux_yv(A, i, j), cs = flux_yv(A, i, j - 1);
      Flux<T> ke, kw, unused;
      flux_corner(A, i, j - 1, unused, ke);
      flux_corner(A, i - 1, j - 1, unused, kw);
      const T drho = (ke.rho - kw.rho) * A.inv_dx + (cn.rho - cs.rho) * A.inv_dy;
      T dmom = (ke.mom - kw.mom) * A.inv_dx + (cn.mom - cs.mom) * A.inv_dy + A.pjv[o];
      rv = A.rvo[o] + dt * drho;
      if (A.has_gy) dmom = dmom + rv * A.gy;
      v = (A.rvo[o] * A.Vo[o] + dt * dmom) / safe_rho(rv);
    }
    A.rv_out[o] = rv;
    A.V_out[o] = v;
  }
}

template <typename T>
int launch(const void* const* in, const void* dt, void* const* out, int Nc, int M, double dx,
           double dy, double eps, double gx, double gy, cudaStream_t s) {
  if (Nc < 1 || M < 1) return cudaErrorInvalidValue;
  MomArgs<T> a;
  const T* const* x = reinterpret_cast<const T* const*>(in);
  a.U = x[0]; a.V = x[1]; a.Uo = x[2]; a.Vo = x[3]; a.ruo = x[4]; a.rvo = x[5];
  a.ru = x[6]; a.rv = x[7]; a.visc = x[8]; a.p = x[9]; a.pju = x[10]; a.pjv = x[11];
  a.dt = static_cast<const T*>(dt);
  T* const* y = reinterpret_cast<T* const*>(out);
  a.ru_out = y[0]; a.rv_out = y[1]; a.U_out = y[2]; a.V_out = y[3];
  a.Nc = Nc;
  a.M = M;
  a.inv_dx = T(1) / T(dx);
  a.inv_dy = T(1) / T(dy);
  a.eps = T(eps);
  a.gx = T(gx);
  a.gy = T(gy);
  a.has_gx = gx != 0.0;
  a.has_gy = gy != 0.0;
  const dim3 block(kBx, kBy), grid((M + 1 + kBx - 1) / kBx, (Nc + 1 + kBy - 1) / kBy);
  fused_momentum_kernel<T><<<grid, block, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// The momentum stage. in: U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u,
// rho_v, visc, p, p_jump_u, p_jump_v (U-shaped (Nc + 1, M), V-shaped
// (Nc, M + 1), centre-shaped (Nc, M)); dt: one device value. out: rho_u',
// rho_v', U', V'. dtype 0 = float, 1 = double. Returns a cudaError_t
// (0 = launched).
extern "C" int fs_fused_momentum(int dtype, const void* const* in, const void* dt,
                                 void* const* out, int Nc, int M, double dx, double dy,
                                 double rho_eps, double gx, double gy, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;  // float or double only
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float>(in, dt, out, Nc, M, dx, dy, rho_eps, gx, gy, s)
                    : fs::launch<double>(in, dt, out, Nc, M, dx, dy, rho_eps, gx, gy, s);
}
