// bf16 storage for the multigrid kernels (the preconditioner's
// pressure_precond_dtype="bfloat16" path).
//
// Two ways a kernel meets bf16, after the two TPU kernels it replaces:
// - storage only (fused_smooth, fluidsolver_tpu/poisson/pallas_vcycle.py
//   :118-125): operands are loaded as bf16, widened to float, and all
//   arithmetic runs in float; outputs are rounded once, to nearest even, on
//   the store. widen() and put() are the identity for float and double, so
//   those instantiations compile to what they were.
// - storage and arithmetic (rb_sweep, pallas_smoother.py:32-51, which
//   computes in its operands' dtype): bf16r rounds after every operation,
//   as PyTorch's eager bf16 operations do (each computes in float and
//   rounds its result to nearest even), so a kernel written on bf16r rounds
//   like the plain PyTorch version chained on bf16 tensors.
#pragma once

#include <cuda_bf16.h>

namespace fs {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(double* p, double v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the compute type of a storage type: float for bf16, else itself
template <typename S> struct Compute { using type = S; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

// a bf16 value whose every operation is computed in float and rounded to
// nearest even (the layout of a bf16 plane, so a bf16 tensor's pointer is a
// bf16r pointer)
struct bf16r {
  unsigned short u;
  bf16r() = default;
  __device__ __forceinline__ bf16r(float f) : u(__bfloat16_as_ushort(__float2bfloat16_rn(f))) {}
  __device__ __forceinline__ float f() const { return __bfloat162float(__ushort_as_bfloat16(u)); }
};

__device__ __forceinline__ bf16r operator+(bf16r a, bf16r b) { return bf16r(a.f() + b.f()); }
__device__ __forceinline__ bf16r operator-(bf16r a, bf16r b) { return bf16r(a.f() - b.f()); }
__device__ __forceinline__ bf16r operator*(bf16r a, bf16r b) { return bf16r(a.f() * b.f()); }
__device__ __forceinline__ bf16r operator/(bf16r a, bf16r b) { return bf16r(a.f() / b.f()); }
__device__ __forceinline__ bool operator==(bf16r a, bf16r b) { return a.f() == b.f(); }

}  // namespace fs
