// fused_rap: one BoxMG level's setup in one launch -- the operator-collapsed
// interpolation weights (boxmg.collapse_weights) and the closed-form 9-point
// Galerkin coarse operator (boxmg.galerkin_closed).
//
// Replaces the TPU kernel fluidsolver_tpu/poisson/pallas_rap.py:250
// (fused_rap, pallas_call at :282). The TPU kernel computes in fine space on
// parity-packed planes because Mosaic has no stride-2 lane access; here each
// thread owns one coarse point and indexes the fine level directly, and the
// outputs are the 8 weight planes and 9 coefficient planes, unpacked.
//
// Bound: it reads the fine operator about once per coarse point's 3x3 fine
// neighbourhood (9 x ncoef loads, mostly L1 hits) and does ~180 triple
// products per coarse point, so at 1026^2 it is a few MB of traffic and a
// few hundred MFLOP: latency- and instruction-bound, run 3 times per hierarchy
// build. A block first computes the weights of its 16x16 coarse tile plus a
// one-point ring into shared memory, so each weight is computed once per
// block and the Galerkin product reads its neighbours' weights from there.
#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kTile = 16;

template <typename T>
struct SmemWeights {
  T (*sw)[kTile + 2][kTile + 2];
  int K0, L0;   // coarse index of smem (1, 1)
  __device__ __forceinline__ T operator()(int q, int k, int l) const {
    return sw[q][k - K0 + 1][l - L0 + 1];
  }
};

template <typename T>
struct Outputs { T* p[17]; };   // 8 weight planes, then 9 coefficient planes

template <typename T, int NC>
__global__ void __launch_bounds__(kTile * kTile)
fused_rap_kernel(Level<T> F, Outputs<T> out, int Nc, int Mc) {
  __shared__ T sw[8][kTile + 2][kTile + 2];
  const int K0 = blockIdx.y * kTile, L0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  // weights on the tile and its one-point ring (zero outside the coarse grid)
  for (int t = tid; t < (kTile + 2) * (kTile + 2); t += kTile * kTile) {
    const int r = t / (kTile + 2), c = t % (kTile + 2);
    T w[8];
    collapse_point<T, NC>(F, K0 - 1 + r, L0 - 1 + c, w);
#pragma unroll
    for (int q = 0; q < 8; ++q) sw[q][r][c] = w[q];
  }
  __syncthreads();
  const int K = K0 + threadIdx.y, L = L0 + threadIdx.x;
  if (K >= Nc || L >= Mc) return;
  const size_t o = (size_t)K * Mc + L;
#pragma unroll
  for (int q = 0; q < 8; ++q) out.p[q][o] = sw[q][threadIdx.y + 1][threadIdx.x + 1];
  T c[9];
  rap_point<T, NC>(F, K, L, SmemWeights<T>{sw, K0, L0}, c);
#pragma unroll
  for (int q = 0; q < 9; ++q) out.p[8 + q][o] = c[q];
}

template <typename T>
int launch(int ncoef, const void* const* op, int N, int M, void* const* out,
           cudaStream_t stream) {
  Level<T> F{};
  for (int k = 0; k < ncoef; ++k) F.a[k] = static_cast<const T*>(op[k]);
  F.N = N;
  F.M = M;
  Outputs<T> o;
  for (int k = 0; k < 17; ++k) o.p[k] = static_cast<T*>(out[k]);
  const int Nc = (N + 1) / 2, Mc = (M + 1) / 2;
  const dim3 block(kTile, kTile), grid((Mc + kTile - 1) / kTile, (Nc + kTile - 1) / kTile);
  if (ncoef == 5) fused_rap_kernel<T, 5><<<grid, block, 0, stream>>>(F, o, Nc, Mc);
  else fused_rap_kernel<T, 9><<<grid, block, 0, stream>>>(F, o, Nc, Mc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// ncoef: 5 or 9 planes at op[0..ncoef); out: 8 weight planes then 9 coarse
// coefficient planes, each (Nc, Mc) contiguous; dtype 0 = float, 1 = double.
// Returns a cudaError_t (0 = launched).
extern "C" int fs_fused_rap(int dtype, int ncoef, const void* const* op, int N, int M,
                            void* const* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float>(ncoef, op, N, M, out, s)
                    : fs::launch<double>(ncoef, op, N, M, out, s);
}
