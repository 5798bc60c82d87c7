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
// Bound: bytes. The fine operator is read once and 17 coarse planes are
// written (at 1026^2 with a 5-point operator ~38 MB, 0.0116 ms at 3.35
// TB/s). But a coarse point's weights take up to 16 IEEE divisions and its
// Galerkin product 105 or 169 triple products of ~81 loads, so the kernel
// is as much latency and instruction rate as traffic. One block per tile of
// TK x TL points at a time, in a persistent grid of the resident blocks:
//   1. the line weights of the tile, its one-point ring and a second ring
//      on the high sides into shared memory, then the corner weights of the
//      tile and its ring from them (corners_of): each line weight is formed
//      once (collapse_point on every point forms it twice). The fine points'
//      coefficients that these steps load (and those of the tile's
//      (even, even) points) are kept in shared memory, zero outside the
//      level: every fine point the tile's products read;
//   2. each coarse point's Galerkin coefficients (rap_from) from the kept
//      coefficients and the block's weights, split over G threads a point
//      by coefficient (group_mask).
// Each output's arithmetic is that of collapse_point and rap_point, as in
// the plain version; only who computes it and where its operands come from
// changed. The tile is 16 x 16 with one thread a point on levels of at
// least 2 x 132 such tiles, else 8 x 8 with two, so a small level still
// spreads over the card's 132 SMs.
// Tried and dropped (tools/torch_rap_times.py): copying the fine tile into
// shared memory with cp.async before the weights (the copy was not hidden
// behind the arithmetic), reading the fine level without bounds tests in
// interior tiles (more registers, fewer resident blocks), more threads a
// point or 8 x 8 tiles on the large levels. On an NVIDIA H100 80GB HBM3
// (700 W) at the bench's levels, f32, in turns with the one-thread-a-point
// kernel: 1026^2 0.0250 ms against 0.0359, 513^2 0.0117 against 0.0154,
// 257^2 0.0062 against 0.0078.
#include "boxmg_device.cuh"

namespace fs {
namespace {

// a tile of TK x TL coarse points, G threads a point in the Galerkin step
template <int TK, int TL, int G>
struct Tile {
  static constexpr int kPoints = TK * TL, kThreads = kPoints * G;
  static constexpr int WH = TK + 3, WW = TL + 3;           // weights with their rings
  static constexpr int FH = 2 * TK + 5, FW = 2 * TL + 5;   // the fine points they read
  template <typename T, int NC>
  static constexpr size_t smem() { return sizeof(T) * (8 * WH * WW + NC * FH * FW); }
};

// weight q at coarse (k, l) from the block's 8 planes of WH x WW (the
// tile's (0, 0) at (1, 1))
template <typename T, int WH, int WW>
struct SmemWeights {
  const T* sw;
  int K0, L0;   // coarse index of the tile's (0, 0)
  __device__ __forceinline__ T operator()(int q, int k, int l) const {
    return sw[(q * WH + k - K0 + 1) * WW + l - L0 + 1];
  }
};

template <typename T>
struct Outputs { T* p[17]; };   // 8 weight planes, then 9 coefficient planes

// the coefficients each of a point's G (1 or 2) threads forms (bit q:
// coefficient q): with two, about equal shares of the 105 (5-point) or 169
// (9-point) products, the centre and corners 53 / 85, the edges 52 / 84
template <int G>
__host__ __device__ constexpr unsigned group_mask(int g) {
  return G == 1 ? 0x1ffu : g == 0 ? 0x1e1u : 0x01eu;
}

// the coefficients of mask kMask at coarse (K, L) of a level of N x M fine
// points (A: its coefficients), written to out at o
template <typename T, int NC, unsigned kMask, typename AAcc, typename WAcc>
__device__ __forceinline__ void rap_group(AAcc A, int N, int M, int K, int L, WAcc W, const Outputs<T>& out,
                                          size_t o) {
  T c[9];
  rap_from<T, NC, kMask>(A, N, M, K, L, W, c);
#pragma unroll
  for (int q = 0; q < 9; ++q)
    if ((kMask >> q) & 1u) out.p[8 + q][o] = c[q];
}

// the weights and Galerkin coefficients of tile (K0, L0) of F
template <typename T, int NC, int TK, int TL, int G>
__device__ __forceinline__ void tile_rap(const Level<T>& F, int K0, int L0, T* sw, const Outputs<T>& out, int Nc,
                                         int Mc) {
  using Tl = Tile<TK, TL, G>;
  constexpr int WH = Tl::WH, WW = Tl::WW, PL = WH * WW, FW = Tl::FW, FP = Tl::FH * Tl::FW;
  // the fine points' coefficients as the weights read them: plane k of
  // fine (2 K0 - 2 + u, 2 L0 - 2 + v) at sf[k * FP + u * FW + v], zero
  // outside the level
  T* sf = sw + 8 * PL;
  const auto keep = [&](int u, int v, const T a[9]) {
#pragma unroll
    for (int k = 0; k < NC; ++k) sf[k * FP + u * FW + v] = a[k];
  };
  const int tid = threadIdx.x;
  // 1a. line weights on the tile and its ring, and on a second ring on the
  // high sides: (pS, pN) on its row, (pW, pE) on its column (zero outside
  // the coarse grid); and the coefficients of the tile's (even, even) fine
  // points, which only the Galerkin products read
  for (int t = tid; t < PL; t += Tl::kThreads) {
    const int r = t / WW, c = t % WW;
    const int k = K0 - 1 + r, l = L0 - 1 + c;
    const bool in = k >= 0 && k < Nc && l >= 0 && l < Mc;
    T pW = T(0), pE = T(0), pS = T(0), pN = T(0);
    if (r < WH - 1) {   // fine (2k + 1, 2l)
      T a[9] = {};
      if (in && 2 * k + 1 < F.N) {
        coefs_at<T, NC, false>(F, (size_t)(2 * k + 1) * F.M + 2 * l, a);
        line_x_of(a, pW, pE);
      }
      keep(2 * r + 1, 2 * c, a);
    }
    if (c < WW - 1) {   // fine (2k, 2l + 1)
      T a[9] = {};
      if (in && 2 * l + 1 < F.M) {
        coefs_at<T, NC, false>(F, (size_t)(2 * k) * F.M + 2 * l + 1, a);
        line_y_of(a, pS, pN);
      }
      keep(2 * r, 2 * c + 1, a);
    }
    if (r >= 1 && r <= TK && c >= 1 && c <= TL) {   // fine (2k, 2l)
      T a[9] = {};
      if (in) coefs_at<T, NC, false>(F, (size_t)(2 * k) * F.M + 2 * l, a);
      keep(2 * r, 2 * c, a);
    }
    sw[kPW * PL + t] = pW;
    sw[kPE * PL + t] = pE;
    sw[kPS * PL + t] = pS;
    sw[kPN * PL + t] = pN;
  }
  __syncthreads();
  // 1b. corner weights on the tile and its ring
  for (int t = tid; t < (WH - 1) * (WW - 1); t += Tl::kThreads) {
    const int r = t / (WW - 1), c = t % (WW - 1), o = r * WW + c;
    const int k = K0 - 1 + r, l = L0 - 1 + c;
    T w[8];
    w[kPW] = sw[kPW * PL + o];
    w[kPE] = sw[kPE * PL + o];
    w[kPS] = sw[kPS * PL + o];
    w[kPN] = sw[kPN * PL + o];
    w[kPSW] = w[kPSE] = w[kPNW] = w[kPNE] = T(0);
    T a[9] = {};   // fine (2k + 1, 2l + 1)
    if (k >= 0 && k < Nc && l >= 0 && l < Mc && 2 * k + 1 < F.N && 2 * l + 1 < F.M) {
      coefs_at<T, NC, false>(F, (size_t)(2 * k + 1) * F.M + 2 * l + 1, a);
      corners_of(a, sw[kPS * PL + o + WW], sw[kPN * PL + o + WW], sw[kPW * PL + o + 1], sw[kPE * PL + o + 1], w);
    }
    keep(2 * r + 1, 2 * c + 1, a);
#pragma unroll
    for (int q = kPSW; q < 8; ++q) sw[q * PL + o] = w[q];
  }
  __syncthreads();
  // 2. the Galerkin coefficients from the kept fine points and the weights:
  // thread g of a point's G forms those of group_mask(g) (warp-uniform: a
  // group is kPoints consecutive threads)
  const int pt = tid % Tl::kPoints, g = tid / Tl::kPoints;
  const int K = K0 + pt / TL, L = L0 + pt % TL;
  if (K < Nc && L < Mc) {
    const size_t o = (size_t)K * Mc + L;
    const SmemWeights<T, WH, WW> W{sw, K0, L0};
    const int i0 = 2 * K0 - 2, j0 = 2 * L0 - 2;
    const auto A = [&](int k, int i, int j) { return sf[k * FP + (i - i0) * FW + (j - j0)]; };
    if (g == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q) out.p[q][o] = W(q, K, L);
      rap_group<T, NC, group_mask<G>(0)>(A, F.N, F.M, K, L, W, out, o);
    }
    if constexpr (G > 1) {
      if (g == 1) rap_group<T, NC, group_mask<G>(1)>(A, F.N, F.M, K, L, W, out, o);
    }
  }
  __syncthreads();   // sw and sf are reused by the block's next tile
}

// a persistent grid: block b takes tiles b, b + gridDim.x, ... (tiles_x a
// tile row)
template <typename T, int NC, int TK, int TL, int G>
__global__ void __launch_bounds__(TK * TL * G)
fused_rap_kernel(Level<T> F, Outputs<T> out, int Nc, int Mc, int tiles_x, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
    tile_rap<T, NC, TK, TL, G>(F, t / tiles_x * TK, t % tiles_x * TL, sw, out, Nc, Mc);
}

template <typename T, int NC, int TK, int TL, int G>
cudaError_t launch_tile(const Level<T>& F, const Outputs<T>& o, int Nc, int Mc, cudaStream_t stream) {
  using Tl = Tile<TK, TL, G>;
  constexpr size_t smem = Tl::template smem<T, NC>();
  auto kernel = fused_rap_kernel<T, NC, TK, TL, G>;
  static int resident = 0;   // blocks resident on the card at once
  if (resident == 0) {
    int per_sm = 0, device = 0, sms = 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Tl::kThreads, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident = per_sm * sms;
  }
  const int tiles_x = (Mc + TL - 1) / TL, n_tiles = tiles_x * ((Nc + TK - 1) / TK);
  kernel<<<n_tiles < resident ? n_tiles : resident, Tl::kThreads, smem, stream>>>(F, o, Nc, Mc, tiles_x,
                                                                                   n_tiles);
  return cudaGetLastError();
}

// 16 x 16 coarse tiles with one thread a point where the level has at least
// kMinTiles of them, else 8 x 8 with two (the bench's 129^2 coarse level:
// 81 tiles of 16^2, 289 of 8^2)
constexpr int kMinTiles = 2 * 132;

template <typename T, int NC>
cudaError_t dispatch(const Level<T>& F, const Outputs<T>& o, int Nc, int Mc, cudaStream_t stream) {
  const long tiles16 = (long)((Nc + 15) / 16) * ((Mc + 15) / 16);
  if (tiles16 >= kMinTiles) return launch_tile<T, NC, 16, 16, 1>(F, o, Nc, Mc, stream);
  return launch_tile<T, NC, 8, 8, 2>(F, o, Nc, Mc, stream);
}

template <typename T>
int launch(int ncoef, const void* const* op, int N, int M, void* const* out,
           cudaStream_t stream) {
  if (ncoef != 5 && ncoef != 9) return cudaErrorInvalidValue;
  Level<T> F{};
  for (int k = 0; k < ncoef; ++k) F.a[k] = static_cast<const T*>(op[k]);
  F.N = N;
  F.M = M;
  Outputs<T> o;
  for (int k = 0; k < 17; ++k) o.p[k] = static_cast<T*>(out[k]);
  const int Nc = (N + 1) / 2, Mc = (M + 1) / 2;
  return ncoef == 5 ? dispatch<T, 5>(F, o, Nc, Mc, stream) : dispatch<T, 9>(F, o, Nc, Mc, stream);
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
