// rb_sweep: one whole red-black Gauss-Seidel sweep of the 5-point operator
// (both colours) in one launch, out of place. The geometric multigrid of
// poisson/mg.py runs it on every level of its V-cycle.
//
// Replaces the TPU kernel fluidsolver_tpu/poisson/pallas_smoother.py:54
// (rb_sweep_pallas, pallas_call at :61), which holds the whole level in VMEM
// and forms the shifted neighbours in registers. That whole-array block is
// the TPU's; here a block owns a 32x32 output tile and holds the iterate on
// the tile plus a 2-cell halo in shared memory (temporal blocking, as in
// fused_smooth.cu). It updates the first colour on the tile plus a 1-cell
// ring in place (a point's update reads its own old value and its
// neighbours of the other colour, which this half-step does not write),
// synchronises, then updates the second colour on the tile and writes x_out.
// The halo is 2 because a second-colour point at the tile's edge needs its
// first-colour neighbours' new values, and those need old values one cell
// further out. Colour parity comes from the level's global indices
// ((i + j) even = red), so odd sides need nothing special; reads outside
// the level are zero, and aC == 0 divides by 1.
//
// Bound: device-memory bandwidth. The sweep reads the five coefficient
// planes, b and x once (the ring's re-reads hit L1/L2) and writes x_out once,
// instead of two passes of shifted reads per colour. Expressions keep the
// operand order of the plain version (boxmg_device.cuh's gs_value: A x -
// aC x, then (b - that) / aC as a true division) and the library is built
// with --fmad=false, so the kernel rounds like the plain PyTorch version.
//
// bf16 (dtype 2): the TPU kernel computes in its operands' dtype, and so
// does the plain version chained on bf16 tensors, rounding after every
// operation. The bf16 instantiation runs the same code on bf16r
// (bf16.cuh), whose every operation is computed in float and rounded to
// nearest even, as PyTorch's bf16 operations are: it is expected to equal
// the plain version bit for bit. The float and double instantiations are
// unchanged.
#include "bf16.cuh"
#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kTile = 32;
constexpr int kHalo = 2;
constexpr int kRegion = kTile + 2 * kHalo;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rb_sweep_kernel(Level<T> op, const T* __restrict__ b, const T* __restrict__ x_in,
                    T* __restrict__ x_out, int red_first) {
  __shared__ T xs[kRegion * kRegion];
  const int N = op.N, M = op.M;
  const int gi0 = blockIdx.y * kTile - kHalo, gj0 = blockIdx.x * kTile - kHalo;
  const int tid = threadIdx.x;

  for (int p = tid; p < kRegion * kRegion; p += kThreads) {
    const int gi = gi0 + p / kRegion, gj = gj0 + p % kRegion;
    xs[p] = (gi >= 0 && gi < N && gj >= 0 && gj < M) ? x_in[(size_t)gi * M + gj] : T(0);
  }
  __syncthreads();
  auto X = [&](int i, int j) { return xs[(i - gi0) * kRegion + (j - gj0)]; };
  auto first = [&](int i, int j) { return (((i + j) & 1) == 0) == (red_first != 0); };

  // first colour on the tile plus a one-cell ring
  constexpr int kRing = kTile + 2;
  for (int p = tid; p < kRing * kRing; p += kThreads) {
    const int gi = gi0 + 1 + p / kRing, gj = gj0 + 1 + p % kRing;
    if (gi >= 0 && gi < N && gj >= 0 && gj < M && first(gi, gj)) {
      const size_t o = (size_t)gi * M + gj;
      const T v = gs_value<T, 5>(op, o, gi, gj, b[o], X);
      xs[(gi - gi0) * kRegion + (gj - gj0)] = v;
    }
  }
  __syncthreads();

  // second colour on the tile, from the first colour's new values
  for (int p = tid; p < kTile * kTile; p += kThreads) {
    const int gi = gi0 + kHalo + p / kTile, gj = gj0 + kHalo + p % kTile;
    if (gi < N && gj < M) {
      const size_t o = (size_t)gi * M + gj;
      x_out[o] = first(gi, gj) ? X(gi, gj) : gs_value<T, 5>(op, o, gi, gj, b[o], X);
    }
  }
}

template <typename T>
int launch(const void* const* op, const void* b, const void* x, void* x_out, int N, int M,
           int red_first, cudaStream_t stream) {
  if (N <= 0 || M <= 0) return cudaErrorInvalidValue;
  Level<T> lv{};
  for (int k = 0; k < 5; ++k) lv.a[k] = static_cast<const T*>(op[k]);
  lv.N = N;
  lv.M = M;
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile);
  rb_sweep_kernel<T><<<grid, kThreads, 0, stream>>>(lv, static_cast<const T*>(b),
                                                    static_cast<const T*>(x),
                                                    static_cast<T*>(x_out), red_first);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// One red-black sweep. op: 5 planes (aC, aL, aR, aB, aT), b, x, x_out: all
// (N, M); red_first != 0 updates red ((i + j) even) then black, else black
// then red. dtype 0 = float, 1 = double, 2 = bf16 (every operation rounded
// to bf16). Returns a cudaError_t (0 = launched).
extern "C" int fs_rb_sweep(int dtype, const void* const* op, const void* b, const void* x,
                           void* x_out, int N, int M, int red_first, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fs::launch<float>(op, b, x, x_out, N, M, red_first, s);
    case 1: return fs::launch<double>(op, b, x, x_out, N, M, red_first, s);
    case 2: return fs::launch<fs::bf16r>(op, b, x, x_out, N, M, red_first, s);
    default: return cudaErrorInvalidValue;
  }
}
