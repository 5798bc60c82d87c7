// The BoxMG coarse tail: every level from the tail start (at most
// kMaxTailLevels levels, at most 160 points a side) in one launch each for
// its setup and for its V-cycle.
//
// tail_setup replaces fluidsolver_tpu/poisson/pallas_tail.py:403
// (build_tail_pack_fused, pallas_call at :436): from the tail-finest
// operator it builds every coarser tail level's transfer weights and 9-point
// Galerkin operator. The TPU kernel keeps a dilated pyramid canvas in VMEM
// and forms the Galerkin product by comb probing; here the weights and the
// closed-form product are the device functions fused_rap uses
// (boxmg_device.cuh), so the result equals boxmg.galerkin_closed level by
// level. Like tail_cycle it is bound by its chain of dependent phases, not
// by bytes (the pack is ~0.2 MB on the bench tail): each level's weights
// must be complete before its Galerkin product, and each level before the
// next. So it is one launch of one cluster of kClusterBlocks blocks: every
// level is split into row bands, one a block; a block computes its band's
// weights and a one-point ring into shared memory and forms its points'
// Galerkin coefficients from there (fused_rap.cu's scheme), so a level
// costs two rounds of loads, one block barrier and one cluster barrier
// before the next level reads it (through L2, __ldcg). A point's product
// needs ~81 coefficient loads and 9 sums, so the blocks are small
// (kSetupThreads): a thread gets registers for its loads in flight, where at
// 1024 threads (64 registers) they spilled and the setup ran 1.6x slower
// (tools/torch_tail_setup_times.py).
//
// tail_cycle replaces fluidsolver_tpu/poisson/pallas_tail.py:455
// (tail_cycle, pallas_call at :482): one V(n_pre, n_post) cycle over the
// whole tail, the coarsest level running COARSE_SWEEPS / 2 forward+reverse
// sweep pairs instead of a dense inverse.
//
// What bounds tail_cycle on an H100 is its chain of dependent phases, not
// bytes: the tail is a few hundred KB (its bytes bound is ~0.3 us), but a
// V(2,2) cycle over the bench tail (129^2 .. 9^2) is ~110 colour updates,
// residuals and transfers, each of which must see the whole previous one.
// So the cycle costs (phases) x (barrier + the latency of one phase's loads
// and arithmetic). The design cuts both factors:
// - one launch of one thread-block cluster of kClusterBlocks blocks (the
//   portable size) runs the whole cycle: no launch per level visit;
// - levels of more than kResidentPoints points ("cluster levels", 129^2 and
//   65^2 on the bench tail) are shared by every thread of the cluster, a few
//   points each, in device memory (L2); their phases end in a cluster
//   barrier (~0.7 us). Data one block writes and another reads after the
//   barrier is read with __ldcg (L2, never a stale L1 line); the coefficient
//   and weight planes, which the cycle never writes, go through L1. A point's
//   operands are all loaded before its arithmetic, so that their L2 round
//   trips overlap;
// - the smaller levels ("resident levels", 33^2, 17^2 and 9^2) live in block
//   0's dynamic shared memory for the whole launch (Resident): coefficients
//   and weights, copied in by cp.async while block 0 idles on a small
//   cluster level, the iterate in zero-ringed buffers (a neighbour is one
//   load at a fixed offset), b and r. Block 0 runs their part of the cycle
//   alone with block barriers (~0.05 us); in a smoothing pass each thread
//   keeps its points' coefficients in registers, and the coarsest level's
//   64 half-steps use a named barrier of only the warps that hold its
//   points. The other blocks wait at the next cluster barrier; block 0 hands
//   the result back through a device-memory copy of the first resident
//   level's iterate.
// Colour updates ping-pong between two buffers because a 9-point update reads
// the previous iterate at its same-colour corners. Per point the arithmetic
// is boxmg_device.cuh's (gs_coefs / apply_coefs, restrict_at, prolong_at) in
// the twin's operand order, so the result is the twin's to the last bit.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kThreads = 1024;
constexpr int kCoarsePairs = 16;   // boxmg.COARSE_SWEEPS // 2
constexpr int kClusterBlocks = 8;
constexpr int kResidentPoints = 33 * 33;
constexpr int kOwn = (kResidentPoints + kThreads - 1) / kThreads;   // points per thread on a resident level
constexpr size_t kMaxSharedBytes = 232448;   // what one block may use on sm_90

// one launch of n_blocks blocks of n_threads threads as one cluster
template <typename... Exp, typename... Act>
int launch_cluster(void (*kernel)(Exp...), int n_blocks, int n_threads, size_t smem, cudaStream_t stream,
                   const Act&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(n_threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ---- setup -----------------------------------------------------------------
// Layout of the pack buffer, per level d < n_levels - 1 with coarse size
// S = Nc_d * Mc_d: 8 weight planes (transfer d -> d+1), then the 9
// coefficient planes of level d+1. cuda_tail.py uses the same layout.
//
// Every transfer is shared by the cluster: block r takes the coarse rows
// [K0, K1) of band r. It first computes the weights of its rows and a
// one-point ring into shared memory (zero outside the coarse grid, as
// rap_point reads them), then each coarse point's Galerkin coefficients from
// there, so a weight crosses no barrier but the block's; a cluster barrier
// ends each transfer but the last.
constexpr int kSetupThreads = 256;   // threads of a setup block (no spills at 255 registers)

// the weights of coarse rows K0 - 1 .. K1 and columns -1 .. Mc in shared
// memory: plane q at sw + q * R * P, R = K1 - K0 + 2 rows of P = Mc + 2
template <typename T>
struct BandWeights {
  const T* sw;
  int RP, P, K0;
  __device__ __forceinline__ T operator()(int q, int k, int l) const {
    return sw[q * RP + (k - K0 + 1) * P + l + 1];
  }
};

// rows of the band of a block for a coarse grid of Nc rows
__host__ __device__ constexpr int band_rows(int Nc) { return (Nc + kClusterBlocks - 1) / kClusterBlocks; }

// shared memory of a band of `rows` coarse rows of Mc columns
__host__ __device__ constexpr size_t band_elems(int rows, int Mc) {
  return (size_t)8 * (rows + 2) * (Mc + 2);
}

// rows [K0, K1) of transfer F -> coarse: weights W and coarse coefficients
// C (pack planes of S = Nc Mc); kL2: F was written in this launch
template <typename T, int NC, bool kL2>
__device__ void setup_band(const Level<T>& F, T* W, T* C, int K0, int K1, T* sw) {
  const int Nc = (F.N + 1) / 2, Mc = (F.M + 1) / 2;
  const size_t S = (size_t)Nc * Mc;
  const int P = Mc + 2, RP = (K1 - K0 + 2) * P;
  for (int t = threadIdx.x; t < RP; t += kSetupThreads) {
    T w[8];
    collapse_point<T, NC, kL2>(F, K0 - 1 + t / P, t % P - 1, w);
#pragma unroll
    for (int q = 0; q < 8; ++q) sw[q * RP + t] = w[q];
  }
  __syncthreads();
  const BandWeights<T> wb{sw, RP, P, K0};
  for (int t = threadIdx.x; t < (K1 - K0) * Mc; t += kSetupThreads) {
    const int K = K0 + t / Mc, L = t % Mc;
    const size_t o = (size_t)K * Mc + L;
    T c[9];
    rap_point<T, NC, kL2>(F, K, L, wb, c);
#pragma unroll
    for (int q = 0; q < 8; ++q) W[q * S + o] = wb(q, K, L);
#pragma unroll
    for (int q = 0; q < 9; ++q) C[q * S + o] = c[q];
  }
}

template <typename T, int NC0>
__global__ void __launch_bounds__(kSetupThreads, 1)
tail_setup_kernel(Level<T> F, int n_levels, T* buf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sw = reinterpret_cast<T*>(smem_raw);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  T* p = buf;
  for (int d = 0; d < n_levels - 1; ++d) {
    const int Nc = (F.N + 1) / 2, Mc = (F.M + 1) / 2;
    const size_t S = (size_t)Nc * Mc;
    const int K0 = min(Nc, rank * band_rows(Nc)), K1 = min(Nc, K0 + band_rows(Nc));
    if (K1 > K0) {
      if (d == 0 && NC0 == 5) setup_band<T, 5, false>(F, p, p + 8 * S, K0, K1, sw);
      else if (d == 0) setup_band<T, 9, false>(F, p, p + 8 * S, K0, K1, sw);
      else setup_band<T, 9, true>(F, p, p + 8 * S, K0, K1, sw);
    }
    if (d == n_levels - 2) break;
    cluster.sync();   // level d+1 is complete, and the band's weights are read
    for (int k = 0; k < 9; ++k) F.a[k] = p + (8 + k) * S;
    F.N = Nc;
    F.M = Mc;
    p += 17 * S;
  }
}

// ---- cycle -----------------------------------------------------------------
template <typename T>
struct TailLevel {
  Level<T> op;          // coefficient planes in device memory
  WeightPlanes<T> tr;   // transfer to the next level (unused on the coarsest)
  T* x;                 // iterate (a resident level's: the hand-off copy)
  T* xt;                // ping-pong partner
  T* b;                 // right-hand side
  T* r;                 // residual
  int smem;             // resident level: element offset of its block in shared memory
};

template <typename T>
struct TailArgs {
  TailLevel<T> lv[kMaxTailLevels];
  int n_levels, n_cluster, n_pre, n_post;   // levels d < n_cluster are cluster levels
  T* x_out;
};

// A resident level in block 0's shared memory: its 9 coefficient planes (S
// = N M each), the 8 weight planes of its transfer (Sc each, not on the
// coarsest), the iterate and its ping-pong partner in two zero-ringed
// (N + 2) x (M + 2) buffers xp and xq (a neighbour read is one load at a
// fixed offset, and the ring is the zero outside the level), then b and r.
// The tail-finest level reads b from device memory.
template <typename T>
struct Resident {
  Level<T> op;
  WeightPlanes<T> tr;
  T *xp, *xq, *b, *r;
  __device__ int at(int i, int j) const { return (i + 1) * (op.M + 2) + j + 1; }
};

template <typename T>
__device__ Resident<T> resident(const TailArgs<T>& A, int d, T* sm) {
  const TailLevel<T>& L = A.lv[d];
  Resident<T> R;
  const size_t S = (size_t)L.op.N * L.op.M;
  T* p = sm + L.smem;
  R.op.N = L.op.N;
  R.op.M = L.op.M;
  for (int k = 0; k < 9; ++k) R.op.a[k] = p + k * S;
  p += 9 * S;
  R.tr.Nc = L.tr.Nc;
  R.tr.Mc = L.tr.Mc;
  if (d < A.n_levels - 1) {
    const size_t Sc = (size_t)L.tr.Nc * L.tr.Mc;
    for (int q = 0; q < 8; ++q) R.tr.w[q] = p + q * Sc;
    p += 8 * Sc;
  }
  const size_t SP = (size_t)(L.op.N + 2) * (L.op.M + 2);
  R.xp = p;
  R.xq = p + SP;
  R.b = d == 0 ? L.b : p + 2 * SP;
  R.r = p + 2 * SP + S;
  return R;
}

// The threads that share a level's points, and their barrier.
struct ClusterTeam {   // every thread of the cluster (block 0's last)
  int tid, n;
  __device__ void sync() const { cooperative_groups::this_cluster().sync(); }
};
struct BlockTeam {     // block 0's threads below n (a multiple of 32)
  int tid, n;
  __device__ void sync() const {
    if (n == kThreads) __syncthreads();
    else asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
  }
};

// kL2: the level lives in device memory, where other blocks write it
template <typename T, bool kL2>
__device__ __forceinline__ T rd(const T* p, int i, int j, int N, int M) {
  return (i >= 0 && i < N && j >= 0 && j < M) ? ldo<T, kL2>(p, i * M + j) : T(0);
}

// A point's coefficients and its neighbourhood of the iterate, all loaded
// before any arithmetic so that the loads are in flight together; then
// boxmg_device.cuh's arithmetic on the loaded values.
template <typename T, int NC>
struct Loaded {
  T c[NC], x[NC];
  template <typename XAcc>
  __device__ __forceinline__ Loaded(const Level<T>& op, int o, int i, int j, XAcc X) {
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      c[k] = op.a[k][o];
      x[k] = X(i + off_i(k), j + off_j(k));
    }
  }
  __device__ __forceinline__ T apply() const {
    return apply_coefs<T, NC>([&](int k) { return c[k]; }, 0, 0,
                              [&](int di, int dj) { return x[coef_index(di, dj)]; });
  }
  __device__ __forceinline__ T gs(T b) const {
    return gs_coefs<T, NC>([&](int k) { return c[k]; }, 0, 0, b,
                           [&](int di, int dj) { return x[coef_index(di, dj)]; });
  }
};

// -- the phases of a cluster level (device memory, the whole cluster) --
// one colour half-step: dst <- src with the colour's points replaced by
// their Gauss-Seidel values; src == nullptr is a zero iterate
template <typename T, int NC, typename Team>
__device__ void half_step(const Level<T>& op, const T* b, const T* src, T* dst, bool red,
                          const Team& tm) {
  const int N = op.N, M = op.M;
  auto X = [&](int i, int j) { return src ? rd<T, true>(src, i, j, N, M) : T(0); };
  for (int p = tm.tid; p < N * M; p += tm.n) {
    const int i = p / M, j = p % M;
    T v = src ? ldo<T, true>(src, p) : T(0);
    if ((((i + j) & 1) == 0) == red) {
      const T bp = ldo<T, true>(b, p);
      v = Loaded<T, NC>(op, p, i, j, X).gs(bp);
    }
    dst[p] = v;
  }
  tm.sync();
}

// 2 n_sweeps half-steps from x (zero: a zero iterate), the first colour red
// when red_first; x and xt swap per half-step, an even count, so the result
// is in x. With last, the final half-step writes there instead (n_sweeps =
// 0: x is copied there).
template <typename T, int NC, typename Team>
__device__ void smooth(const Level<T>& op, const T* b, T* x, T* xt, bool zero, bool red_first,
                       int n_sweeps, const Team& tm, T* last = nullptr) {
  for (int h = 0; h < 2 * n_sweeps; ++h) {
    T* dst = (last && h == 2 * n_sweeps - 1) ? last : xt;
    half_step<T, NC>(op, b, zero ? nullptr : x, dst, ((h & 1) == 0) == red_first, tm);
    T* t = x;
    x = xt;
    xt = t;
    zero = false;
  }
  if (n_sweeps == 0 && last) {
    for (int p = tm.tid; p < op.N * op.M; p += tm.n) last[p] = zero ? T(0) : ldo<T, true>(x, p);
    tm.sync();
  }
}

// the coarsest level: symmetric forward+reverse sweep pairs from zero
template <typename T, typename Team>
__device__ void coarsest(const Level<T>& op, const T* b, T* x, T* xt, const Team& tm) {
  for (int h = 0; h < 4 * kCoarsePairs; ++h) {
    half_step<T, 9>(op, b, h == 0 ? nullptr : x, xt, (h & 3) == 0 || (h & 3) == 3, tm);
    T* t = x;
    x = xt;
    xt = t;
  }
}

// r <- b - A x (x == nullptr: zero)
template <typename T, int NC, typename Team>
__device__ void residual(const Level<T>& op, const T* b, const T* x, T* r, const Team& tm) {
  const int N = op.N, M = op.M;
  auto X = [&](int i, int j) { return x ? rd<T, true>(x, i, j, N, M) : T(0); };
  for (int p = tm.tid; p < N * M; p += tm.n) {
    const T bp = ldo<T, true>(b, p);
    r[p] = bp - Loaded<T, NC>(op, p, p / M, p % M, X).apply();
  }
  tm.sync();
}

// bc <- P^T r for the (N, M) residual r (kL2: r in device memory, else in
// block 0's shared memory)
template <typename T, bool kL2, typename Team>
__device__ void restrict_to(int N, int M, const T* r, const WeightPlanes<T>& tr, T* bc,
                            const Team& tm) {
  auto R = [&](int i, int j) { return rd<T, kL2>(r, i, j, N, M); };
  for (int p = tm.tid; p < tr.Nc * tr.Mc; p += tm.n)
    bc[p] = restrict_at<T>(p / tr.Mc, p % tr.Mc, R, tr);
  tm.sync();
}

// x <- x + P ec on the (N, M) level (x_in == nullptr: x is zero)
template <typename T, typename Team>
__device__ void prolong_add(int N, int M, const T* x_in, T* x, const T* ec,
                            const WeightPlanes<T>& tr, const Team& tm) {
  auto E = [&](int k, int l) { return rd<T, true>(ec, k, l, tr.Nc, tr.Mc); };
  for (int p = tm.tid; p < N * M; p += tm.n)
    x[p] = (x_in ? ldo<T, true>(x_in, p) : T(0)) + prolong_at<T>(p / M, p % M, E, tr);
  tm.sync();
}

// -- the phases of a resident level (block 0's shared memory) --
// n_half colour half-steps on a resident level by block 0's first n threads
// (n a multiple of 32, each thread at most kOwn points, whose coefficients
// and right-hand side it keeps in registers). Half-step h updates the red
// points when h is even (kind 0, pre-smoothing), odd (kind 1,
// post-smoothing) or 0 or 3 mod 4 (kind 2, the coarsest level's forward +
// reverse pairs), the black ones otherwise. The iterate ping-pongs from xp
// to xq and back, an even count, so it ends in xp; with last, the final
// half-step also writes its points there (n_half = 0: xp is copied there).
template <typename T, int NC>
__device__ void sweeps_resident(const Resident<T>& R, int n, int n_half, int kind, T* last) {
  const int N = R.op.N, M = R.op.M, P = M + 2, S = N * M;
  const BlockTeam tm{(int)threadIdx.x, n};
  T a[kOwn][NC], bv[kOwn];
  int pt[kOwn], at[kOwn];
  bool red[kOwn];
#pragma unroll
  for (int u = 0; u < kOwn; ++u) {
    const int p = tm.tid + u * n, q = min(p, S - 1);
    const int i = q / M, j = q % M;
    pt[u] = p < S ? p : -1;
    at[u] = R.at(i, j);
    red[u] = ((i + j) & 1) == 0;
#pragma unroll
    for (int k = 0; k < NC; ++k) a[u][k] = R.op.a[k][q];
    bv[u] = R.b[q];
  }
  T* src = R.xp;
  T* dst = R.xq;
  for (int h = 0; h < n_half; ++h) {
    const bool colour = kind == 0 ? (h & 1) == 0 : kind == 1 ? (h & 1) == 1 : ((h & 3) == 0 || (h & 3) == 3);
#pragma unroll
    for (int u = 0; u < kOwn; ++u) {
      if (pt[u] < 0) continue;
      const int o = at[u];
      auto X = [&](int di, int dj) { return src[o + di * P + dj]; };
      T v = src[o];
      if (red[u] == colour) v = gs_coefs<T, NC>([&](int k) { return a[u][k]; }, 0, 0, bv[u], X);
      dst[o] = v;
      if (last && h == n_half - 1) last[pt[u]] = v;
    }
    tm.sync();
    T* t = src;
    src = dst;
    dst = t;
  }
  if (n_half == 0 && last) {
#pragma unroll
    for (int u = 0; u < kOwn; ++u)
      if (pt[u] >= 0) last[pt[u]] = src[at[u]];
    tm.sync();
  }
}

// the team of a resident level's sweeps: a thread per point, at most kThreads
template <typename T>
__device__ int sweep_team(const Resident<T>& R) {
  return min(kThreads, (R.op.N * R.op.M + 31) / 32 * 32);
}

// block 0 starts copying the resident levels' coefficient and weight planes
// into shared memory (cp.async: the copies are in flight while the cluster
// levels run; resident_cycle waits for them) and zeroes their iterates'
// buffers, ring and zero start in one
template <typename T, int NC0>
__device__ void stage_resident(const TailArgs<T>& A, T* sm) {
  for (int d = A.n_cluster; d < A.n_levels; ++d) {
    const TailLevel<T>& L = A.lv[d];
    const Resident<T> R = resident(A, d, sm);
    const int S = L.op.N * L.op.M;
    for (int k = 0; k < (d == 0 ? NC0 : 9); ++k) {
      const T* src = L.op.a[k];
      T* dst = const_cast<T*>(R.op.a[k]);
      for (int p = threadIdx.x; p < S; p += kThreads) __pipeline_memcpy_async(dst + p, src + p, sizeof(T));
    }
    if (d < A.n_levels - 1) {
      const int Sc = L.tr.Nc * L.tr.Mc;
      for (int q = 0; q < 8; ++q) {
        const T* src = L.tr.w[q];
        T* dst = const_cast<T*>(R.tr.w[q]);
        for (int p = threadIdx.x; p < Sc; p += kThreads) __pipeline_memcpy_async(dst + p, src + p, sizeof(T));
      }
    }
    for (int p = threadIdx.x; p < 2 * (L.op.N + 2) * (L.op.M + 2); p += kThreads) R.xp[p] = T(0);
  }
  __pipeline_commit();
}

// cluster level d on the way down: pre-smooth from zero, residual, restrict
// (into device memory, or by block 0 into the first resident level)
template <typename T, int NC>
__device__ void cluster_down(const TailArgs<T>& A, int d, T* sm, const ClusterTeam& all) {
  const TailLevel<T>& L = A.lv[d];
  const Level<T> op = L.op;
  const WeightPlanes<T> tr = L.tr;
  T* x = L.x;
  smooth<T, NC>(op, L.b, x, L.xt, true, true, A.n_pre, all);
  residual<T, NC>(op, L.b, A.n_pre > 0 ? x : nullptr, L.r, all);
  if (d + 1 < A.n_cluster)
    restrict_to<T, true>(op.N, op.M, L.r, tr, A.lv[d + 1].b, all);
  else if (cooperative_groups::this_cluster().block_rank() == 0)
    restrict_to<T, true>(op.N, op.M, L.r, tr, resident(A, d + 1, sm).b,
                         BlockTeam{(int)threadIdx.x, kThreads});
}

// cluster level d on the way up: add the coarse correction, post-smooth
// (black first); the tail-finest level's last half-step writes x_out
template <typename T, int NC>
__device__ void cluster_up(const TailArgs<T>& A, int d, const ClusterTeam& all) {
  const TailLevel<T>& L = A.lv[d];
  const Level<T> op = L.op;
  const WeightPlanes<T> tr = L.tr;
  T* x = L.x;
  prolong_add<T>(op.N, op.M, A.n_pre > 0 ? x : nullptr, x, A.lv[d + 1].x, tr, all);
  smooth<T, NC>(op, L.b, x, L.xt, false, false, A.n_post, all, d == 0 ? A.x_out : nullptr);
}

// resident level d on the way down: pre-smooth from zero, residual, restrict
template <typename T, int NC>
__device__ void resident_down(const TailArgs<T>& A, int d, T* sm, const BlockTeam& blk) {
  const Resident<T> R = resident(A, d, sm);
  const int n = sweep_team(R), M = R.op.M, P = M + 2;
  if (blk.tid < n) sweeps_resident<T, NC>(R, n, 2 * A.n_pre, 0, nullptr);
  __syncthreads();
  for (int p = blk.tid; p < R.op.N * M; p += blk.n) {
    const int i = p / M, j = p % M, o = R.at(i, j);
    const T* x = R.xp;
    R.r[p] = R.b[p] - Loaded<T, NC>(R.op, p, i, j, [&](int ii, int jj) { return x[o + (ii - i) * P + jj - j]; }).apply();
  }
  blk.sync();
  restrict_to<T, false>(R.op.N, M, R.r, R.tr, resident(A, d + 1, sm).b, blk);
}

// resident level d on the way up: add the coarse correction, post-smooth
// (black first); the tail-finest level's last half-step also writes x_out
template <typename T, int NC>
__device__ void resident_up(const TailArgs<T>& A, int d, T* sm, const BlockTeam& blk) {
  const Resident<T> R = resident(A, d, sm), C = resident(A, d + 1, sm);
  const int M = R.op.M;
  auto E = [&](int k, int l) { return C.xp[C.at(k, l)]; };
  for (int p = blk.tid; p < R.op.N * M; p += blk.n) {
    const int o = R.at(p / M, p % M);
    R.xp[o] = R.xp[o] + prolong_at<T>(p / M, p % M, E, R.tr);
  }
  blk.sync();
  const int n = sweep_team(R);
  if (blk.tid < n) sweeps_resident<T, NC>(R, n, 2 * A.n_post, 1, d == 0 ? A.x_out : nullptr);
  __syncthreads();
}

// block 0: the cycle over the resident levels, then the hand-off copy of
// the first one's iterate to device memory when cluster levels lie above
template <typename T, int NC0>
__device__ void resident_cycle(const TailArgs<T>& A, T* sm) {
  const int nl = A.n_levels, nc = A.n_cluster;
  const BlockTeam blk{(int)threadIdx.x, kThreads};
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int d = nc; d < nl - 1; ++d) {
    if (d == 0) resident_down<T, NC0>(A, d, sm, blk);
    else resident_down<T, 9>(A, d, sm, blk);
  }
  {
    const Resident<T> R = resident(A, nl - 1, sm);
    const int n = sweep_team(R);
    if (blk.tid < n) sweeps_resident<T, 9>(R, n, 4 * kCoarsePairs, 2, nullptr);
    __syncthreads();
  }
  for (int d = nl - 2; d >= nc; --d) {
    if (d == 0) resident_up<T, NC0>(A, d, sm, blk);
    else resident_up<T, 9>(A, d, sm, blk);
  }
  if (nc > 0) {
    const Resident<T> R = resident(A, nc, sm);
    T* out = A.lv[nc].x;
    const int M = R.op.M;
    for (int p = blk.tid; p < R.op.N * M; p += blk.n) out[p] = R.xp[R.at(p / M, p % M)];
  }
}

template <typename T, int NC0>
__global__ void __launch_bounds__(kThreads, 1) tail_cycle_kernel(const __grid_constant__ TailArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const bool lead = cluster.block_rank() == 0;
  const int nb = (int)cluster.num_blocks();
  const ClusterTeam all{(int)((nb - 1 - cluster.block_rank()) * kThreads + threadIdx.x), nb * kThreads};
  const int nl = A.n_levels, nc = A.n_cluster;
  // block 0 holds the cluster's last points, so it has none on a cluster
  // level of at most (nb - 1) kThreads points: it stages the resident levels
  // at the first such level, else at once
  int stage_at = -1;
  for (int d = 0; d < nc && d < nl - 1 && stage_at < 0; ++d)
    if (A.lv[d].op.N * A.lv[d].op.M <= (nb - 1) * kThreads) stage_at = d;
  if (lead && nc < nl && stage_at < 0) stage_resident<T, NC0>(A, sm);
  // descent over the cluster levels
  for (int d = 0; d < nc && d < nl - 1; ++d) {
    if (lead && nc < nl && d == stage_at) stage_resident<T, NC0>(A, sm);
    if (d == 0) cluster_down<T, NC0>(A, d, sm, all);
    else cluster_down<T, 9>(A, d, sm, all);
  }
  if (nc == nl) {   // the coarsest level is a cluster level
    const TailLevel<T>& L = A.lv[nl - 1];
    const Level<T> op = L.op;
    coarsest<T>(op, L.b, L.x, L.xt, all);
  } else {
    if (lead) resident_cycle<T, NC0>(A, sm);
    if (nc == 0) return;
    all.sync();
  }
  // ascent over the cluster levels
  for (int d = min(nc, nl - 1) - 1; d >= 0; --d) {
    if (d == 0) cluster_up<T, NC0>(A, d, all);
    else cluster_up<T, 9>(A, d, all);
  }
}

template <typename T, int NC0>
int launch_setup(const Level<T>& F, int n_levels, T* buf, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(tail_setup_kernel<T, NC0>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  return launch_cluster(tail_setup_kernel<T, NC0>, kClusterBlocks, kSetupThreads, smem, stream, F,
                        n_levels, buf);
}

template <typename T>
int setup(int ncoef0, const void* const* op0, int N, int M, int n_levels, void* buf,
          cudaStream_t stream) {
  if (n_levels < 2 || n_levels > kMaxTailLevels) return cudaErrorInvalidValue;
  Level<T> F{};
  for (int k = 0; k < ncoef0; ++k) F.a[k] = static_cast<const T*>(op0[k]);
  F.N = N;
  F.M = M;
  // the widest band (the first transfer's) sets the shared memory
  const int Nc = (N + 1) / 2, Mc = (M + 1) / 2;
  const size_t smem = band_elems(band_rows(Nc), Mc) * sizeof(T);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  return ncoef0 == 5 ? launch_setup<T, 5>(F, n_levels, static_cast<T*>(buf), smem, stream)
                     : launch_setup<T, 9>(F, n_levels, static_cast<T*>(buf), smem, stream);
}

// one launch of the cycle kernel, raising its shared-memory limit first
// where this launch needs more than an earlier one
template <typename T, int NC0>
int launch_cycle(const TailArgs<T>& A, int n_blocks, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(tail_cycle_kernel<T, NC0>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  return launch_cluster(tail_cycle_kernel<T, NC0>, n_blocks, kThreads, smem, stream, A);
}

template <typename T>
int cycle(int ncoef0, const void* const* op0, const void* buf, const void* b, void* x_out,
          void* scratch, int N, int M, int n_levels, int n_pre, int n_post,
          cudaStream_t stream) {
  if (n_levels < 2 || n_levels > kMaxTailLevels) return cudaErrorInvalidValue;
  TailArgs<T> A{};
  A.n_levels = n_levels;
  A.n_pre = n_pre;
  A.n_post = n_post;
  A.x_out = static_cast<T*>(x_out);
  const T* p = static_cast<const T*>(buf);
  T* s = static_cast<T*>(scratch);
  A.n_cluster = n_levels;
  for (int d = 0; d < n_levels; ++d) {
    TailLevel<T>& L = A.lv[d];
    L.op.N = N;
    L.op.M = M;
    const size_t S = (size_t)N * M;
    if (S <= (size_t)kResidentPoints && A.n_cluster == n_levels) A.n_cluster = d;
    if (d == 0)
      for (int k = 0; k < ncoef0; ++k) L.op.a[k] = static_cast<const T*>(op0[k]);
    // scratch per level: x, xt, r, and b below the tail-finest level
    L.x = s;
    L.xt = s + S;
    L.r = s + 2 * S;
    L.b = d == 0 ? const_cast<T*>(static_cast<const T*>(b)) : s + 3 * S;
    s += 4 * S;
    if (d < n_levels - 1) {
      const int Nc = (N + 1) / 2, Mc = (M + 1) / 2;
      const size_t Sc = (size_t)Nc * Mc;
      for (int q = 0; q < 8; ++q) L.tr.w[q] = p + q * Sc;
      L.tr.Nc = Nc;
      L.tr.Mc = Mc;
      for (int k = 0; k < 9; ++k) A.lv[d + 1].op.a[k] = p + (8 + k) * Sc;
      p += 17 * Sc;
      N = Nc;
      M = Mc;
    }
  }
  // shared memory of the resident levels (the layout of Resident): 9
  // coefficient planes, 8 weight planes, two zero-ringed buffers, b and r.
  // Levels of at most 33^2 points need under 180 KB in double.
  size_t smem = 0;
  for (int d = A.n_cluster; d < n_levels; ++d) {
    TailLevel<T>& L = A.lv[d];
    L.smem = (int)(smem / sizeof(T));
    smem += sizeof(T) * (11 * L.op.N * L.op.M + 2 * (L.op.N + 2) * (L.op.M + 2));
    if (d < n_levels - 1) smem += 8 * sizeof(T) * L.tr.Nc * L.tr.Mc;
  }
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const int n_blocks = A.n_cluster == 0 ? 1 : kClusterBlocks;
  return ncoef0 == 5 ? launch_cycle<T, 5>(A, n_blocks, smem, stream)
                     : launch_cycle<T, 9>(A, n_blocks, smem, stream);
}

// n_syncs empty barriers: the cost of the dependent phases alone
// (chip_smoke.py's floor); n_threads = 0: of the whole cluster, else a named
// barrier of each block's first n_threads threads (kThreads: the block)
__global__ void __launch_bounds__(kThreads) sync_probe_kernel(int n_syncs, int n_threads) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (n_threads == 0)
    for (int s = 0; s < n_syncs; ++s) cluster.sync();
  else if ((int)threadIdx.x < n_threads)
    for (int s = 0; s < n_syncs; ++s) BlockTeam{(int)threadIdx.x, n_threads}.sync();
}

}  // namespace
}  // namespace fs

// Tail setup. op0: ncoef0 (5 or 9) planes of the (N, M) tail-finest level;
// buf: the pack buffer (layout above), sum over d < n_levels-1 of
// 17 * Nc_d * Mc_d elements. dtype 0 = float, 1 = double.
extern "C" int fs_tail_setup(int dtype, int ncoef0, const void* const* op0, int N, int M,
                             int n_levels, void* buf, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;  // float or double only
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::setup<float>(ncoef0, op0, N, M, n_levels, buf, s)
                    : fs::setup<double>(ncoef0, op0, N, M, n_levels, buf, s);
}

// One tail V-cycle for right-hand side b (N, M) into x_out (N, M). scratch:
// 4 * N_d * M_d elements per level d. dtype 0 = float, 1 = double.
extern "C" int fs_tail_cycle(int dtype, int ncoef0, const void* const* op0, const void* buf,
                             const void* b, void* x_out, void* scratch, int N, int M,
                             int n_levels, int n_pre, int n_post, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;  // float or double only
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? fs::cycle<float>(ncoef0, op0, buf, b, x_out, scratch, N, M, n_levels, n_pre, n_post, s)
      : fs::cycle<double>(ncoef0, op0, buf, b, x_out, scratch, N, M, n_levels, n_pre, n_post, s);
}

// n_syncs empty barriers in one cluster of n_blocks blocks of 1024 threads:
// cluster barriers (n_threads = 0) or named barriers of each block's first
// n_threads threads (a multiple of 32)
extern "C" int fs_sync_probe(int n_blocks, int n_syncs, int n_threads, void* stream) {
  return fs::launch_cluster(fs::sync_probe_kernel, n_blocks, fs::kThreads, 0, static_cast<cudaStream_t>(stream),
                            n_syncs, n_threads);
}
