// The fused PCG iteration outside the preconditioner: step_ab, step_c and
// step_init, each one wrapper call.
//
// Replace the TPU kernels of fluidsolver_tpu/poisson/pallas_cg.py:
//   step_ab   (:109, pallas_call at :251)  Ap = A p, pAp = <p, Ap>,
//             alpha = rz / pAp, x' = x + alpha p, r' = r - alpha Ap,
//             rr = <r', r'>, sum_r = sum(r')
//   step_c    (:287, :426)  z = z_raw - mean(z_raw) (singular),
//             rz_new = <r, z_raw> - mean sum_r, beta = rz_new / rz_prev,
//             p' = z + beta p (or p' = z without p)
//   step_init (:462, :655)  b1 = b - mean(b), x1 = x0 - mean(x0)
//             (singular), bb = <b1, b1>, r_ws = b1 - A x1, the guess kept
//             iff <r_ws, r_ws> < bb; rr0 and sum_r0 of the kept residual
//
// What bounds them on an H100 is device-memory bandwidth (~20 flops per
// point): step_ab must read the five coefficient planes, x, r and p and
// write x' and r'; step_c must read r, z_raw and p and write z and p';
// step_init reads the planes, b and x0 and writes x0' and r0'.
//
// The TPU kernels run a (phase, band) grid in order, so a dot product
// accumulated in phase 0 is complete when phase 1 uses it. Blocks of a CUDA
// grid run in no order. Each kernel here is one cooperative launch
// (cudaLaunchAttributeCooperative: every block is resident) split at its
// reductions by grid-wide barriers. Before a barrier, each thread forms its
// points' values and keeps them in registers (step_ab: Ap and p, with x and
// r loaded for after the barrier; step_c: z_raw and p; step_init: b and x0,
// then b1, x1 and r_ws), and each block writes its partial sums. After it,
// every block reduces the partials itself to the same scalars (alpha; mean
// and beta; the means, then the warm-start test) and its threads finish
// their points from the registers. So each reads and writes each vector
// once, the bytes bound; there is no Ap plane and no one-block finalize
// launch. step_ab's second pair of sums (rr, sum_r) is reduced by the last
// block to finish, picked by an integer ticket. step_init has two barriers
// when the system is singular (the means of b and x0, then the test) and
// one otherwise; phase A's and phase B's partials lie in separate slots, so
// a block past the first barrier cannot overwrite what a slower one still
// reads. What remains above the bound is mostly fixed: the launch, each
// barrier and the dependent L2 round trips of each reduction, about 5-7 us
// a call on an H100 with one barrier (tools/torch_cg_times.py).
//
// Every sum has the bits of one fixed order, that of a "virtual grid" of nb
// = pass_blocks(n) blocks of kThreads threads: virtual thread (b, t) adds its
// points o = b kThreads + t + k nb kThreads in increasing k from T(0), each
// virtual block reduces its threads in the tree s[t] + s[t + w] (w = 128 ...
// 1), and the nb partials are reduced in the 1024-wide tree (zeros past nb).
// A block of a launch of G blocks carries the virtual blocks B, B + G, B +
// 2G, ..., the first kV of them with up to kP points a thread held in
// registers; points past those (larger levels, or fewer resident blocks than
// virtual ones, as in f64) are formed again after the barrier. The sums accumulate in the data type, as the TPU kernel and
// torch.sum do; no float atomics, so iterations repeat exactly. Values
// written by other blocks of the launch are read with __ldcg (L2).
#include <climits>
#include <cooperative_groups.h>

#include "boxmg_device.cuh"

namespace fs {
namespace {

constexpr int kThreads = 256;     // threads of a block, physical and virtual
constexpr int kMaxBlocks = 1024;  // virtual blocks at most = partials per sum
constexpr int kMaxSums = 6;       // partial sums per block (poisson/cuda_cg.py PARTIALS)
static_assert(kMaxBlocks == 4 * kThreads, "grid_total folds four partials a thread");

int pass_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

// ---- the fixed trees ------------------------------------------------------------
constexpr int kTreeRows = 4;  // sums a thread reduces at once (kV virtual blocks x 2)

// the shared memory of the trees: R rows of kThreads values and the totals
// broadcast to the block
template <typename T, int R = kTreeRows>
struct TreeSmem {
  T s[R][kThreads];
  T bcast[R];
};

// In the tree s[t] + s[t + w] over 32 K values, value t = l + 32 k pairs
// with one of the same lane l for every w >= 32: lane l folds its K values
// a[k] = a[k] + a[k + h] (h = K/2 ... 1, i.e. w = 16 K ... 32), and the steps
// w = 16 ... 1 are warp shuffles with the same pairing. Lane 0 gets the total.
template <typename T, int K>
__device__ __forceinline__ T fold_lane(T (&a)[K]) {
#pragma unroll
  for (int h = K / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) a[k] = a[k] + a[k + h];
  }
  T x = a[0];
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, w);
  return x;
}

// The tree s[t] + s[t + w], w = 128 ... 1, of NS sums over the block, in
// one pass through shared memory; the totals are valid in thread 0. Two
// trees need a block barrier between them.
template <typename T, int NS, int R>
__device__ __forceinline__ void tree256(const T (&v)[NS], T (&tot)[NS], TreeSmem<T, R>& sm) {
  static_assert(NS <= R, "TreeSmem holds R sums a thread");
  const int t = threadIdx.x;
#pragma unroll
  for (int q = 0; q < NS; ++q) sm.s[q][t] = v[q];
  __syncthreads();
  if (t < 32) {
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      T a[kThreads / 32];
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) a[k] = sm.s[q][t + 32 * k];
      tot[q] = fold_lane(a);
    }
  }
}

// The trees of the KV virtual blocks v0, v0 + stride, ... (those below nb)
// of NQ sums each, v[jv * NQ + q]; thread 0 writes part[q * kMaxBlocks +
// v].
template <typename T, int KV, int NQ, int R>
__device__ __forceinline__ void write_partials(const T (&v)[KV * NQ], T* part, int v0, int stride,
                                               int nb, TreeSmem<T, R>& sm) {
  T tot[KV * NQ];
  tree256<T, KV * NQ>(v, tot, sm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < KV * NQ; ++m) {
      const int vb = v0 + (m / NQ) * stride;
      if (vb < nb) part[(m % NQ) * kMaxBlocks + vb] = tot[m];
    }
  }
}

// Every thread: the totals of the nb partials of NQ sums (part[q *
// kMaxBlocks + b], written by any block of the launch) in the 1024-wide
// tree. Its steps w = 512 and 256 fold partials t, t + 256, t + 512 and
// t + 768 in thread t; tree256 does the rest.
template <typename T, int NQ, int R>
__device__ __forceinline__ void grid_total(const T* part, int nb, T (&tot)[NQ], TreeSmem<T, R>& sm) {
  const int t = threadIdx.x;
  T v[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    T a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int b = t + u * kThreads;
      a[u] = b < nb ? __ldcg(part + q * kMaxBlocks + b) : T(0);
    }
    v[q] = (a[0] + a[2]) + (a[1] + a[3]);
  }
  T s[NQ];
  tree256<T, NQ>(v, s, sm);
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) sm.bcast[q] = s[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) tot[q] = sm.bcast[q];
}

// The virtual grid of n points: nb virtual blocks, the stride S = nb
// kThreads between a virtual thread's points and, for a level of M columns,
// S split into rows and columns, so that a point's (i, j) steps without a
// division.
struct VGrid {
  int n, nb, S, M, dSi, dSj;
};

// a virtual thread's point of step_ab: flat index o and (i, j)
struct Pt {
  int o, i, j;
  __device__ Pt(const VGrid& g, int v) : o(v * kThreads + threadIdx.x), i(o / g.M), j(o - i * g.M) {}
  __device__ void next(const VGrid& g) {
    o += g.S;
    i += g.dSi;
    j += g.dSj;
    if (j >= g.M) {
      j -= g.M;
      ++i;
    }
  }
};

// registers a thread of step_ab or step_c holds: kV virtual blocks of kP
// points; the occupancy (blocks per SM) the register budget is sized for
template <typename T> struct Shape { static constexpr int kV = 2, kP = 5, kMinBlocks = 4; };
template <> struct Shape<double> { static constexpr int kV = 2, kP = 5, kMinBlocks = 2; };

// ---- step_ab -----------------------------------------------------------------
// scal: [pAp, rr, sum_r, alpha]; part: sums 0 (<p, Ap>), 1 and 2 (rr, sum_r)
// and the ticket in slot 3
template <typename T>
struct AbArgs {
  Level<T> op;
  const T *x, *r, *p, *rz;
  T *x_out, *r_out, *part, *scal;
  VGrid g;
};

// the 5-point (A p)(i, j) of point c, whose own p is pc (apply_coefs' order);
// a neighbour inside the level is f(its p)
template <typename T, typename F>
__device__ __forceinline__ T matvec(const Level<T>& L, const T* __restrict__ p, const Pt& c, T pc, F f) {
  const int N = L.N, M = L.M, o = c.o, i = c.i, j = c.j;
  return apply_coefs<T, 5>([&](int k) { return __ldg(L.a[k] + o); }, i, j, [&](int a, int b) {
    if (a == i && b == j) return pc;
    return (a >= 0 && a < N && b >= 0 && b < M) ? f(__ldg(p + o + (a - i) * M + (b - j))) : T(0);
  });
}

template <typename T>
__device__ __forceinline__ T matvec(const Level<T>& L, const T* __restrict__ p, const Pt& c, T pc) {
  return matvec(L, p, c, pc, [](T v) { return v; });
}

template <typename T, int KV, int KP>
__global__ void __launch_bounds__(kThreads, Shape<T>::kMinBlocks) step_ab_kernel(AbArgs<T> A) {
  static_assert(2 * KV <= kTreeRows, "phase B reduces two sums of each virtual block");
  __shared__ TreeSmem<T> sm;
  const VGrid& g = A.g;
  const int B = blockIdx.x, G = gridDim.x;
  T ap[KV][KP], pv[KV][KP], xv[KV][KP], rv[KV][KP];
  // phase A: Ap, kept with p, and <p, Ap>
  T acc[KV];
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
    acc[jv] = T(0);
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    Pt c(g, v);
#pragma unroll
    for (int k = 0; k < KP; ++k, c.next(g)) {
      if (c.o < g.n) {
        pv[jv][k] = __ldg(A.p + c.o);
        ap[jv][k] = matvec(A.op, A.p, c, pv[jv][k]);
        acc[jv] = acc[jv] + pv[jv][k] * ap[jv][k];
      }
    }
    for (; c.o < g.n; c.next(g)) {
      const T pc = __ldg(A.p + c.o);
      acc[jv] = acc[jv] + pc * matvec(A.op, A.p, c, pc);
    }
  }
  write_partials<T, KV, 1>(acc, A.part, B, G, g.nb, sm);
  for (int v = B + KV * G; v < g.nb; v += G) {
    __syncthreads();
    T a[1] = {T(0)};
    for (Pt c(g, v); c.o < g.n; c.next(g)) {
      const T pc = __ldg(A.p + c.o);
      a[0] = a[0] + pc * matvec(A.op, A.p, c, pc);
    }
    write_partials<T, 1, 1>(a, A.part, v, 0, g.nb, sm);
  }
  // x and r of the register-held points, loaded under the barrier's wait
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    int o = v * kThreads + threadIdx.x;
#pragma unroll
    for (int k = 0; k < KP; ++k, o += g.S) {
      if (o < g.n) {
        xv[jv][k] = __ldg(A.x + o);
        rv[jv][k] = __ldg(A.r + o);
      }
    }
  }
  unsigned* ticket = reinterpret_cast<unsigned*>(A.part + 3 * kMaxBlocks);
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0u;
  cooperative_groups::this_grid().sync();

  T pAp[1];
  grid_total<T, 1>(A.part, g.nb, pAp, sm);
  const T alpha = A.rz[0] / safe(pAp[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    A.scal[0] = pAp[0];
    A.scal[3] = alpha;
  }
  // phase B: x' = x + alpha p, r' = r - alpha Ap, <r', r'> and sum(r')
  auto update = [&](int o, T x, T r, T pc, T a, T& rr, T& sr) {
    const T rn = r - alpha * a;
    A.x_out[o] = x + alpha * pc;
    A.r_out[o] = rn;
    rr = rr + rn * rn;
    sr = sr + rn;
  };
  auto update_again = [&](const Pt& c, T& rr, T& sr) {
    const T pc = __ldg(A.p + c.o);
    update(c.o, __ldg(A.x + c.o), __ldg(A.r + c.o), pc, matvec(A.op, A.p, c, pc), rr, sr);
  };
  T acc2[KV * 2];
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
    acc2[2 * jv] = acc2[2 * jv + 1] = T(0);
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    Pt c(g, v);
#pragma unroll
    for (int k = 0; k < KP; ++k, c.next(g)) {
      if (c.o < g.n) update(c.o, xv[jv][k], rv[jv][k], pv[jv][k], ap[jv][k], acc2[2 * jv], acc2[2 * jv + 1]);
    }
    for (; c.o < g.n; c.next(g)) update_again(c, acc2[2 * jv], acc2[2 * jv + 1]);
  }
  write_partials<T, KV, 2>(acc2, A.part + kMaxBlocks, B, G, g.nb, sm);
  for (int v = B + KV * G; v < g.nb; v += G) {
    __syncthreads();
    T a[2] = {T(0), T(0)};
    for (Pt c(g, v); c.o < g.n; c.next(g)) update_again(c, a[0], a[1]);
    write_partials<T, 1, 2>(a, A.part + kMaxBlocks, v, 0, g.nb, sm);
  }
  // the last block to finish reduces rr and sum_r
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    T tot[2];
    grid_total<T, 2>(A.part + kMaxBlocks, g.nb, tot, sm);
    if (threadIdx.x == 0) {
      A.scal[1] = tot[0];
      A.scal[2] = tot[1];
    }
  }
}

// ---- step_c ------------------------------------------------------------------
// scal: [rz_new, mean, beta]; part: sums 0 (<r, z_raw>) and 1 (sum(z_raw))
template <typename T>
struct CArgs {
  const T *r, *z_raw, *p, *rz_prev, *sum_r;
  int singular;
  T inv_n;
  T *z_out, *p_out, *part, *scal;
  VGrid g;
};

template <typename T, int KV, int KP>
__global__ void __launch_bounds__(kThreads, Shape<T>::kMinBlocks) step_c_kernel(CArgs<T> A) {
  static_assert(2 * KV <= kTreeRows, "phase A reduces two sums of each virtual block");
  __shared__ TreeSmem<T> sm;
  const VGrid& g = A.g;
  const int B = blockIdx.x, G = gridDim.x, t = threadIdx.x;
  const bool has_p = A.p != nullptr;
  T zv[KV][KP], pv[KV][KP];
  // phase A: z_raw, kept with p, <r, z_raw> and sum(z_raw)
  auto sums = [&](int o, T z, T& rz, T& sz) {
    rz = rz + __ldg(A.r + o) * z;
    sz = sz + z;
  };
  T acc[KV * 2];
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
    acc[2 * jv] = acc[2 * jv + 1] = T(0);
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    int o = v * kThreads + t;
#pragma unroll
    for (int k = 0; k < KP; ++k, o += g.S) {
      if (o < g.n) {
        zv[jv][k] = __ldg(A.z_raw + o);
        pv[jv][k] = has_p ? __ldg(A.p + o) : T(0);
        sums(o, zv[jv][k], acc[2 * jv], acc[2 * jv + 1]);
      }
    }
    for (; o < g.n; o += g.S) sums(o, __ldg(A.z_raw + o), acc[2 * jv], acc[2 * jv + 1]);
  }
  write_partials<T, KV, 2>(acc, A.part, B, G, g.nb, sm);
  for (int v = B + KV * G; v < g.nb; v += G) {
    __syncthreads();
    T a[2] = {T(0), T(0)};
    for (int o = v * kThreads + t; o < g.n; o += g.S) sums(o, __ldg(A.z_raw + o), a[0], a[1]);
    write_partials<T, 1, 2>(a, A.part, v, 0, g.nb, sm);
  }
  cooperative_groups::this_grid().sync();

  T tot[2];
  grid_total<T, 2>(A.part, g.nb, tot, sm);
  const T mean = A.singular ? tot[1] * A.inv_n : T(0);
  const T rz_new = A.singular ? tot[0] - mean * A.sum_r[0] : tot[0];
  const T beta = rz_new / safe(A.rz_prev[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    A.scal[0] = rz_new;
    A.scal[1] = mean;
    A.scal[2] = beta;
  }
  // phase B: z = z_raw - mean, p' = z + beta p
  auto finish = [&](int o, T zr, T pc) {
    const T z = A.singular ? zr - mean : zr;
    A.z_out[o] = z;
    if (has_p) A.p_out[o] = z + beta * pc;
  };
  auto finish_again = [&](int o) { finish(o, __ldg(A.z_raw + o), has_p ? __ldg(A.p + o) : T(0)); };
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    int o = v * kThreads + t;
#pragma unroll
    for (int k = 0; k < KP; ++k, o += g.S) {
      if (o < g.n) finish(o, zv[jv][k], pv[jv][k]);
    }
    for (; o < g.n; o += g.S) finish_again(o);
  }
  for (int v = B + KV * G; v < g.nb; v += G) {
    for (int o = v * kThreads + t; o < g.n; o += g.S) finish_again(o);
  }
}

// ---- step_init ---------------------------------------------------------------
// scal: [bb, rr0, sum_r0, mean_b, mean_x, good]; part: sums 0-3 of phase B
// (<b1, b1>, sum(b1), <r_ws, r_ws>, sum(r_ws)) and 4-5 of phase A (sum(b),
// sum(x0)), in slots apart: a block that has passed the first barrier
// writes phase B's partials while a slower one may still read phase A's.
template <typename T>
struct InitArgs {
  Level<T> op;
  const T *b, *x0;   // x0 null: a cold start
  int singular;
  T inv_n;
  T *x_out, *r_out, *part, *scal;
  VGrid g;
};

constexpr int kInitSums = 4;   // phase B's sums
static_assert(kInitSums + 2 <= kMaxSums, "part holds phase A's two sums past phase B's");

template <typename T, int KV, int KP>
__global__ void __launch_bounds__(kThreads, Shape<T>::kMinBlocks) step_init_kernel(InitArgs<T> A) {
  __shared__ TreeSmem<T, KV * kInitSums> sm;
  const VGrid& g = A.g;
  const int B = blockIdx.x, G = gridDim.x, t = threadIdx.x;
  const bool warm = A.x0 != nullptr, singular = A.singular != 0;
  T* const part_a = A.part + kInitSums * kMaxBlocks;
  // the register-held points' b and x0; after phase B b1, x1 and r_ws
  T bv[KV][KP], xv[KV][KP], rv[KV][KP];
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    int o = v * kThreads + t;
#pragma unroll
    for (int k = 0; k < KP; ++k, o += g.S) {
      if (o < g.n) {
        bv[jv][k] = __ldg(A.b + o);
        xv[jv][k] = warm ? __ldg(A.x0 + o) : T(0);
      }
    }
  }
  // phase A (singular): sum(b) and sum(x0), then the means
  T mean_b = T(0), mean_x = T(0);
  if (singular) {
    auto sums = [&](int o, T b, T& sb, T& sx) {
      sb = sb + b;
      if (warm) sx = sx + __ldg(A.x0 + o);
    };
    T acc[KV * 2];
#pragma unroll
    for (int jv = 0; jv < KV; ++jv) {
      acc[2 * jv] = acc[2 * jv + 1] = T(0);
      const int v = B + jv * G;
      if (v >= g.nb) continue;
      int o = v * kThreads + t;
#pragma unroll
      for (int k = 0; k < KP; ++k, o += g.S) {
        if (o < g.n) {
          acc[2 * jv] = acc[2 * jv] + bv[jv][k];
          if (warm) acc[2 * jv + 1] = acc[2 * jv + 1] + xv[jv][k];
        }
      }
      for (; o < g.n; o += g.S) sums(o, __ldg(A.b + o), acc[2 * jv], acc[2 * jv + 1]);
    }
    write_partials<T, KV, 2>(acc, part_a, B, G, g.nb, sm);
    for (int v = B + KV * G; v < g.nb; v += G) {
      __syncthreads();
      T a[2] = {T(0), T(0)};
      for (int o = v * kThreads + t; o < g.n; o += g.S) sums(o, __ldg(A.b + o), a[0], a[1]);
      write_partials<T, 1, 2>(a, part_a, v, 0, g.nb, sm);
    }
    cooperative_groups::this_grid().sync();
    T tot[2];
    grid_total<T, 2>(part_a, g.nb, tot, sm);
    mean_b = tot[0] * A.inv_n;
    mean_x = tot[1] * A.inv_n;
  }
  // phase B: b1 and, warm, r_ws = b1 - A x1 with their sums; a cold start
  // writes its x0' = 0 and r0' = b1 at once
  auto proj_x = [&](T x) { return singular ? x - mean_x : x; };
  auto form = [&](const Pt& c, T b, T x, T& b1, T& x1, T& rws, T* acc) {
    b1 = singular ? b - mean_b : b;
    acc[0] = acc[0] + b1 * b1;
    acc[1] = acc[1] + b1;
    if (warm) {
      x1 = proj_x(x);
      rws = b1 - matvec(A.op, A.x0, c, x1, proj_x);
      acc[2] = acc[2] + rws * rws;
      acc[3] = acc[3] + rws;
    } else {
      A.r_out[c.o] = b1;
      A.x_out[c.o] = T(0);
    }
  };
  auto form_again = [&](const Pt& c, T* acc) {
    T b1, x1, rws;
    form(c, __ldg(A.b + c.o), warm ? __ldg(A.x0 + c.o) : T(0), b1, x1, rws, acc);
  };
  T acc[KV * kInitSums];
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
#pragma unroll
    for (int q = 0; q < kInitSums; ++q) acc[kInitSums * jv + q] = T(0);
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    Pt c(g, v);
#pragma unroll
    for (int k = 0; k < KP; ++k, c.next(g)) {
      if (c.o < g.n) form(c, bv[jv][k], xv[jv][k], bv[jv][k], xv[jv][k], rv[jv][k], acc + kInitSums * jv);
    }
    for (; c.o < g.n; c.next(g)) form_again(c, acc + kInitSums * jv);
  }
  write_partials<T, KV, kInitSums>(acc, A.part, B, G, g.nb, sm);
  for (int v = B + KV * G; v < g.nb; v += G) {
    __syncthreads();
    T a[kInitSums] = {T(0), T(0), T(0), T(0)};
    for (Pt c(g, v); c.o < g.n; c.next(g)) form_again(c, a);
    write_partials<T, 1, kInitSums>(a, A.part, v, 0, g.nb, sm);
  }
  cooperative_groups::this_grid().sync();

  // phase C: the warm-start test, then x0' = good ? x1 : 0 and r0' = good ?
  // r_ws : b1 (a cold start: block 0 only reduces)
  if (!warm && B != 0) return;
  T tot[kInitSums];
  grid_total<T, kInitSums>(A.part, g.nb, tot, sm);
  const bool good = warm && tot[2] < tot[0];
  if (B == 0 && t == 0) {
    A.scal[0] = tot[0];
    A.scal[1] = good ? tot[2] : tot[0];
    A.scal[2] = good ? tot[3] : tot[1];
    A.scal[3] = mean_b;
    A.scal[4] = mean_x;
    A.scal[5] = good ? T(1) : T(0);
  }
  if (!warm) return;
  auto select = [&](int o, T b1, T x1, T rws) {
    A.x_out[o] = good ? x1 : T(0);
    A.r_out[o] = good ? rws : b1;
  };
  auto select_again = [&](const Pt& c) {
    const T b = __ldg(A.b + c.o);
    const T b1 = singular ? b - mean_b : b;
    if (good) {
      const T x1 = proj_x(__ldg(A.x0 + c.o));
      select(c.o, b1, x1, b1 - matvec(A.op, A.x0, c, x1, proj_x));
    } else {
      select(c.o, b1, T(0), T(0));
    }
  };
#pragma unroll
  for (int jv = 0; jv < KV; ++jv) {
    const int v = B + jv * G;
    if (v >= g.nb) continue;
    Pt c(g, v);
#pragma unroll
    for (int k = 0; k < KP; ++k, c.next(g)) {
      if (c.o < g.n) select(c.o, bv[jv][k], xv[jv][k], rv[jv][k]);
    }
    for (; c.o < g.n; c.next(g)) select_again(c);
  }
  for (int v = B + KV * G; v < g.nb; v += G) {
    for (Pt c(g, v); c.o < g.n; c.next(g)) select_again(c);
  }
}

template <typename T>
Level<T> level5(const void* const* op, int N, int M) {
  Level<T> L{};
  for (int k = 0; k < 5; ++k) L.a[k] = static_cast<const T*>(op[k]);
  L.N = N;
  L.M = M;
  return L;
}

// The virtual grid of n points on rows of M columns; false if a flat index
// past the last point would not fit an int.
bool make_vgrid(long long n, int M, VGrid& g) {
  const int nb = pass_blocks(n);
  if (M < 1 || n + (long long)nb * kThreads > INT_MAX) return false;
  g.n = static_cast<int>(n);
  g.nb = nb;
  g.S = nb * kThreads;
  g.M = M;
  g.dSi = g.S / M;
  g.dSj = g.S % M;
  return true;
}

// One cooperative launch of kernel(args) on min(nb, resident) blocks, where
// resident (every block of the kernel that fits on the card at once) is
// queried on the first call and kept in *resident.
template <typename Args>
int launch_resident(void (*kernel)(Args), int* resident, int nb, const Args& args,
                    cudaStream_t stream) {
  if (*resident <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    *resident = sms * per_sm;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb < *resident ? nb : *resident);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
int ab(const void* const* op, const void* x, const void* r, const void* p, const void* rz,
       int N, int M, void* x_out, void* r_out, void* part, void* scal, cudaStream_t s) {
  AbArgs<T> A{};
  if (!make_vgrid((long long)N * M, M, A.g)) return cudaErrorInvalidValue;
  A.op = level5<T>(op, N, M);
  A.x = static_cast<const T*>(x);
  A.r = static_cast<const T*>(r);
  A.p = static_cast<const T*>(p);
  A.rz = static_cast<const T*>(rz);
  A.x_out = static_cast<T*>(x_out);
  A.r_out = static_cast<T*>(r_out);
  A.part = static_cast<T*>(part);
  A.scal = static_cast<T*>(scal);
  static int resident = 0;
  return launch_resident(step_ab_kernel<T, Shape<T>::kV, Shape<T>::kP>, &resident, A.g.nb, A, s);
}

template <typename T>
int c(const void* r, const void* z_raw, const void* p, const void* rz_prev, const void* sum_r,
      int singular, long long n, void* z_out, void* p_out, void* part, void* scal,
      cudaStream_t s) {
  if (singular && !sum_r) return cudaErrorInvalidValue;
  if ((p == nullptr) != (p_out == nullptr)) return cudaErrorInvalidValue;
  CArgs<T> A{};
  if (!make_vgrid(n, 1, A.g)) return cudaErrorInvalidValue;
  A.r = static_cast<const T*>(r);
  A.z_raw = static_cast<const T*>(z_raw);
  A.p = static_cast<const T*>(p);
  A.rz_prev = static_cast<const T*>(rz_prev);
  A.sum_r = static_cast<const T*>(sum_r);
  A.singular = singular;
  A.inv_n = T(1.0 / (double)n);
  A.z_out = static_cast<T*>(z_out);
  A.p_out = static_cast<T*>(p_out);
  A.part = static_cast<T*>(part);
  A.scal = static_cast<T*>(scal);
  static int resident = 0;
  return launch_resident(step_c_kernel<T, Shape<T>::kV, Shape<T>::kP>, &resident, A.g.nb, A, s);
}

template <typename T>
int init(const void* const* op, const void* b, const void* x0, int singular, int N, int M,
         void* x_out, void* r_out, void* part, void* scal, cudaStream_t s) {
  InitArgs<T> A{};
  if (!make_vgrid((long long)N * M, M, A.g)) return cudaErrorInvalidValue;
  A.op = level5<T>(op, N, M);
  A.b = static_cast<const T*>(b);
  A.x0 = static_cast<const T*>(x0);
  A.singular = singular;
  A.inv_n = T(1.0 / ((double)N * M));
  A.x_out = static_cast<T*>(x_out);
  A.r_out = static_cast<T*>(r_out);
  A.part = static_cast<T*>(part);
  A.scal = static_cast<T*>(scal);
  static int resident = 0;
  return launch_resident(step_init_kernel<T, Shape<T>::kV, Shape<T>::kP>, &resident, A.g.nb, A, s);
}

}  // namespace
}  // namespace fs

// Scratch of every entry point: part holds kMaxSums * kMaxBlocks values,
// scal 8, of the data type. dtype 0 = float, 1 = double. Each returns a
// cudaError_t (0 = launched).

// step_ab, one cooperative launch. op: 5 planes (aC, aL, aR, aB, aT) of (N,
// M); x, r, p: (N, M); rz: one value. Writes x_out, r_out (N, M) and
// scal[0..3] = pAp, rr, sum_r, alpha. Ap, a scratch plane of an earlier
// version of the kernel, is not used (may be null).
extern "C" int fs_step_ab(int dtype, const void* const* op, const void* x, const void* r,
                          const void* p, const void* rz, int N, int M, void* x_out, void* r_out,
                          void* Ap, void* part, void* scal, void* stream) {
  (void)Ap;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::ab<float>(op, x, r, p, rz, N, M, x_out, r_out, part, scal, s)
                    : fs::ab<double>(op, x, r, p, rz, N, M, x_out, r_out, part, scal, s);
}

// step_c, one cooperative launch. r, z_raw, p (or null): n values; rz_prev,
// sum_r (null unless singular): one value. Writes z_out, p_out (null iff p
// is null) and scal[0..2] = rz_new, mean, beta.
extern "C" int fs_step_c(int dtype, const void* r, const void* z_raw, const void* p,
                         const void* rz_prev, const void* sum_r, int singular, long long n,
                         void* z_out, void* p_out, void* part, void* scal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
      ? fs::c<float>(r, z_raw, p, rz_prev, sum_r, singular, n, z_out, p_out, part, scal, s)
      : fs::c<double>(r, z_raw, p, rz_prev, sum_r, singular, n, z_out, p_out, part, scal, s);
}

// step_init, one cooperative launch. op: 5 planes of (N, M); b, x0 (null:
// cold start): (N, M). Writes x_out, r_out (N, M) and scal[0..5] = bb, rr0,
// sum_r0, mean_b, mean_x (0 unless singular) and good (1: the guess kept).
extern "C" int fs_step_init(int dtype, const void* const* op, const void* b, const void* x0,
                            int singular, int N, int M, void* x_out, void* r_out, void* part,
                            void* scal, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::init<float>(op, b, x0, singular, N, M, x_out, r_out, part, scal, s)
                    : fs::init<double>(op, b, x0, singular, N, M, x_out, r_out, part, scal, s);
}
