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
// The float and double instantiations are this generic kernel.
//
// bf16 (dtype 2): the TPU kernel computes in its operands' dtype, and so
// does the plain version chained on bf16 tensors, rounding after every
// operation to nearest even. The first bf16 form ran the generic
// kernel on a type that widened both operands of each of its ~13
// operations and rounded the result: 0.0154 ms at 1026^2 against a bound
// of 0.0050 (1.11x the float kernel on half its bytes), held by its
// instruction chains, not its bytes: 2-byte loads issued in three waves
// (the region, then each colour's coefficients), a divide and a modulo per
// region point, half of every warp's lanes idle in each half-step (one
// colour of a row-major map), and 1089 blocks at 1026^2, a second wave of 33
// after the 1056 that fit. The bf16 kernel (rb_sweep_bf16_kernel):
// - a thread owns 4-byte words, each holding one red and one black point,
//   of two rows (a row pair), so it has work in both half-steps: in the
//   first it updates the first-colour point of both words, in the second
//   the other one; no lane idles and nothing divides;
// - its words of the five planes and b, for both colours, are loaded at
//   the start into registers; the iterate region goes into shared memory by
//   cp.async, so every load is in flight before the first barrier;
// - the two same-colour points of a row pair are one bf16x2 value, and
//   the multiplications, additions and subtractions are bf16x2
//   instructions with explicit round-to-nearest (mul/add/sub.rn.bf16x2:
//   one correct rounding each, as the plain version's float operation and
//   its rounding to bf16 give, since float's 24 bits hold 2 * 8 + 2; the
//   .rn keeps ptxas from contracting them into an fma); the division stays
//   a true float division rounded to bf16, or on a grid of at most one
//   block an SM, whose time is its chain's latency, a reciprocal and a
//   product that round alike (quotient_fast) with the true division where
//   they might not;
// - the words of a row start on even linear indices, so on a level of odd
//   width every other row's words start one column to the left: the tile
//   is sheared by a column on those rows (a partition all the same); the
//   wrapper raises on a plane that does not start on 4 bytes;
// - a tile of 14 x 60 points (one row pair a thread, 256 threads, 51
//   registers): 1260 blocks at 1026^2, faster than tiles of 30 and 62 rows
//   (two and four row pairs a thread) that fill one wave.
// It equals the first bf16 form and the plain version bit for bit.
// Measured (NVIDIA H100 80GB HBM3, 700 W, in turns with the first bf16
// form): 1026^2 0.0099-0.0101 ms (0.65x), 513^2 to 9^2 0.65-0.94x, one "mg"
// V-cycle's 52 launches 0.79x; 5^2 and 3^2 (launch-bound, 0.0034 ms) 1.04x
// and 1.06x (PERF.md).
#include <cuda_bf16.h>
#include <cuda_pipeline.h>

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


// ---- bf16 (dtype 2) ----------------------------------------------------------
// Two bf16 values in one 32-bit word, the lower-addressed one in bits 0-15.
__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned sub2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ float lo_f(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// n / d for bf16 values n and d, rounded to bf16 as the plain version rounds
// it (the float quotient rounded once more, which equals the exact
// quotient rounded once, float's 24 bits being at least 2 * 8 + 2): q = n *
// rcp.approx(d), within 3 float ulps of n / d, rounds like n / d unless a
// bf16 rounding boundary (a midpoint between bf16 neighbours) lies within
// 3 ulps of q. n / d of 8-bit significands is never a midpoint itself and
// lies at least 2^-17 (relative) from one, so q within 16 ulps of a
// midpoint, or any operand or q near or off the normal range, is instead
// divided exactly (returns false). True: q rounds to the bf16 quotient.
__device__ __forceinline__ bool quotient_fast(float n, float d, float& q) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  q = n * r;
  const unsigned u = __float_as_uint(q);
  const unsigned eq = (u >> 23) & 0xffu, en = (__float_as_uint(n) >> 23) & 0xffu;
  const unsigned ed = (__float_as_uint(d) >> 23) & 0xffu;
  const bool normal = ed > 8u && ed < 247u;
  if (n == 0.0f) return normal;
  return normal && en > 8u && en < 247u && eq > 16u && eq < 239u && (u & 0xffffu) - 0x7ff0u > 32u;
}

struct Bf16Sweep {
  const unsigned short* a[5];   // aC, aL, aR, aB, aT
  const unsigned short* b;
  const unsigned short* x;
  unsigned short* x_out;
  int N, M;
};

constexpr int kWarps = 8;
constexpr int kTH = 2 * kWarps - 2;   // output rows: 8 row pairs less one row each side
constexpr int kTW = 60;               // output columns: 32 words a row less one each side
constexpr int kXR = kTH + 4;          // shared rows
constexpr int kXW = kTW + 8;          // shared columns: 34 words a row
// a grid of at most this many blocks (a level of at most ~300^2, one block
// or fewer an SM) is latency-bound and takes quotient_fast; a larger one
// is bound by its instructions and divides exactly (fewer of them)
constexpr unsigned kFastQuotientBlocks = 132;

__device__ __forceinline__ void st_word(unsigned short* p, long long o, bool in0, bool in1, unsigned w) {
  if (in0 && in1) *reinterpret_cast<unsigned*>(p + o) = w;
  else if (in0) p[o] = (unsigned short)w;
  else if (in1) p[o + 1] = (unsigned short)(w >> 16);
}

// Block (bx, by) owns the output rows ti0 = 14 by ... ti0 + 13. Level row
// gi's words start on columns c with gi M + c even, i.e. one column to the
// left of the even rows' on the odd rows of a level of odd width (q = 1
// there, else 0); its output columns are c0 - q ... c0 - q + 59, c0 = 60 bx.
// Thread (lane, warp) owns the row pair A = ti0 - 1 + 2 warp (odd), B = A +
// 1, and in each the word w = lane, the columns c0 - q - 2 + 2 lane and + 1:
// the first half-step updates the first colour on all of them (the tile,
// its ring and a column beyond), the second the other colour on the tile
// (the rows and lanes not at the edges). The iterate lives in shared memory
// on the rows ti0 - 2 ... ti0 + 15, row gi's word k at shared column 2 k
// holding level column c0 - q - 4 + 2 k.
template <bool FASTQ>
__global__ void __launch_bounds__(kWarps * 32, 4) rb_sweep_bf16_kernel(Bf16Sweep A, int red_first) {
  __shared__ __align__(16) unsigned short xs[kXR * kXW];
  const int N = A.N, M = A.M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ti0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int qa = M & 1;   // q of the odd rows
  auto in_level = [&](int gi, int c) { return gi >= 0 && gi < N && c >= 0 && c < M; };

  // this thread's words of the five planes and b, rows A and B (none where
  // the pair has no point in the level): one 4-byte load a word inside the
  // level, all issued together; a word at the level's edge loads its point
  const int gi = ti0 - 1 + 2 * warp;
  const int ca = c0 - qa - 2 + 2 * lane, cb = c0 - 2 + 2 * lane;
  const bool live = gi + 1 >= 0 && gi < N && cb + 2 > 0 && ca < M;
  unsigned w[2][6];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h ? cb : ca;
    const bool in0 = live && in_level(gi + h, c), in1 = live && in_level(gi + h, c + 1);
    const long long o = (long long)(gi + h) * M + c;
    const unsigned short* const planes[6] = {A.a[0], A.a[1], A.a[2], A.a[3], A.a[4], A.b};
    if (in0 && in1) {
#pragma unroll
      for (int k = 0; k < 6; ++k) w[h][k] = __ldg(reinterpret_cast<const unsigned*>(planes[k] + o));
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        w[h][k] = (in0 ? (unsigned)__ldg(planes[k] + o) : 0u) | (in1 ? (unsigned)__ldg(planes[k] + o + 1) << 16 : 0u);
    }
  }

  // the iterate region (rows of the warp, words of the lane), by cp.async
  // where a word lies in the level
#pragma unroll 1
  for (int r = warp; r < kXR; r += kWarps) {
    const int g = ti0 - 2 + r;
    for (int k = lane; k < kXW / 2; k += 32) {
      const int c = c0 - ((r & 1) ? qa : 0) - 4 + 2 * k;
      unsigned short* const d = xs + r * kXW + 2 * k;
      const bool in0 = in_level(g, c), in1 = in_level(g, c + 1);
      const long long o = (long long)g * M + c;
      if (in0 && in1) {
        __pipeline_memcpy_async(d, A.x + o, 4);
      } else {
        d[0] = in0 ? A.x[o] : (unsigned short)0;
        d[1] = in1 ? A.x[o + 1] : (unsigned short)0;
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // the half of its word that holds the first colour: row A's word starts
  // on a red point iff qa = 1, row B's always
  const int rf = red_first != 0;
  const int fa = qa ^ rf, fb = 1 ^ rf;
  // Gauss-Seidel values of the row pair's points in halves ha (row A) and
  // hb (row B), as one bf16x2: (b - (A x - aC x)) / safe(aC)
  auto gs_pair = [&](int ha, int hb) -> unsigned {
    const int sa = (2 * warp + 1) * kXW + 2 + 2 * lane + ha;   // A's shared index
    const int sb = (2 * warp + 2) * kXW + 2 + 2 * lane + hb;   // B's
    auto x2 = [&](int ia, int ib) { return (unsigned)xs[ia] | (unsigned)xs[ib] << 16; };
    const unsigned sel = (ha ? 0x32u : 0x10u) | (hb ? 0x7600u : 0x5400u);
    auto c2 = [&](int k) { return __byte_perm(w[0][k], w[1][k], sel); };
    const unsigned c = c2(0);
    const unsigned cx = mul2(c, x2(sa, sb));
    unsigned acc = add2(cx, mul2(c2(1), x2(sa - kXW - qa, sb - kXW + qa)));
    acc = add2(acc, mul2(c2(2), x2(sa + kXW - qa, sb + kXW + qa)));
    acc = add2(acc, mul2(c2(3), x2(sa - 1, sb - 1)));
    acc = add2(acc, mul2(c2(4), x2(sa + 1, sb + 1)));
    const unsigned num = sub2(c2(5), sub2(acc, cx));
    const float n0 = lo_f(num), n1 = hi_f(num);
    const float d0 = lo_f(c) == 0.0f ? 1.0f : lo_f(c), d1 = hi_f(c) == 0.0f ? 1.0f : hi_f(c);
    if constexpr (!FASTQ) {
      return pack_rn(__fdiv_rn(n0, d0), __fdiv_rn(n1, d1));
    } else {
      float q0, q1;
      const bool fast0 = quotient_fast(n0, d0, q0), fast1 = quotient_fast(n1, d1, q1);
      if (!(fast0 && fast1)) {
        if (!fast0) q0 = __fdiv_rn(n0, d0);
        if (!fast1) q1 = __fdiv_rn(n1, d1);
      }
      return pack_rn(q0, q1);
    }
  };

  // first colour everywhere (in place: it reads only the other colour and
  // its own old value)
  const unsigned v1 = live ? gs_pair(fa, fb) : 0u;
  if (in_level(gi, ca + fa)) xs[(2 * warp + 1) * kXW + 2 + 2 * lane + fa] = (unsigned short)v1;
  if (in_level(gi + 1, cb + fb)) xs[(2 * warp + 2) * kXW + 2 + 2 * lane + fb] = (unsigned short)(v1 >> 16);
  __syncthreads();

  // second colour on the tile, and the tile's words out
  if (!live || lane == 0 || lane == 31) return;
  const unsigned v2 = gs_pair(fa ^ 1, fb ^ 1);
  // row A's word: its first-colour half from v1, the other from v2 (the low
  // halves); row B's from the high halves
  const unsigned wa = fa ? __byte_perm(v2, v1, 0x5410) : __byte_perm(v1, v2, 0x5410);
  const unsigned wb = fb ? __byte_perm(v2, v1, 0x7632) : __byte_perm(v1, v2, 0x7632);
  if (warp > 0) st_word(A.x_out, (long long)gi * M + ca, in_level(gi, ca), in_level(gi, ca + 1), wa);
  if (warp < kWarps - 1)
    st_word(A.x_out, (long long)(gi + 1) * M + cb, in_level(gi + 1, cb), in_level(gi + 1, cb + 1), wb);
}

// a 14 x 60 tile a block (1260 blocks at 1026^2; 46 registers, 5 blocks an
// SM), one row pair a thread: the fastest on an H100 of one, two and four
// row pairs a thread at every "mg" level
int launch_bf16(const void* const* op, const void* b, const void* x, void* x_out, int N, int M, int red_first,
                cudaStream_t stream) {
  if (N <= 0 || M <= 0) return cudaErrorInvalidValue;
  Bf16Sweep a{};
  for (int k = 0; k < 5; ++k) a.a[k] = static_cast<const unsigned short*>(op[k]);
  a.b = static_cast<const unsigned short*>(b);
  a.x = static_cast<const unsigned short*>(x);
  a.x_out = static_cast<unsigned short*>(x_out);
  a.N = N;
  a.M = M;
  const dim3 grid((M + kTW - 1) / kTW, (N + kTH - 1) / kTH);
  if (grid.x * grid.y <= kFastQuotientBlocks) rb_sweep_bf16_kernel<true><<<grid, kWarps * 32, 0, stream>>>(a, red_first);
  else rb_sweep_bf16_kernel<false><<<grid, kWarps * 32, 0, stream>>>(a, red_first);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// One red-black sweep. op: 5 planes (aC, aL, aR, aB, aT), b, x, x_out: all
// (N, M); red_first != 0 updates red ((i + j) even) then black, else black
// then red. dtype 0 = float, 1 = double, 2 = bf16 (every operation rounded
// to bf16; every plane, b, x and x_out start on 4 bytes). Returns a
// cudaError_t (0 = launched).
extern "C" int fs_rb_sweep(int dtype, const void* const* op, const void* b, const void* x,
                           void* x_out, int N, int M, int red_first, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return fs::launch<float>(op, b, x, x_out, N, M, red_first, s);
    case 1: return fs::launch<double>(op, b, x, x_out, N, M, red_first, s);
    case 2: return fs::launch_bf16(op, b, x, x_out, N, M, red_first, s);
    default: return cudaErrorInvalidValue;
  }
}
