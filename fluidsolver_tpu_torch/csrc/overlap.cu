// overlap: the overlap accumulation of the sparse VOF advection
// (fluidsolver_tpu_torch/vof/advect.py overlap_from_neighbors).
//
// Replaces the TPU kernel fluidsolver_tpu/vof/pallas_advect.py:157
// (overlap_pallas, pallas_call at :220). Per lane the start polygon (the
// flux-corrected octagon, 8 vertices, or under the no_correction variant
// the plain backtraced quad, 4; fs_overlap and fs_overlap_quad, one
// instantiation each) is clipped against each of the 9
// neighbour cells -- the W, E, S, N edges, then the neighbour's PLIC liquid
// half-plane -- and the areas of the neighbours whose fraction exceeds the
// mixed-cell cutoff are summed; the start polygon's own area comes out too.
//
// Bound: latency. The bytes (per active lane 16 slot values, two indices
// and the 3x3 neighbourhood's fields; ~0.1 us at 3.35 TB/s on the main
// path) lie far below an empty launch; what is left is the chain of five
// dependent clips of one (lane, neighbour) pair, issued by one warp. Only
// the pairs whose neighbour lies above the cutoff count: on the bench
// drop's 16384 lanes (2452 active, a prefix), 14616 of 147456 pairs. The
// fill lanes gather the all-gas corner and hold none. So one block of 9 L
// threads per L lanes:
//   1. one thread per (lane, neighbour) pair reads the neighbour's fraction
//      and plane together and, if the fraction lies above the cutoff, joins
//      the block's list in shared memory, ordered by neighbour so that a
//      warp's chains take like paths; every pair's area slot starts at 0,
//      which is what the select of a full chain gives below the cutoff (NaN
//      included); one thread per lane stages the octagon and forms its
//      shoelace;
//   2. one thread per listed pair runs the chain and writes the pair's area
//      into its slot;
//   3. one thread per lane sums its 9 slots in neighbour order.
// A block whose pairs all lie below the cutoff ends after a gather. A clip
// is the plain version's Sutherland-Hodgman pass (vertex i emitted if
// inside, then the crossing on edge i, each at the count of emissions
// before it: the stable "flagged first, order preserved" compaction) with
// the side tests first and no branch per vertex; one that keeps every
// vertex leaves the polygon where it is. The polygon lives in shared
// memory, [slot][thread] as float2 / double2 in two buffers and a scratch
// slot, so that a vertex index that differs from thread to thread needs no
// local memory. A non-convex octagon can gain more than one vertex per
// clip, so the buffers hold kSlots = 16 vertices like the plain version's
// K; a polygon with more emissions keeps its first 16, as the plain version
// does (the TPU kernel's 13 register slots assume one insertion per clip).
// The quad runs the same chain in the same buffers: its slots 4-7 of the
// start polygon are zeros that no clip reads as vertices (the live mask),
// and a quad that crosses itself keeps its signed shoelace area, as the
// plain version's does.
// On an NVIDIA H100 80GB HBM3 (700 W), bench drop, f32
// (tools/torch_vof_times.py): 0.0070 ms on the swirl lanes against the
// one-thread-a-pair kernel's 0.0186 in turns, 0.0088 against 0.0170 on the
// lanes of the bench step's second advection. fs_overlap_probe runs the
// same grid cut short (an empty launch; the gathers and the cutoff test
// without the chains): the kernel's floors, 0.0025 and 0.0034 ms.
#include <cuda_runtime.h>

#include <cstdint>

namespace fs {
namespace {

constexpr int kSlots = 16;     // advect.K
constexpr int kOctagon = 8;    // the start polygon's slots (the quad fills 4)

// how far a launch runs: the whole kernel, or a cut-short probe
enum Stage { kEmpty = 0, kGather = 1, kFull = 2 };

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// Sutherland-Hodgman clip of a polygon (n vertices, the first min(n,
// kSlots) at in[s * si]) against {a x + b y <= c} into out[s * kStride];
// returns the number of emissions (which may exceed kSlots). If every
// stored vertex is inside, the output is the input: `out` is left alone
// and `moved` is false. Vertex s is emitted if inside, then the crossing on
// edge s (to vertex s + 1, or 0 after the last) if its ends lie on
// opposite sides; the emissions before it place each one. The side tests
// come first, then every store goes to its place or, if not emitted or
// past kSlots, to the scratch slot kSlots: no branch per vertex, so one
// thread's chain keeps its instructions in flight.
template <typename T, int kStride>
__device__ __forceinline__ int clip(const typename Vec2<T>::type* in, int si,
                                    typename Vec2<T>::type* out, int n, T a, T b, T c,
                                    bool& moved) {
  using T2 = typename Vec2<T>::type;
  constexpr int kHalf = kSlots / 2;  // the octagon's slots; the rest only when used
  const int nn = n < kSlots ? n : kSlots;
  T2 v[kSlots];
  unsigned raw = 0;
#pragma unroll
  for (int s = 0; s < kHalf; ++s) {
    v[s] = in[s * si];
    raw |= a * v[s].x + b * v[s].y - c <= T(0) ? 1u << s : 0u;
  }
  if (nn > kHalf) {
#pragma unroll
    for (int s = kHalf; s < kSlots; ++s) {
      v[s] = in[s * si];
      raw |= a * v[s].x + b * v[s].y - c <= T(0) ? 1u << s : 0u;
    }
  }
  const unsigned live = (1u << nn) - 1;
  const unsigned inside = raw & live;
  moved = inside != live;
  if (!moved) return nn;  // nothing clipped (n = 0 included)
  // the side of each vertex's successor (vertex 0 after the last)
  const unsigned next = ((inside >> 1) | ((inside & 1u) << (nn - 1))) & live;
  const unsigned cross = (inside ^ next) & live;
  // bit s: vertex s emitted; bit 16 + s: crossing s emitted
  const unsigned emit = inside | cross << 16;

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (s == kHalf && nn <= kHalf) break;
    const int k = __popc(emit & ((1u << s) - 1) * 0x10001u);
    out[((inside >> s & 1u) && k < kSlots ? k : kSlots) * kStride] = v[s];
  }

  // the crossing on edge s (s = kSlots: none, a store to the scratch slot)
  auto crossing = [&](int s) {
    const bool real = s < kSlots;
    const int sr = real ? s : 0, sn = sr + 1 < nn ? sr + 1 : 0;
    const T2 vi = in[sr * si], vn = in[sn * si];
    const T dv = real ? a * vi.x + b * vi.y - c : T(0);
    const T denom = real ? dv - (a * vn.x + b * vn.y - c) : T(1);
    const T tt = fabs(denom) > T(0) ? dv / (denom == T(0) ? T(1) : denom) : T(0);
    const int k = __popc(emit & ((2u << s) - 1 | ((1u << s) - 1) << 16));
    T2 w;
    w.x = vi.x + tt * (vn.x - vi.x);
    w.y = vi.y + tt * (vn.y - vi.y);
    out[(real && k < kSlots ? k : kSlots) * kStride] = w;
  };
  // a line crosses a convex polygon twice at most: those two without a
  // branch, any further ones in a loop
  const unsigned second = cross & (cross - 1);
  crossing(cross != 0 ? __ffs(cross) - 1 : kSlots);
  crossing(second != 0 ? __ffs(second) - 1 : kSlots);
  for (unsigned rest = second & (second - 1); rest != 0; rest &= rest - 1) crossing(__ffs(rest) - 1);
  return __popc(emit);
}

template <typename T, int L, int kStage, int kStart>
__global__ void __launch_bounds__(9 * L)
overlap_kernel(const T* __restrict__ sx, const T* __restrict__ sy,
               const int64_t* __restrict__ li, const int64_t* __restrict__ lj,
               const T* __restrict__ vf, const uint8_t* __restrict__ valid,
               const T* __restrict__ pnx, const T* __restrict__ pny, const T* __restrict__ pd,
               int M, int m, T dx, T dy, T lo, T* __restrict__ overlap, T* __restrict__ area) {
  using T2 = typename Vec2<T>::type;
  constexpr int NT = 9 * L;
  // a listed pair's two polygon buffers, slot s of thread t at [s][t]
  // (slot kSlots: scratch)
  __shared__ T2 pa[kSlots + 1][NT], pb[kSlots + 1][NT];
  __shared__ T2 octagon[kOctagon][L];  // each lane's start polygon
  __shared__ T plane[NT][3];         // a listed pair's neighbour's nx, ny, d
  __shared__ bool mixed[NT];         // ... and whether it is reconstructed
  __shared__ T contrib[NT];          // contrib[9 * (lane - first lane) + neighbour]
  __shared__ int list[NT];           // the pairs above the cutoff (index into contrib)
  __shared__ int n_list;
  __shared__ int count[9], start[9];  // the list's pairs by neighbour, and where each run starts
  if (kStage == kEmpty) return;
  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * L;
  if (t < 9) count[t] = 0;
  __syncthreads();
  int slot = -1;

  // 1. the cutoff test of every pair, with the neighbour's plane loaded
  // beside its fraction; each lane's start polygon and its area
  {
    const int lane = lane0 + t / 9, nb = t % 9;
    if (lane < m) {
      const size_t q = (size_t)(1 + li[lane] + nb / 3 - 1) * M + (1 + lj[lane] + nb % 3 - 1);
      const T v = vf[q];
      const bool mx = valid[q] != 0;
      const T qnx = pnx[q], qny = pny[q], qd = pd[q];
      if (v > lo) {
        slot = atomicAdd(&count[nb], 1);
        mixed[t] = mx;
        plane[t][0] = qnx;
        plane[t][1] = qny;
        plane[t][2] = qd;
      }
    }
    contrib[t] = T(0);
  }
  if (t < L && lane0 + t < m) {
    const int lane = lane0 + t;
    T x[kStart], y[kStart];
#pragma unroll
    for (int s = 0; s < kStart; ++s) {
      x[s] = sx[(size_t)s * m + lane];
      y[s] = sy[(size_t)s * m + lane];
      octagon[s][t].x = x[s];
      octagon[s][t].y = y[s];
    }
#pragma unroll
    for (int s = kStart; s < kOctagon; ++s) {
      octagon[s][t].x = T(0);
      octagon[s][t].y = T(0);
    }
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < kStart; ++s) {
      const int sn = (s + 1) % kStart;
      acc = acc + (x[s] * y[sn] - x[sn] * y[s]);
    }
    area[lane] = T(0.5) * acc;
  }
  __syncthreads();
  // the list in neighbour order (any order within a neighbour's run)
  if (t == 0) {
    int total = 0;
    for (int k = 0; k < 9; ++k) {
      start[k] = total;
      total += count[k];
    }
    n_list = total;
  }
  __syncthreads();
  if (slot >= 0) list[start[t % 9] + slot] = t;
  __syncthreads();

  // 2. one chain per listed pair; a clip that keeps every vertex leaves
  // the polygon where it is
  const int n_pairs = n_list;
  if (kStage == kFull && n_pairs > 0) {
    if (t < n_pairs) {
      const int p = list[t];
      const int nb = p % 9;
      const int di = nb / 3 - 1, dj = nb % 3 - 1;
      const T x_lo = T(di) * dx, y_lo = T(dj) * dy;
      const bool mx = mixed[p];
      const T qnx = plane[p][0], qny = plane[p][1];
      const T a5 = mx ? qnx : T(0), b5 = mx ? qny : T(0);
      const T c5 = mx ? plane[p][2] + qnx * x_lo + qny * y_lo : T(1);
      const T2* poly = &octagon[0][p / 9];
      int si = L, n = kStart;
      auto step = [&](T a, T b, T c) {
        T2* out = poly == &pa[0][t] ? &pb[0][t] : &pa[0][t];
        bool moved;
        n = clip<T, NT>(poly, si, out, n, a, b, c, moved);
        if (moved) {
          poly = out;
          si = NT;
        }
      };
      step(T(-1), T(0), -x_lo);
      step(T(1), T(0), x_lo + dx);
      step(T(0), T(-1), -y_lo);
      step(T(0), T(1), y_lo + dy);
      step(a5, b5, c5);

      // the shoelace of the clipped polygon, in vertex order
      const int nn = n < kSlots ? n : kSlots;
      T2 v[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots / 2; ++s) v[s] = poly[s * si];
#pragma unroll
      for (int s = kSlots / 2; s < kSlots; ++s) v[s] = v[0];
      if (nn > kSlots / 2) {
#pragma unroll
        for (int s = kSlots / 2; s < kSlots; ++s) v[s] = poly[s * si];
      }
      T acc = T(0);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const T2 w = s + 1 == nn ? v[0] : v[(s + 1) % kSlots];
        const T term = v[s].x * w.y - w.x * v[s].y;
        acc = s < nn ? acc + term : acc;
      }
      contrib[p] = T(0.5) * acc;
    }
    __syncthreads();
  }

  // 3. each lane's 9 areas in neighbour order
  if (t < L && lane0 + t < m) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < 9; ++k) s = s + contrib[9 * t + k];
    overlap[lane0 + t] = s;
  }
}

template <typename T, int L, int kStage, int kStart>
int launch(const void* sx, const void* sy, const void* li, const void* lj, const void* vf,
           const void* valid, const void* nx, const void* ny, const void* d, int M, int m,
           double dx, double dy, double lo, void* overlap, void* area, cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  const int blocks = (m + L - 1) / L;
  overlap_kernel<T, L, kStage, kStart><<<blocks, 9 * L, 0, stream>>>(
      static_cast<const T*>(sx), static_cast<const T*>(sy), static_cast<const int64_t*>(li),
      static_cast<const int64_t*>(lj), static_cast<const T*>(vf),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(nx), static_cast<const T*>(ny),
      static_cast<const T*>(d), M, m, T(dx), T(dy), T(lo), static_cast<T*>(overlap),
      static_cast<T*>(area));
  return cudaGetLastError();
}

template <int kStage, int kStart = kOctagon>
int dispatch(int dtype, const void* sx, const void* sy, const void* li, const void* lj,
             const void* vf, const void* valid, const void* nx, const void* ny, const void* d,
             int M, int m, double dx, double dy, double lo, void* overlap, void* area,
             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float, 16, kStage, kStart>(sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx, dy, lo,
                                         overlap, area, s)
             : launch<double, 8, kStage, kStart>(sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx, dy, lo,
                                         overlap, area, s);
}

}  // namespace
}  // namespace fs

// sx, sy: (8, m) start-polygon vertices (cell-local); li, lj: (m,) int64
// clamped interior lane indices; vf, nx, ny, d: (N, M) with N unused beyond
// the indices; valid: (N, M) bytes; overlap, area: (m,). dtype 0 = float
// (16 lanes per block), 1 = double (8 lanes). Returns a cudaError_t.
extern "C" int fs_overlap(int dtype, const void* sx, const void* sy, const void* li,
                          const void* lj, const void* vf, const void* valid, const void* nx,
                          const void* ny, const void* d, int N, int M, int m, double dx,
                          double dy, double lo, void* overlap, void* area, void* stream) {
  (void)N;
  return fs::dispatch<fs::kFull>(dtype, sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx, dy, lo,
                                 overlap, area, stream);
}

// fs_overlap with a quad start polygon: sx, sy are (4, m).
extern "C" int fs_overlap_quad(int dtype, const void* sx, const void* sy, const void* li,
                               const void* lj, const void* vf, const void* valid, const void* nx,
                               const void* ny, const void* d, int N, int M, int m, double dx,
                               double dy, double lo, void* overlap, void* area, void* stream) {
  (void)N;
  return fs::dispatch<fs::kFull, 4>(dtype, sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx, dy,
                                    lo, overlap, area, stream);
}

// A measurement probe with fs_overlap's arguments after `stage`: the same
// grid cut short, stage 0 an empty launch, stage 1 the gathers, the cutoff
// test, the start areas and the sums without any chain (its time is the
// kernel's gather floor). Never called by the port.
extern "C" int fs_overlap_probe(int stage, int dtype, const void* sx, const void* sy,
                                const void* li, const void* lj, const void* vf,
                                const void* valid, const void* nx, const void* ny,
                                const void* d, int N, int M, int m, double dx, double dy,
                                double lo, void* overlap, void* area, void* stream) {
  (void)N;
  return stage == 0
             ? fs::dispatch<fs::kEmpty>(dtype, sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx,
                                        dy, lo, overlap, area, stream)
             : fs::dispatch<fs::kGather>(dtype, sx, sy, li, lj, vf, valid, nx, ny, d, M, m, dx,
                                         dy, lo, overlap, area, stream);
}
