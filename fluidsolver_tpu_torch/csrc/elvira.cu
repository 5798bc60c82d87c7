// elvira: the 12-candidate ELVIRA reconstruction of every interior mixed
// cell of a VOF field (fluidsolver_tpu_torch/vof/plic.py elvira_candidates).
//
// Replaces the TPU kernel fluidsolver_tpu/vof/pallas_elvira.py:51
// (elvira_pallas, pallas_call at :148), which streams row bands with 8-row
// halos through VMEM and evaluates every candidate on every cell.
//
// Bound: memory. The field is read once and 3 planes plus a byte plane are
// written (17 bytes per cell in f32, 1026^2: ~18 MB, ~5 us at 3.35 TB/s);
// the candidate search (~3 kflop per mixed cell) touches ~0.1% of the cells
// (812 of 1026^2 on the bench drop, in 66 of 4257 tiles). A candidate is a
// chain of ~40 IEEE divisions and square roots, so run serially in one
// thread the 12 of a cell take 12 times one chain's latency while the rest
// of its warp waits. So one block of kThreads threads per tile of kTileY
// rows of kTileX cells:
//   1. the tile's cells, one a thread: a cell that is not interior-mixed
//      gets the fills (nx, ny, d, valid) = (0, 1, 0, 0); a mixed cell joins
//      the block's list in shared memory;
//   2. the block's threads take the list's (cell, candidate) pairs, one
//      candidate's chain each, and store each candidate's error in shared
//      memory (with 384 threads a list of up to 32 cells takes one round;
//      the bench drop's fullest tile holds 25);
//   3. one thread per listed cell scans its 12 errors in the JAX package's
//      order with a strict-< running minimum from +inf (argmin's first-wins
//      tie-break; a NaN error never wins, and a cell with no finite error
//      keeps (0, 1, 0)), recomputes the winner's normal and plane constant
//      (the same expressions, so the same bits) and writes them with
//      valid = 1.
// A block without a mixed cell ends after step 1. fs_elvira_fill_probe
// runs step 1 with every cell filled: the memory floor. On an NVIDIA H100
// 80GB HBM3 (700 W), bench drop, f32 (tools/torch_elvira_times.py): 0.0146
// ms against the one-thread-a-cell kernel's 0.0528 in turns; the floor
// 0.0074 ms. 256 or 512 threads, 32 x 4 and 16 x 8 tiles were slower.
#include "vof_device.cuh"

namespace fs {
namespace {

using vof::Cell;

// a tile of kTileY rows of kTileX cells per block of kThreads threads (a
// row's cells in one warp)
constexpr int kTileX = 32, kTileY = 8, kCells = kTileX * kTileY, kThreads = 384;
constexpr int kCandidates = 12;

// the 3x3 fractions around interior cell (i, j): v[di + 1][dj + 1] = vf(i + di, j + dj)
template <typename T>
__device__ __forceinline__ void neighbourhood(const T* __restrict__ vf, int i, int j, int M, T v[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) v[a][b] = vf[(size_t)(i + a - 1) * M + (j + b - 1)];
}

// candidate c's unit normal: slopes of column (c < 6) or row sums, in the
// plain version's order of the 6 slopes, each with both orientations
template <typename T>
__device__ __forceinline__ void candidate_normal(const T v[3][3], int c, const Cell<T>& g, T& cnx, T& cny) {
  T col[3], row[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    col[a] = (v[a][0] + v[a][1] + v[a][2]) * g.h;
    row[a] = (v[0][a] + v[1][a] + v[2][a]) * g.w;
  }
  T s;
  switch (c >> 1) {
    case 0: s = (col[1] - col[0]) / g.w; break;
    case 1: s = (col[2] - col[0]) / g.two_w; break;
    case 2: s = (col[2] - col[1]) / g.w; break;
    case 3: s = (row[1] - row[0]) / g.h; break;
    case 4: s = (row[2] - row[0]) / g.two_h; break;
    default: s = (row[2] - row[1]) / g.h; break;
  }
  const T norm = sqrt(s * s + T(1));
  const T along = -s / norm;                               // the slope's component
  const T across = ((c & 1) ? T(-1) : T(1)) / norm;        // +-1 / norm
  cnx = c < 6 ? along : across;   // column heights: (-s, +-1) / norm
  cny = c < 6 ? across : along;   // row heights: (+-1, -s) / norm
}

// candidate c's fit error: the squared misfit of its plane's fractions over
// the 3x3 neighbourhood, summed in the plain version's order
template <typename T>
__device__ __forceinline__ T candidate_error(const T v[3][3], T cnx, T cny, T d, const Cell<T>& g) {
  T err = T(0);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T d_n = d - (cnx * T(a - 1) * g.w + cny * T(b - 1) * g.h);
      const T e = vof::area_fraction(cnx, cny, d_n, g) - v[a][b];
      err = err + e * e;
    }
  }
  return err;
}

// kSearch = false: the fill-only probe, which writes the fills on every cell
// and searches nothing (the kernel's memory floor; never called by the port)
template <typename T, bool kSearch>
__global__ void __launch_bounds__(kThreads)
elvira_kernel(const T* __restrict__ vf, int N, int M, Cell<T> g, T lo, T hi,
              T* __restrict__ onx, T* __restrict__ ony, T* __restrict__ od,
              uint8_t* __restrict__ ovalid) {
  __shared__ int n_list;
  __shared__ int list[kCells];                 // the tile's mixed cells (index in the tile)
  __shared__ T errs[kCells * kCandidates];     // errs[list index * 12 + candidate]
  const int tid = threadIdx.x;
  if (tid == 0) n_list = 0;
  __syncthreads();

  // 1. the fills, and the list of mixed cells
  for (int t = tid; t < kCells; t += kThreads) {
    const int i = blockIdx.y * kTileY + t / kTileX, j = blockIdx.x * kTileX + t % kTileX;
    if (i >= N || j >= M) continue;
    const size_t o = (size_t)i * M + j;
    const T v0 = vf[o];
    const bool mixed = i >= 1 && i <= N - 2 && j >= 1 && j <= M - 2 && v0 > lo && v0 < hi;
    if (kSearch && mixed) {
      list[atomicAdd(&n_list, 1)] = t;
    } else {
      onx[o] = T(0);
      ony[o] = T(1);
      od[o] = T(0);
      ovalid[o] = 0;
    }
  }
  if (!kSearch) return;
  __syncthreads();
  const int n = n_list;
  if (n == 0) return;

  // 2. one candidate's error per (cell, candidate) pair
  for (int p = tid; p < n * kCandidates; p += kThreads) {
    const int cell = list[p / kCandidates], c = p % kCandidates;
    const int ci = blockIdx.y * kTileY + cell / kTileX, cj = blockIdx.x * kTileX + cell % kTileX;
    T v[3][3];
    neighbourhood(vf, ci, cj, M, v);
    T cnx, cny;
    candidate_normal(v, c, g, cnx, cny);
    const T d = vof::plane_constant(cnx, cny, v[1][1], g);
    errs[p] = candidate_error(v, cnx, cny, d, g);
  }
  __syncthreads();

  // 3. the winner of each cell
  for (int q = tid; q < n; q += kThreads) {
    const int cell = list[q];
    const int ci = blockIdx.y * kTileY + cell / kTileX, cj = blockIdx.x * kTileX + cell % kTileX;
    T best_err = T(INFINITY);
    int best = -1;
#pragma unroll
    for (int c = 0; c < kCandidates; ++c) {
      const T err = errs[q * kCandidates + c];
      if (err < best_err) {
        best_err = err;
        best = c;
      }
    }
    T nx = T(0), ny = T(1), d = T(0);
    if (best >= 0) {
      T v[3][3];
      neighbourhood(vf, ci, cj, M, v);
      candidate_normal(v, best, g, nx, ny);
      d = vof::plane_constant(nx, ny, v[1][1], g);
    }
    const size_t o = (size_t)ci * M + cj;
    onx[o] = nx;
    ony[o] = ny;
    od[o] = d;
    ovalid[o] = 1;
  }
}

template <typename T, bool kSearch>
int launch(const void* vf, int N, int M, double dx, double dy, double lo, double hi,
           void* out, void* valid, cudaStream_t stream) {
  const size_t plane = (size_t)N * M;
  T* o = static_cast<T*>(out);
  const dim3 grid((M + kTileX - 1) / kTileX, (N + kTileY - 1) / kTileY);
  elvira_kernel<T, kSearch><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(vf), N, M,
                                                         Cell<T>::make(dx, dy), T(lo), T(hi), o,
                                                         o + plane, o + 2 * plane,
                                                         static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

}  // namespace
}  // namespace fs

// vf: (N, M) contiguous; out: (3, N, M) = nx, ny, d; valid: (N, M) uint8.
// dtype 0 = float, 1 = double. Returns a cudaError_t (0 = launched).
extern "C" int fs_elvira(int dtype, const void* vf, int N, int M, double dx, double dy,
                         double lo, double hi, void* out, void* valid, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;  // float or double only
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float, true>(vf, N, M, dx, dy, lo, hi, out, valid, s)
                    : fs::launch<double, true>(vf, N, M, dx, dy, lo, hi, out, valid, s);
}

// A measurement probe with fs_elvira's arguments: the same launch with the
// fills written on every cell and no candidate search (its time is the
// kernel's memory floor).
extern "C" int fs_elvira_fill_probe(int dtype, const void* vf, int N, int M, double dx, double dy,
                                    double lo, double hi, void* out, void* valid, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;  // float or double only
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fs::launch<float, false>(vf, N, M, dx, dy, lo, hi, out, valid, s)
                    : fs::launch<double, false>(vf, N, M, dx, dy, lo, hi, out, valid, s);
}
