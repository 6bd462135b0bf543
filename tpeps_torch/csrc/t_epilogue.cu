// Edge epilogue: out = sym(x) / scale with
//   sym(x)[b, i, j] = 0.5 * (x[b, i, j] + x[b, j, i])   (b over the D^2 axes)
//   scale = max |sym(x)|  (mode 0)   or   ||sym(x)||_2  (mode 1)
//
// Replaces the epilogue of tpeps/ctm/c4v/move_tpu.py:ctm_move_sl_tpu
// (:239-248): hermitian symmetrisation of T' over its two chi axes, then
// division by max|T'| or by its 2-norm.  Real inputs only (for real T' the
// conjugate is the identity); the complex case raises in the wrapper.
//
// What bounds it on an H100: one read of T' and one write of the result,
// D^2 chi^2 elements (8.5 MB each way in f64 at D=7, chi=147: 5.1 us), plus a
// global reduction before the division: memory and latency, not arithmetic.
//
// Design: one cooperative launch of a fixed grid (two blocks an SM), so the
// reduction order never depends on scheduling and repeated runs agree bit
// for bit.  A block walks the pairs of 32 x 32 tiles (b, ti <= tj), whose
// (b, i0, j0) it works out once a tile: it reads tile (ti, tj) and its mirror
// (tj, ti) row by row into shared memory (both reads coalesced), forms the
// symmetrised values of both in registers (0.5 (a + b) is the same number
// either way round) and folds them into its partial (max |v| or sum v^2).
// One fixed-order tree gives the block's partial; a grid barrier (the
// cooperative launch keeps every block resident); every block then reduces
// all partials in the same order, so each has the identical scale, divides
// the values it kept and stores them, both tiles' rows coalesced.  Where the
// grid cannot keep every tile in registers (more than MAXT tile pairs a
// block) the first pass stores the symmetrised values and the second
// divides them in place (the same thread reads back what it wrote).
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace {

constexpr int NT = 256;        // threads per block: 8 rows of 32
constexpr int TS = 32;         // tile side
constexpr int MAXT = 4;        // tile pairs a block keeps in registers
constexpr int MAX_GRID = 1024; // partials the wrapper allocates (tpeps_t_epilogue_partials)

// max that propagates NaN (as torch's max does)
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) { return (a > b || a != a) ? a : b; }

template <typename T>
__device__ __forceinline__ T fold(T acc, T v, int mode) {
  return mode == 0 ? nanmax(acc, fabs(v)) : fma(v, v, acc);
}

// the block's values of acc combined in a fixed tree; every thread gets it
template <typename T>
__device__ T block_reduce(T v, int mode, T* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const T o = buf[threadIdx.x + s];
      buf[threadIdx.x] = mode == 0 ? nanmax(buf[threadIdx.x], o) : buf[threadIdx.x] + o;
    }
    __syncthreads();
  }
  const T r = buf[0];
  __syncthreads();
  return r;
}

struct TilePair {
  int64_t base;  // b m^2
  int i0, j0;
  bool diag;
};

__device__ __forceinline__ TilePair tile_pair(int64_t t, int nt, int64_t pairs, int m) {
  TilePair tp;
  const int64_t b = t / pairs;
  int p = static_cast<int>(t - b * pairs), ti = 0;
  while (p >= nt - ti) p -= nt - ti++;
  tp.base = b * m * static_cast<int64_t>(m);
  tp.i0 = ti * TS;
  tp.j0 = (ti + p) * TS;
  tp.diag = p == 0;
  return tp;
}

// the symmetrised values of a tile pair: va at (i0 + ty + 8q, j0 + tx), vb
// (off the diagonal) at (j0 + ty + 8q, i0 + tx); positions past m give 0
template <typename T>
__device__ __forceinline__ void tile_values(const T* __restrict__ x, TilePair tp, int m,
                                            T (*A)[TS + 1], T (*B)[TS + 1], T (&va)[4],
                                            T (&vb)[4], T& acc, int mode) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  __syncthreads();  // the previous tile's reads are done
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 8 * q;
    A[r][tx] = tp.i0 + r < m && tp.j0 + tx < m ? x[tp.base + (tp.i0 + r) * m + tp.j0 + tx] : T(0);
    if (!tp.diag)
      B[r][tx] = tp.j0 + r < m && tp.i0 + tx < m ? x[tp.base + (tp.j0 + r) * m + tp.i0 + tx] : T(0);
  }
  __syncthreads();
  T (*M)[TS + 1] = tp.diag ? A : B;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 8 * q;
    va[q] = T(0.5) * (A[r][tx] + M[tx][r]);
    acc = fold(acc, va[q], mode);
    if (!tp.diag) {
      vb[q] = T(0.5) * (B[r][tx] + A[tx][r]);
      acc = fold(acc, vb[q], mode);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_values(T* __restrict__ out, TilePair tp, int m,
                                             const T (&va)[4], const T (&vb)[4], T scale) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty + 8 * q;
    if (tp.i0 + r < m && tp.j0 + tx < m) out[tp.base + (tp.i0 + r) * m + tp.j0 + tx] = va[q] / scale;
    if (!tp.diag && tp.j0 + r < m && tp.i0 + tx < m)
      out[tp.base + (tp.j0 + r) * m + tp.i0 + tx] = vb[q] / scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
t_epilogue_kernel(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ part,
                  unsigned* __restrict__ bar, int64_t batch, int m, int mode) {
  __shared__ T A[TS][TS + 1], B[TS][TS + 1];
  __shared__ T buf[NT];
  const int nt = (m + TS - 1) / TS;
  const int64_t pairs = static_cast<int64_t>(nt) * (nt + 1) / 2, tiles = batch * pairs;
  const bool hold = tiles <= static_cast<int64_t>(gridDim.x) * MAXT;
  T acc = T(0);
  T va[MAXT][4], vb[MAXT][4];
  if (hold) {
#pragma unroll
    for (int r = 0; r < MAXT; ++r) {
      const int64_t t = blockIdx.x + static_cast<int64_t>(r) * gridDim.x;
      if (t < tiles) tile_values(x, tile_pair(t, nt, pairs, m), m, A, B, va[r], vb[r], acc, mode);
    }
  } else {
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TilePair tp = tile_pair(t, nt, pairs, m);
      tile_values(x, tp, m, A, B, va[0], vb[0], acc, mode);
      store_values(out, tp, m, va[0], vb[0], T(1));
    }
  }
  const T mine = block_reduce(acc, mode, buf);
  if (threadIdx.x == 0) part[blockIdx.x] = mine;
  grid_barrier(bar);
  T r = T(0);
  for (int i = threadIdx.x; i < gridDim.x; i += NT) {
    const T p = __ldcg(part + i);
    r = i == threadIdx.x ? p : (mode == 0 ? nanmax(r, p) : r + p);
  }
  r = block_reduce(r, mode, buf);
  const T scale = mode == 0 ? r : sqrt(r);
  if (hold) {
#pragma unroll
    for (int q = 0; q < MAXT; ++q) {
      const int64_t t = blockIdx.x + static_cast<int64_t>(q) * gridDim.x;
      if (t < tiles) store_values(out, tile_pair(t, nt, pairs, m), m, va[q], vb[q], scale);
    }
  } else {
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TilePair tp = tile_pair(t, nt, pairs, m);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = ty + 8 * q;
        if (tp.i0 + rr < m && tp.j0 + tx < m) {
          T* o = out + tp.base + (tp.i0 + rr) * m + tp.j0 + tx;
          *o = *o / scale;
        }
        if (!tp.diag && tp.j0 + rr < m && tp.i0 + tx < m) {
          T* o = out + tp.base + (tp.j0 + rr) * m + tp.i0 + tx;
          *o = *o / scale;
        }
      }
    }
  }
}

// the cooperative grid: two blocks an SM where the kernel's occupancy allows
template <typename T>
cudaError_t grid_size(int& grid) {
  static int cached = 0;
  if (cached == 0) {
    const cudaError_t e = coop_grid(t_epilogue_kernel<T>, NT, 2, MAX_GRID, cached);
    if (e != cudaSuccess) return e;
  }
  grid = cached;
  return cudaSuccess;
}

template <typename T>
int launch(const T* x, T* out, T* part, unsigned* bar, int64_t batch, int m, int mode,
           cudaStream_t stream) {
  if (batch == 0 || m == 0) return cudaSuccess;
  int grid = 0;
  cudaError_t e = grid_size<T>(grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&x, &out, &part, &bar, &batch, &m, &mode};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(t_epilogue_kernel<T>), dim3(grid),
                                  dim3(NT), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpeps_t_epilogue_partials(void) { return MAX_GRID; }

// bar: two unsigned counters, zero before the call and zero after it
int tpeps_t_epilogue_f64(const double* x, double* out, double* part, unsigned* bar,
                         int64_t batch, int m, int mode, void* stream) {
  return launch<double>(x, out, part, bar, batch, m, mode, static_cast<cudaStream_t>(stream));
}

int tpeps_t_epilogue_f32(const float* x, float* out, float* part, unsigned* bar, int64_t batch,
                         int m, int mode, void* stream) {
  return launch<float>(x, out, part, bar, batch, m, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
