// K10: the generic-cell frozen abelian CTMRG loop on the card.
//
// Replaces tpeps/ctm/generic_abelian/frozen.py:make_converge_frozen_generic
// (:156-246): the per-tensor max-abs normalization of every output of a
// directional move (_normalized, :35-37, no symmetrization), the sweep's
// distance and commit (_env_dist2 and the while_loop's body and condition,
// :149-153, :179-192), and the backward of the normalization inside the
// Neumann adjoint (:198-243; the loop step itself is K9's adjoint_commit).
//
// The environment is one flat buffer: every C and then every T of the cell,
// each in its frozen block layout.  A directional move's raw outputs (two
// corners and one edge per site, each laid out in its env slot's block set)
// come as one flat buffer with a segment table, five int64 per output:
// [raw offset, env offset, length, first block, end block] (the blocks are
// numbered across the raw buffer; per element its block id, int32).
//
// generic_epilogue: per segment m = max|x|, env[slot] = x * (1/m), in one
//   cooperative launch of a grid resident at once (the occupancy query's
//   blocks an SM, at most EPI_BLOCKS_PER_SM).  The segments are one index
//   space (their table in shared memory); a thread takes every gridDim x
//   NT-th element, loads its first EPI_KEEP at once and keeps them in
//   registers, and folds |x| into its segment's block maximum (a running
//   max, then a shared-memory atomic max on |x|'s bits, which order like the
//   values: no tree, no order to fix).  Each block merges its maxima into
//   global ones (one atomic max a block and segment), waits at the grid
//   barrier (coop.cuh, on words of its own) and reads them back, so each has
//   the same 1/m; the last block to have read them zeroes them.  Each block then scales
//   and stores the values it kept (elements past EPI_KEEP a thread are read
//   again).  The product with 1/m makes the result bit-identical to the
//   plain twin's; a NaN is the maximum, as in the twin.
// sweep_commit: one step of the sweep loop: dist2 = sum |W - S|^2 over the
//   whole env, S = W, i + 1, done = !(i < max_iter && dist2 > conv_tol^2).
//   Every block commits its grid-stride share and writes its partial sum;
//   the last block to arrive (a counter in ctl, reset by that block) reduces
//   the partials in a fixed order and updates the scalars.  Nothing happens
//   once done is set, so the host reads 4 bytes per sweep.
// generic_epilogue_vjp: the cotangent of the raw outputs for the cotangent g
//   of the env slots.  With the scale detached (sg_norm) xbar = g/m; else
//   xbar = g/m - (sum g.x / m^2) w sign(x), w the JAX package's split of the
//   max's derivative: 1 over the blocks whose max ties the segment's max,
//   then over the tied elements of each such block,
//   w = 1 / (n_tied_blocks * n_tied_in_the_block).  Three passes: partial
//   (max, dot) per segment; the tie counts per block (integer atomics, so
//   deterministic; skipped with sg_norm); the elementwise pass.
//
// What bounds them on an H100: one or two reads and one write of a move's
// outputs (a few hundred thousand elements at D=8, chi=160; generic_epilogue
// 16 bytes an element, 8.1 MB, 2.4 us): microseconds, latency rather than
// bandwidth.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coop.cuh"

#ifndef TPEPS_ABLATE  // generic_epilogue's timing copies: 1 no work after the table is
#define TPEPS_ABLATE 0  // staged, 2 no grid barrier, 4 no stores (results wrong; timing only)
#endif

namespace {

constexpr int NT = 256;
constexpr int GRID = 264;  // sweep_commit's and generic_epilogue_vjp's grid
constexpr int SEGW = 5;  // int64 per segment: src, dst, len, blk0, blk1
// generic_epilogue: blocks an SM at most (2 measured faster than 1 or 4),
// values a thread keeps across the barrier, segments a launch takes (a
// longer table is walked in launches of MAX_SEG), grid at most
constexpr int EPI_BLOCKS_PER_SM = 2, EPI_KEEP = 8, MAX_SEG = 64, EPI_MAX_GRID = 1024;

template <typename T>
__device__ T block_reduce(T v, bool is_max, T* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const T o = buf[threadIdx.x + s];
      buf[threadIdx.x] = is_max ? fmax(buf[threadIdx.x], o) : buf[threadIdx.x] + o;
    }
    __syncthreads();
  }
  const T r = buf[0];
  __syncthreads();
  return r;
}

// the reduction of GRID partials in a fixed order (every block alike)
template <typename T>
__device__ T reduce_partials(const T* __restrict__ part, bool is_max, T* buf) {
  T v = T(0);
  for (int b = threadIdx.x; b < GRID; b += NT) {
    const T x = __ldcg(part + b);
    v = is_max ? fmax(v, x) : v + x;
  }
  return block_reduce(v, is_max, buf);
}

// ---- generic_epilogue ------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_kernel(const T* __restrict__ raw, const int64_t* __restrict__ seg, int nseg,
                unsigned* __restrict__ bar, T* __restrict__ env) {
  __shared__ int64_t s_src[MAX_SEG], s_dst[MAX_SEG], s_beg[MAX_SEG + 1];
  __shared__ unsigned long long s_max[MAX_SEG];
  __shared__ T s_inv[MAX_SEG];
  for (int s = threadIdx.x; s < nseg; s += NT) {  // the table, a row a thread
    s_src[s] = seg[SEGW * s];
    s_dst[s] = seg[SEGW * s + 1];
    s_beg[s + 1] = seg[SEGW * s + 2];
    s_max[s] = 0ull;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the lengths' prefix sums
    s_beg[0] = 0;
    for (int s = 1; s <= nseg; ++s) s_beg[s] += s_beg[s - 1];
  }
  __syncthreads();
  if (TPEPS_ABLATE & 1) return;
  const int64_t n = s_beg[nseg], stride = static_cast<int64_t>(gridDim.x) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  // (1) the first EPI_KEEP loads sent together, then the maxima
  T v[EPI_KEEP];
  int sg[EPI_KEEP];
  int s = 0;
#pragma unroll
  for (int r = 0; r < EPI_KEEP; ++r) {
    const int64_t e = tid + r * stride;
    v[r] = T(0);
    sg[r] = -1;
    if (e < n) {
      while (e >= s_beg[s + 1]) ++s;
      sg[r] = s;
      v[r] = raw[s_src[s] + (e - s_beg[s])];
    }
  }
  // a running max a thread, one shared atomic where its segment changes
  int cur = -1;
  unsigned long long m = 0ull;
#pragma unroll
  for (int r = 0; r < EPI_KEEP; ++r) {
    if (sg[r] != cur) {
      if (cur >= 0) atomicMax(&s_max[cur], m);
      cur = sg[r];
      m = 0ull;
    }
    m = max(m, abs_bits(v[r]));
  }
  for (int64_t e = tid + EPI_KEEP * stride; e < n; e += stride) {
    while (e >= s_beg[s + 1]) ++s;
    if (s != cur) {
      if (cur >= 0) atomicMax(&s_max[cur], m);
      cur = s;
      m = 0ull;
    }
    m = max(m, abs_bits(raw[s_src[s] + (e - s_beg[s])]));
  }
  if (cur >= 0) atomicMax(&s_max[cur], m);
  // (2) every block the same maxima: the blocks' maxima merged into the
  // global ones (an atomic max, order-free), the grid barrier, and each
  // block reads them back; the last block to have read them zeroes them
  unsigned long long* gmax = reinterpret_cast<unsigned long long*>(bar + 4);
  __syncthreads();
  for (int q = threadIdx.x; q < nseg; q += NT)
    if (s_max[q]) atomicMax(gmax + q, s_max[q]);
  if (!(TPEPS_ABLATE & 2)) grid_barrier(bar);
  for (int q = threadIdx.x; q < nseg; q += NT) s_max[q] = __ldcg(gmax + q);
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(bar + 2, 1u) == gridDim.x - 1) {
    for (int q = 0; q < nseg; ++q) gmax[q] = 0ull;
    bar[2] = 0u;
  }
  // (3) the scaled values
  for (int q = threadIdx.x; q < nseg; q += NT) s_inv[q] = T(1) / from_bits<T>(s_max[q]);
  __syncthreads();
  if (TPEPS_ABLATE & 4) return;
#pragma unroll
  for (int r = 0; r < EPI_KEEP; ++r) {
    const int q = sg[r];
    if (q >= 0) env[s_dst[q] + (tid + r * stride - s_beg[q])] = v[r] * s_inv[q];
  }
  s = 0;
  for (int64_t e = tid + EPI_KEEP * stride; e < n; e += stride) {
    while (e >= s_beg[s + 1]) ++s;
    env[s_dst[s] + (e - s_beg[s])] = raw[s_src[s] + (e - s_beg[s])] * s_inv[s];
  }
}

// ---- sweep_commit ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
sweep_commit_kernel(T* __restrict__ S, const T* __restrict__ W, int64_t n, T* __restrict__ dist2,
                    const double* __restrict__ conv_tol, int* __restrict__ ctl,
                    T* __restrict__ part) {
  __shared__ T buf[NT];
  __shared__ int last;
  if (ctl[1]) return;  // the loop has ended
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  T d = T(0);
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride) {
    const T w = W[e];
    const T x = w - S[e];
    d += x * x;
    S[e] = w;
  }
  d = block_reduce(d, false, buf);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = d;
    __threadfence();
    last = atomicAdd(&ctl[2], 1) == GRID - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  d = reduce_partials(part, false, buf);
  if (threadIdx.x == 0) {
    dist2[0] = d;
    const int it = ctl[0] + 1;
    ctl[0] = it;
    const double tol = conv_tol[0];
    ctl[1] = (it < ctl[3] && static_cast<double>(d) > tol * tol) ? 0 : 1;
    ctl[2] = 0;
  }
}

// ---- generic_epilogue_vjp --------------------------------------------------

// part layout: segment s holds GRID partial maxima, then GRID partial dots
template <typename T>
__global__ void __launch_bounds__(NT)
vjp_reduce(const T* __restrict__ raw, const T* __restrict__ g, const int64_t* __restrict__ seg,
           int nseg, T* __restrict__ part) {
  __shared__ T buf[NT];
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int s = 0; s < nseg; ++s) {
    const int64_t src = seg[SEGW * s], dst = seg[SEGW * s + 1], len = seg[SEGW * s + 2];
    T m = T(0), d = T(0);
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < len;
         e += stride) {
      const T x = raw[src + e];
      m = fmax(m, fabs(x));
      d += g[dst + e] * x;
    }
    m = block_reduce(m, true, buf);
    d = block_reduce(d, false, buf);
    if (threadIdx.x == 0) {
      part[2 * s * GRID + blockIdx.x] = m;
      part[(2 * s + 1) * GRID + blockIdx.x] = d;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
vjp_count(const T* __restrict__ raw, const int64_t* __restrict__ seg, int nseg,
          const int* __restrict__ blk, const T* __restrict__ part, int* __restrict__ cnt) {
  __shared__ T buf[NT];
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int s = 0; s < nseg; ++s) {
    const int64_t src = seg[SEGW * s], len = seg[SEGW * s + 2];
    const T m = reduce_partials(part + 2 * s * GRID, true, buf);
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < len; e += stride)
      if (fabs(raw[src + e]) == m) atomicAdd(&cnt[blk[src + e]], 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
vjp_apply(const T* __restrict__ raw, const T* __restrict__ g, const int64_t* __restrict__ seg,
          int nseg, const int* __restrict__ blk, const T* __restrict__ part,
          const int* __restrict__ cnt, int sg_norm, T* __restrict__ xbar) {
  __shared__ T buf[NT];
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int s = 0; s < nseg; ++s) {
    const int64_t src = seg[SEGW * s], dst = seg[SEGW * s + 1], len = seg[SEGW * s + 2];
    const T m = reduce_partials(part + 2 * s * GRID, true, buf);
    const T inv = T(1) / m;
    T coef = T(0), ntb = T(1);
    if (!sg_norm) {
      coef = reduce_partials(part + (2 * s + 1) * GRID, false, buf) * inv * inv;
      const int64_t b0 = seg[SEGW * s + 3], b1 = seg[SEGW * s + 4];
      T nb = T(0);
      for (int64_t b = b0 + threadIdx.x; b < b1; b += NT) nb += cnt[b] > 0 ? T(1) : T(0);
      ntb = block_reduce(nb, false, buf);
    }
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < len;
         e += stride) {
      const T x = raw[src + e];
      T v = g[dst + e] * inv;
      if (!sg_norm && fabs(x) == m) {
        const T w = T(1) / (ntb * T(cnt[blk[src + e]]));
        v -= x > T(0) ? coef * w : -(coef * w);
      }
      xbar[src + e] = v;
    }
  }
}

// a launch for every MAX_SEG rows of the table (the rows hold absolute
// offsets; the launches share the barrier words, which each leaves zero)
template <typename T>
int epilogue_launch(const T* raw, const int64_t* seg, int nseg, unsigned* bar, T* env,
                    cudaStream_t stream) {
  static int grid = 0;
  cudaError_t e = cudaSuccess;
  if (grid == 0) e = coop_grid(epilogue_kernel<T>, NT, EPI_BLOCKS_PER_SM, EPI_MAX_GRID, grid);
  if (e != cudaSuccess) return e;
  for (int s0 = 0; s0 < nseg; s0 += MAX_SEG) {
    const int64_t* rows = seg + static_cast<int64_t>(SEGW) * s0;
    int n = nseg - s0 < MAX_SEG ? nseg - s0 : MAX_SEG;
    void* args[] = {&raw, &rows, &n, &bar, &env};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(epilogue_kernel<T>),
                                    dim3(grid), dim3(NT), args, 0, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

template <typename T>
int vjp_launch(const T* raw, const T* g, const int64_t* seg, int nseg, const int* blk, T* part,
               int* cnt, int sg_norm, T* xbar, cudaStream_t stream) {
  vjp_reduce<T><<<GRID, NT, 0, stream>>>(raw, g, seg, nseg, part);
  if (!sg_norm) vjp_count<T><<<GRID, NT, 0, stream>>>(raw, seg, nseg, blk, part, cnt);
  vjp_apply<T><<<GRID, NT, 0, stream>>>(raw, g, seg, nseg, blk, part, cnt, sg_norm, xbar);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// partials of sweep_commit and of a pass of generic_epilogue_vjp
int tpeps_generic_epilogue_partials(void) { return GRID; }

// the words at bar: the grid barrier's two counters, a counter of the blocks
// that have read the maxima, a pad, and a 64-bit maximum a segment (at bar +
// 4), zero before the call and zero after it
int tpeps_generic_epilogue_bar_words(void) { return 4 + 2 * MAX_SEG; }

int tpeps_generic_epilogue_f64(const double* raw, const int64_t* seg, int nseg, unsigned* bar,
                               double* env, void* stream) {
  return epilogue_launch<double>(raw, seg, nseg, bar, env, static_cast<cudaStream_t>(stream));
}

int tpeps_generic_epilogue_f32(const float* raw, const int64_t* seg, int nseg, unsigned* bar,
                               float* env, void* stream) {
  return epilogue_launch<float>(raw, seg, nseg, bar, env, static_cast<cudaStream_t>(stream));
}

int tpeps_sweep_commit_f64(double* S, const double* W, int64_t n, double* dist2,
                           const double* conv_tol, int* ctl, double* part, void* stream) {
  sweep_commit_kernel<double><<<GRID, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      S, W, n, dist2, conv_tol, ctl, part);
  return cudaGetLastError();
}

int tpeps_sweep_commit_f32(float* S, const float* W, int64_t n, float* dist2,
                           const double* conv_tol, int* ctl, float* part, void* stream) {
  sweep_commit_kernel<float><<<GRID, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      S, W, n, dist2, conv_tol, ctl, part);
  return cudaGetLastError();
}

int tpeps_generic_epilogue_vjp_f64(const double* raw, const double* g, const int64_t* seg,
                                   int nseg, const int* blk, double* part, int* cnt, int sg_norm,
                                   double* xbar, void* stream) {
  return vjp_launch<double>(raw, g, seg, nseg, blk, part, cnt, sg_norm, xbar,
                            static_cast<cudaStream_t>(stream));
}

int tpeps_generic_epilogue_vjp_f32(const float* raw, const float* g, const int64_t* seg,
                                   int nseg, const int* blk, float* part, int* cnt, int sg_norm,
                                   float* xbar, void* stream) {
  return vjp_launch<float>(raw, g, seg, nseg, blk, part, cnt, sg_norm, xbar,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
