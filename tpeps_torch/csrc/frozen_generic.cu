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
// generic_epilogue: per segment m = max|x|, env[slot] = x * (1/m).  A
//   reduction pass (per segment, each block's partial max) and an
//   elementwise pass in which every block first reduces the partials of the
//   segment in a fixed order; no atomics, and the product with 1/m makes the
//   result bit-identical to the plain twin's.
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
// outputs (a few hundred thousand elements at D=8, chi=160): microseconds,
// latency rather than bandwidth.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int GRID = 264;
constexpr int SEGW = 5;  // int64 per segment: src, dst, len, blk0, blk1

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
epilogue_reduce(const T* __restrict__ raw, const int64_t* __restrict__ seg, int nseg,
                T* __restrict__ part) {
  __shared__ T buf[NT];
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int s = 0; s < nseg; ++s) {
    const int64_t src = seg[SEGW * s], len = seg[SEGW * s + 2];
    T m = T(0);
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < len; e += stride)
      m = fmax(m, fabs(raw[src + e]));
    m = block_reduce(m, true, buf);
    if (threadIdx.x == 0) part[s * GRID + blockIdx.x] = m;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_apply(const T* __restrict__ raw, const int64_t* __restrict__ seg, int nseg,
               const T* __restrict__ part, T* __restrict__ env) {
  __shared__ T buf[NT];
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int s = 0; s < nseg; ++s) {
    const int64_t src = seg[SEGW * s], dst = seg[SEGW * s + 1], len = seg[SEGW * s + 2];
    const T inv = T(1) / reduce_partials(part + s * GRID, true, buf);
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < len; e += stride)
      env[dst + e] = raw[src + e] * inv;
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

template <typename T>
int epilogue_launch(const T* raw, const int64_t* seg, int nseg, T* part, T* env,
                    cudaStream_t stream) {
  epilogue_reduce<T><<<GRID, NT, 0, stream>>>(raw, seg, nseg, part);
  epilogue_apply<T><<<GRID, NT, 0, stream>>>(raw, seg, nseg, part, env);
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

int tpeps_generic_epilogue_partials(void) { return GRID; }

int tpeps_generic_epilogue_f64(const double* raw, const int64_t* seg, int nseg, double* part,
                               double* env, void* stream) {
  return epilogue_launch<double>(raw, seg, nseg, part, env, static_cast<cudaStream_t>(stream));
}

int tpeps_generic_epilogue_f32(const float* raw, const int64_t* seg, int nseg, float* part,
                               float* env, void* stream) {
  return epilogue_launch<float>(raw, seg, nseg, part, env, static_cast<cudaStream_t>(stream));
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
