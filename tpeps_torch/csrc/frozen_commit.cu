// K9 epilogue: the end of a frozen C4v abelian CTMRG move and the body and
// condition of run_frozen's while_loop, on the card, in one launch.
//
// Replaces tpeps/ctm/c4v_abelian/frozen.py:move_frozen's epilogue (:73-77:
// nC + nC^T.conj_blocks, nT + nT.transpose(3,1,2,0).conj_blocks, each halved
// and scaled by 1 / max|.|, reindexed onto the frozen block sets) and
// run_frozen's loop step (:141-149: dist2 to the committed (C, T), i + 1,
// done = !(i < max_iter && dist2 > conv_tol^2)).
//
// Inputs: the move's raw C' and T' laid out in the frozen block sets of C
// and T (blocks the move does not produce hold zeros); per element the flat
// index of its transpose partner, or -1 where the partner block is absent;
// the committed state C, T, dist2, conv_tol and ctl = [i, done, arrival
// counter, max_iter].  If done is set the launch returns and the state is
// untouched.
//
// What bounds it on an H100: per element a read of raw and of its partner
// index, a read and a write of the committed value (the partner's raw value
// is an element of the same raw buffer, read once): 32 bytes (7.6 MB, 2.3 us
// at D=8, chi=160, 237,601 elements), behind two reductions over the grid:
// latency rather than bandwidth.
//
// Design: one cooperative launch of a grid that is resident at once (one
// block of FC_NT = 512 threads an SM).  C and T are one index space of nC +
// nT elements; a thread takes every gridDim x FC_NT-th.  (1) Each thread
// symmetrizes its elements, keeps the first KEEP of them in registers with
// their committed values (all loaded at once, beside the done flag, which
// is tested before any write) and folds all into its maxima of |C| and |T|;
// each block adds its two maxima to two global ones (an atomic max on |x|'s
// bits, which order like the values: no order to fix).  (2) A grid barrier
// on two counters of the kernel's own.  (3) Every block reads the two
// maxima once and scales its elements by the product with 1 / max (as the
// JAX code does: C and T bit-identical to the plain twin's), forms its
// partial dist2 against the committed values and commits them; elements
// past KEEP a thread are symmetrized again from raw (the same arithmetic,
// the same bits).  (4) The last block to arrive (a counter in ctl, reset by
// that block) sums the dist2 partials in block order, writes dist2, i and
// done, and zeroes the two maxima (every block has read them by then): the
// counters and maxima are left zero.  Every block reads done before the
// barrier, and only the last to arrive writes it, after every block has
// passed the barrier.  Block reductions are warp shuffles (an xor
// butterfly) and then the warps in order: a fixed order.  dist2 differs
// from the twin's only in summation order.
//
// Two kernels of the implicit adjoint of converge_frozen (the backward of
// tpeps/ctm/c4v_abelian/frozen.py:_make_converge_frozen, :160-233) live here
// too:
//
// frozen_epilogue_vjp: the backward of the epilogue above, the JAX package's
//   move_frozen at sg_norm=False (the scale differentiated) or True (the
//   scale detached).  With z = sym(x), m = max|z| and y = z * (1/m):
//   zbar = ybar/m - (sum ybar.z / m^2) w sign(z), the second term dropped at
//   sg_norm, and xbar = sym(zbar).  w is JAX's split of the max's derivative
//   (a max per block of the frozen layout, then a max over blocks): 1 over
//   the blocks whose max ties m, then over the tied elements of each such
//   block, w = 1 / (n_tied_blocks * n_tied_in_the_block); a symmetrized
//   off-diagonal maximum appears at least twice, bit for bit, in one block
//   or in two.  A reduction pass (per grid block: max and sum ybar.z, for C
//   and T), a pass counting the ties per layout block (integer atomics, so
//   deterministic; skipped at sg_norm) and an elementwise pass, in which
//   every grid block first reduces the partials in the same fixed order.
//
// adjoint_commit: one step of the Neumann adjoint's while_loop (:195-206):
//   abar += abar_i, delta = |u|^2, grew = delta > delta_prev ? grew + 1 : 0,
//   i + 1, JAX's four-way condition (i < max_iter, delta > tol^2 |ybar|^2,
//   grew < 4, delta < 1e4 |ybar|^2) into done, and the diverged flag
//   (:208-211).  Every block adds its share of abar_i and its partial |u|^2;
//   the last block to arrive reduces the partials in a fixed order and
//   updates the scalars.  Nothing happens once done is set, so the host reads
//   4 bytes per iteration.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coop.cuh"

// frozen_commit's timing copies (results wrong; timing only): 1 no work
// after the done read, 2 no grid barrier, 4 no commit stores, 8 no last
// block's sum, 16 no partner gather
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif

namespace {

constexpr int NT = 256;
constexpr int GRID = 264;  // frozen_epilogue_vjp's and adjoint_commit's grid
// frozen_commit: threads a block, blocks an SM at most (512 x 1 measured
// faster than 256 x 1, 2 or 4), values a thread keeps across the barrier,
// grid at most (its dist2 partials)
constexpr int FC_NT = 512, FC_BLOCKS_PER_SM = 1, KEEP = 8, FC_MAX_GRID = 1024;

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

// frozen_commit's block reductions of two values at once, in a fixed order:
// an xor butterfly in each warp (every lane ends with the same bits), then
// the warps in order; two barriers.  buf: 2 * FC_NT / 32 values.
template <typename T, bool MAX>
__device__ __forceinline__ void block_reduce2(T& a, T& b, T* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T x = __shfl_xor_sync(0xffffffffu, a, o), y = __shfl_xor_sync(0xffffffffu, b, o);
    a = MAX ? fmax(a, x) : a + x;
    b = MAX ? fmax(b, y) : b + y;
  }
  constexpr int NW = FC_NT / 32;
  if ((threadIdx.x & 31) == 0) {
    buf[threadIdx.x >> 5] = a;
    buf[NW + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = buf[0];
  b = buf[NW];
#pragma unroll
  for (int w = 1; w < NW; ++w) {
    a = MAX ? fmax(a, buf[w]) : a + buf[w];
    b = MAX ? fmax(b, buf[NW + w]) : b + buf[NW + w];
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T sym_at(const T* __restrict__ raw, const int64_t* __restrict__ partner,
                                    int64_t e) {
  const int64_t p = partner[e];
  return T(0.5) * (raw[e] + (p >= 0 ? raw[p] : T(0)));
}

template <typename T>
__global__ void __launch_bounds__(FC_NT)
frozen_commit_kernel(T* __restrict__ C, T* __restrict__ Tt, T* __restrict__ dist2,
                     const double* __restrict__ conv_tol, int* __restrict__ ctl,
                     T* __restrict__ part, unsigned* __restrict__ bar,
                     const T* __restrict__ rawC, const T* __restrict__ rawT,
                     const int64_t* __restrict__ pC, const int64_t* __restrict__ pT, int64_t nC,
                     int64_t nT) {
  __shared__ T buf[2 * FC_NT / 32];
  __shared__ unsigned long long s_g[2];
  __shared__ int last;
  // done (read by every block before the barrier, written after it by the
  // last block): loaded beside the first raw values, tested before any write
  const int done = ctl[1];
  if (TPEPS_ABLATE & 1) return;
  const int grid = static_cast<int>(gridDim.x);
  const int64_t n = nC + nT, stride = static_cast<int64_t>(grid) * FC_NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * FC_NT + threadIdx.x;
  // (1) symmetrize; the first KEEP values and their committed ones stay in
  // registers
  T v[KEEP], old[KEEP];
  T mC = T(0), mT = T(0);
#pragma unroll
  for (int r = 0; r < KEEP; ++r) {
    const int64_t e = tid + r * stride;
    v[r] = old[r] = T(0);
    if (e < nC) {
      v[r] = (TPEPS_ABLATE & 16) ? rawC[e] : sym_at(rawC, pC, e);
      old[r] = C[e];
      mC = fmax(mC, fabs(v[r]));
    } else if (e < n) {
      v[r] = (TPEPS_ABLATE & 16) ? rawT[e - nC] : sym_at(rawT, pT, e - nC);
      old[r] = Tt[e - nC];
      mT = fmax(mT, fabs(v[r]));
    }
  }
  for (int64_t e = tid + KEEP * stride; e < n; e += stride) {
    if (e < nC) mC = fmax(mC, fabs(sym_at(rawC, pC, e)));
    else mT = fmax(mT, fabs(sym_at(rawT, pT, e - nC)));
  }
  if (done) return;  // the loop has ended: the state stays untouched
  block_reduce2<T, true>(mC, mT, buf);
  unsigned long long* gmax = reinterpret_cast<unsigned long long*>(bar + 2);
  if (threadIdx.x == 0) {
    atomicMax(gmax, abs_bits(mC));
    atomicMax(gmax + 1, abs_bits(mT));
  }
  // (2)
  if (!(TPEPS_ABLATE & 2)) grid_barrier(bar);
  // (3) the same maxima in every block (read once a block), then scale,
  // distance and commit
  if (threadIdx.x < 2) s_g[threadIdx.x] = __ldcg(gmax + threadIdx.x);
  __syncthreads();
  const T iC = T(1) / from_bits<T>(s_g[0]), iT = T(1) / from_bits<T>(s_g[1]);
  T d = T(0);
#pragma unroll
  for (int r = 0; r < KEEP; ++r) {
    const int64_t e = tid + r * stride;
    if (e < n) {
      const T w = v[r] * (e < nC ? iC : iT), x = w - old[r];
      d += x * x;
      if (!(TPEPS_ABLATE & 4)) *(e < nC ? C + e : Tt + (e - nC)) = w;
    }
  }
  for (int64_t e = tid + KEEP * stride; e < n; e += stride) {
    T* dst = e < nC ? C + e : Tt + (e - nC);
    const T w = (e < nC ? sym_at(rawC, pC, e) : sym_at(rawT, pT, e - nC)) * (e < nC ? iC : iT);
    const T x = w - *dst;
    d += x * x;
    if (!(TPEPS_ABLATE & 4)) *dst = w;
  }
  T unused = T(0);
  block_reduce2<T, false>(d, unused, buf);
  // (4)
  if (threadIdx.x == 0) {
    part[blockIdx.x] = d;
    __threadfence();
    last = atomicAdd(&ctl[2], 1) == grid - 1;
  }
  __syncthreads();
  if (!last || (TPEPS_ABLATE & 8)) return;
  __threadfence();
  T s = T(0);
  for (int b = threadIdx.x; b < grid; b += FC_NT) s += __ldcg(part + b);
  block_reduce2<T, false>(s, unused, buf);
  if (threadIdx.x == 0) {
    dist2[0] = s;
    const int it = ctl[0] + 1;
    ctl[0] = it;
    const double tol = conv_tol[0];
    ctl[1] = (it < ctl[3] && static_cast<double>(s) > tol * tol) ? 0 : 1;
    ctl[2] = 0;
    gmax[0] = gmax[1] = 0ull;  // every block read them before it added its dist2
  }
}

template <typename T>
int launch(T* C, T* Tt, T* dist2, const double* conv_tol, int* ctl, T* part, unsigned* bar,
           const T* rawC, const T* rawT, const int64_t* pC, const int64_t* pT, int64_t nC,
           int64_t nT, cudaStream_t stream) {
  static int grid = 0;
  cudaError_t e = cudaSuccess;
  if (grid == 0)
    e = coop_grid(frozen_commit_kernel<T>, FC_NT, FC_BLOCKS_PER_SM, FC_MAX_GRID, grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&C, &Tt, &dist2, &conv_tol, &ctl, &part, &bar, &rawC, &rawT, &pC, &pT, &nC,
                  &nT};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(frozen_commit_kernel<T>),
                                  dim3(grid), dim3(FC_NT), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---- frozen_epilogue_vjp ---------------------------------------------------

// per block of the grid, the partial max of |z| and the partial sum g.z of
// one tensor: out[b] and out[GRID + b]
template <typename T>
__device__ void epi_local(const T* __restrict__ raw, const int64_t* __restrict__ partner,
                          const T* __restrict__ g, int64_t n, T* buf, T* out) {
  T m = T(0), d = T(0);
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride) {
    const T z = sym_at(raw, partner, e);
    m = fmax(m, fabs(z));
    d += g[e] * z;
  }
  m = block_reduce(m, true, buf);
  d = block_reduce(d, false, buf);
  if (threadIdx.x == 0) {
    out[blockIdx.x] = m;
    out[GRID + blockIdx.x] = d;
  }
}

template <typename T>
__device__ T reduce_parts(const T* __restrict__ part, bool is_max, T* buf) {
  T v = T(0);
  for (int b = threadIdx.x; b < GRID; b += NT) v = is_max ? fmax(v, part[b]) : v + part[b];
  return block_reduce(v, is_max, buf);
}

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_vjp_reduce(const T* __restrict__ rawC, const T* __restrict__ rawT,
                    const int64_t* __restrict__ pC, const int64_t* __restrict__ pT,
                    const T* __restrict__ gC, const T* __restrict__ gT, int64_t nC, int64_t nT,
                    T* __restrict__ part) {
  __shared__ T buf[NT];
  epi_local(rawC, pC, gC, nC, buf, part);
  epi_local(rawT, pT, gT, nT, buf, part + 2 * GRID);
}

// the elements at the max, counted per block of the frozen layout
template <typename T>
__device__ void epi_count(const T* __restrict__ raw, const int64_t* __restrict__ partner,
                          const int* __restrict__ blk, int64_t n, const T* __restrict__ part,
                          int* __restrict__ cnt, T* buf) {
  const T m = reduce_parts(part, true, buf);
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride)
    if (fabs(sym_at(raw, partner, e)) == m) atomicAdd(&cnt[blk[e]], 1);
}

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_vjp_count(const T* __restrict__ rawC, const T* __restrict__ rawT,
                   const int64_t* __restrict__ pC, const int64_t* __restrict__ pT,
                   const int* __restrict__ bC, const int* __restrict__ bT, int64_t nC, int64_t nT,
                   const T* __restrict__ part, int* __restrict__ cntC, int* __restrict__ cntT) {
  __shared__ T buf[NT];
  epi_count(rawC, pC, bC, nC, part, cntC, buf);
  epi_count(rawT, pT, bT, nT, part + 2 * GRID, cntT, buf);
}

// zbar at element e: g/m minus, at a tie, coef w sign(z) with the block's
// weight w = 1 / (tied blocks * ties in e's block)
template <typename T>
__device__ __forceinline__ T zbar_at(const T* __restrict__ g, const int* __restrict__ blk,
                                     const int* __restrict__ cnt, int64_t e, T z, T m, T inv,
                                     T coef, T ntb, int sg_norm) {
  T v = g[e] * inv;
  if (!sg_norm && fabs(z) == m) {
    const T w = T(1) / (ntb * T(cnt[blk[e]]));
    v -= z > T(0) ? coef * w : -(coef * w);
  }
  return v;
}

template <typename T>
__device__ void epi_apply(const T* __restrict__ raw, const int64_t* __restrict__ partner,
                          const T* __restrict__ g, const int* __restrict__ blk,
                          const int* __restrict__ cnt, int nblk, T* __restrict__ x, int64_t n,
                          const T* __restrict__ part, int sg_norm, T* buf) {
  const T m = reduce_parts(part, true, buf);
  const T inv = T(1) / m;
  T coef = T(0), ntb = T(1);
  if (!sg_norm) {
    coef = reduce_parts(part + GRID, false, buf) * inv * inv;
    T nb = T(0);
    for (int b = threadIdx.x; b < nblk; b += NT) nb += cnt[b] > 0 ? T(1) : T(0);
    ntb = block_reduce(nb, false, buf);
  }
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride) {
    const int64_t p = partner[e];
    // z and its partner's z are equal bit for bit; their blocks may differ
    const T z = sym_at(raw, partner, e);
    const T zb = zbar_at(g, blk, cnt, e, z, m, inv, coef, ntb, sg_norm);
    x[e] = T(0.5) * (zb + (p >= 0 ? zbar_at(g, blk, cnt, p, z, m, inv, coef, ntb, sg_norm)
                                  : T(0)));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_vjp_apply(const T* __restrict__ rawC, const T* __restrict__ rawT,
                   const int64_t* __restrict__ pC, const int64_t* __restrict__ pT,
                   const T* __restrict__ gC, const T* __restrict__ gT, const int* __restrict__ bC,
                   const int* __restrict__ bT, const int* __restrict__ cntC,
                   const int* __restrict__ cntT, int nbC, int nbT, T* __restrict__ xC,
                   T* __restrict__ xT, int64_t nC, int64_t nT, const T* __restrict__ part,
                   int sg_norm) {
  __shared__ T buf[NT];
  epi_apply(rawC, pC, gC, bC, cntC, nbC, xC, nC, part, sg_norm, buf);
  epi_apply(rawT, pT, gT, bT, cntT, nbT, xT, nT, part + 2 * GRID, sg_norm, buf);
}

template <typename T>
int epilogue_vjp_launch(const T* rawC, const T* rawT, const int64_t* pC, const int64_t* pT,
                        const T* gC, const T* gT, const int* bC, const int* bT, int* cntC,
                        int* cntT, int nbC, int nbT, T* xC, T* xT, T* part, int64_t nC,
                        int64_t nT, int sg_norm, cudaStream_t stream) {
  epilogue_vjp_reduce<T><<<GRID, NT, 0, stream>>>(rawC, rawT, pC, pT, gC, gT, nC, nT, part);
  if (!sg_norm)
    epilogue_vjp_count<T><<<GRID, NT, 0, stream>>>(rawC, rawT, pC, pT, bC, bT, nC, nT, part,
                                                   cntC, cntT);
  epilogue_vjp_apply<T><<<GRID, NT, 0, stream>>>(rawC, rawT, pC, pT, gC, gT, bC, bT, cntC, cntT,
                                                 nbC, nbT, xC, xT, nC, nT, part, sg_norm);
  return cudaGetLastError();
}

// ---- adjoint_commit --------------------------------------------------------

// scal = [delta, |ybar|^2, tol^2] (f64); ctl = [i, done, arrival counter,
// max_iter, grew, diverged]
template <typename T>
__global__ void __launch_bounds__(NT)
adjoint_commit_kernel(T* __restrict__ da, const T* __restrict__ dai, int64_t na,
                      const T* __restrict__ uC, int64_t nC, const T* __restrict__ uT, int64_t nT,
                      double* __restrict__ scal, int* __restrict__ ctl, T* __restrict__ part) {
  __shared__ T buf[NT];
  __shared__ int last;
  if (ctl[1]) return;  // the loop has ended
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  for (int64_t e = e0; e < na; e += stride) da[e] += dai[e];
  T s = T(0);
  for (int64_t e = e0; e < nC; e += stride) s += uC[e] * uC[e];
  for (int64_t e = e0; e < nT; e += stride) s += uT[e] * uT[e];
  s = block_reduce(s, false, buf);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(&ctl[2], 1) == GRID - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T d = T(0);
  for (int b = threadIdx.x; b < GRID; b += NT) d += __ldcg(part + b);
  d = block_reduce(d, false, buf);
  if (threadIdx.x == 0) {
    const double dn = static_cast<double>(d);
    const double cn = scal[1], tol2 = scal[2];
    const int it = ctl[0] + 1;
    const int grew = dn > scal[0] ? ctl[4] + 1 : 0;
    scal[0] = dn;
    ctl[0] = it;
    ctl[4] = grew;
    const bool go = it < ctl[3] && dn > tol2 * cn && grew < 4 && dn < 1.0e4 * cn;
    ctl[1] = go ? 0 : 1;
    ctl[5] = ((grew >= 4 || dn >= 1.0e4 * cn) && dn > tol2 * cn) ? 1 : 0;
    ctl[2] = 0;
  }
}

}  // namespace

extern "C" {

int tpeps_frozen_commit_partials(void) { return FC_MAX_GRID; }

int tpeps_frozen_epilogue_vjp_partials(void) { return 4 * GRID; }

int tpeps_adjoint_commit_partials(void) { return GRID; }

int tpeps_frozen_epilogue_vjp_f64(const double* rawC, const double* rawT, const int64_t* pC,
                                  const int64_t* pT, const double* gC, const double* gT,
                                  const int* bC, const int* bT, int* cntC, int* cntT, int nbC,
                                  int nbT, double* xC, double* xT, double* part, int64_t nC,
                                  int64_t nT, int sg_norm, void* stream) {
  return epilogue_vjp_launch<double>(rawC, rawT, pC, pT, gC, gT, bC, bT, cntC, cntT, nbC, nbT,
                                     xC, xT, part, nC, nT, sg_norm,
                                     static_cast<cudaStream_t>(stream));
}

int tpeps_frozen_epilogue_vjp_f32(const float* rawC, const float* rawT, const int64_t* pC,
                                  const int64_t* pT, const float* gC, const float* gT,
                                  const int* bC, const int* bT, int* cntC, int* cntT, int nbC,
                                  int nbT, float* xC, float* xT, float* part, int64_t nC,
                                  int64_t nT, int sg_norm, void* stream) {
  return epilogue_vjp_launch<float>(rawC, rawT, pC, pT, gC, gT, bC, bT, cntC, cntT, nbC, nbT, xC,
                                    xT, part, nC, nT, sg_norm,
                                    static_cast<cudaStream_t>(stream));
}

int tpeps_adjoint_commit_f64(double* da, const double* dai, int64_t na, const double* uC,
                             int64_t nC, const double* uT, int64_t nT, double* scal, int* ctl,
                             double* part, void* stream) {
  adjoint_commit_kernel<double><<<GRID, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      da, dai, na, uC, nC, uT, nT, scal, ctl, part);
  return cudaGetLastError();
}

int tpeps_adjoint_commit_f32(float* da, const float* dai, int64_t na, const float* uC,
                             int64_t nC, const float* uT, int64_t nT, double* scal, int* ctl,
                             float* part, void* stream) {
  adjoint_commit_kernel<float><<<GRID, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      da, dai, na, uC, nC, uT, nT, scal, ctl, part);
  return cudaGetLastError();
}

// bar: two unsigned counters and two 64-bit maxima (8-byte aligned at bar +
// 2), zero before the call and zero after it
int tpeps_frozen_commit_bar_words(void) { return 6; }

int tpeps_frozen_commit_f64(double* C, double* Tt, double* dist2, const double* conv_tol,
                            int* ctl, double* part, unsigned* bar, const double* rawC,
                            const double* rawT, const int64_t* pC, const int64_t* pT,
                            int64_t nC, int64_t nT, void* stream) {
  return launch<double>(C, Tt, dist2, conv_tol, ctl, part, bar, rawC, rawT, pC, pT, nC, nT,
                        static_cast<cudaStream_t>(stream));
}

int tpeps_frozen_commit_f32(float* C, float* Tt, float* dist2, const double* conv_tol, int* ctl,
                            float* part, unsigned* bar, const float* rawC, const float* rawT,
                            const int64_t* pC, const int64_t* pT, int64_t nC, int64_t nT,
                            void* stream) {
  return launch<float>(C, Tt, dist2, conv_tol, ctl, part, bar, rawC, rawT, pC, pT, nC, nT,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
