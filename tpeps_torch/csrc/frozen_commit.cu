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
// bits, which order like the values: no order to fix; a NaN is the maximum,
// as in the twin).  (2) A grid barrier
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
//   or in two, and an element ties exactly where its partner does.  One
//   cooperative launch by frozen_commit's design: (a) each thread zeroes its
//   share of the tie counts, keeps z, ybar, its partner's ybar and index of its
//   first EV_KEEP elements in registers, folds |z| into the C and T maxima as
//   bits (a NaN above inf: that tensor's cotangent NaN, as the twin's) and
//   ybar.z into the dot partials (one a block, warps in order); the maxima meet
//   as global atomic maxima.  (b) After the grid barrier every block reads the
//   maxima and sums the dot partials in one fixed order (the same bits in every
//   block), counts its ties per layout block (integer atomics; a block's first
//   tie counts the block in its tensor's tied-block count) and (c) writes every
//   element off the maximum (weight 0), the stores overlapping the wait at (d)
//   a second barrier, skipped at sg_norm, at which every block arrives and only
//   those holding a tie wait (coop.cuh's grid_arrive, grid_wait), after which
//   the elements at the maximum are written (their counts' indices found before
//   the barrier, the counts read at once).  The last block done reading the
//   maxima and the counts zeroes them: every launch leaves its words zero.  At
//   sg_norm the result is the twin's bit for bit (its products are never fused
//   into an FMA); else the dot's order differs.  Bound: raw, partner index,
//   ybar and xbar, 32 bytes an element (the partners' values are elements of
//   the same buffers), and with the scale differentiated its block id, 36:
//   8.6 MB, 2.6 us at D=8, chi=160.
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

// timing copies (results wrong; timing only): frozen_commit's 1 no work
// after the done read, 2 no grid barrier, 4 no commit stores, 8 no last
// block's sum, 16 no partner gather; frozen_epilogue_vjp's 32 the launch
// alone, 64 no grid barriers, 128 no stores, 256 no second barrier, 512 no
// partner gathers
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif

namespace {

constexpr int NT = 256;
constexpr int GRID = 264;  // adjoint_commit's grid
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

// the FC_NT-thread kernels' block reductions of two values at once (a sum,
// or a max of |x|'s bits), in a fixed order: an xor butterfly in each warp
// (every lane ends with the same bits), then the warps in order; two
// barriers.  buf: 2 * FC_NT / 32 values.
template <typename V, bool MAX>
__device__ __forceinline__ V combine(V a, V b) {
  if constexpr (MAX) return a > b ? a : b;
  else return a + b;
}

template <typename V, bool MAX>
__device__ __forceinline__ void block_reduce2(V& a, V& b, V* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const V x = __shfl_xor_sync(0xffffffffu, a, o), y = __shfl_xor_sync(0xffffffffu, b, o);
    a = combine<V, MAX>(a, x);
    b = combine<V, MAX>(b, y);
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
    a = combine<V, MAX>(a, buf[w]);
    b = combine<V, MAX>(b, buf[NW + w]);
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
  __shared__ unsigned long long ubuf[2 * FC_NT / 32];
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
  unsigned long long mC = 0ull, mT = 0ull;
#pragma unroll
  for (int r = 0; r < KEEP; ++r) {
    const int64_t e = tid + r * stride;
    v[r] = old[r] = T(0);
    if (e < nC) {
      v[r] = (TPEPS_ABLATE & 16) ? rawC[e] : sym_at(rawC, pC, e);
      old[r] = C[e];
      mC = max(mC, abs_bits(v[r]));
    } else if (e < n) {
      v[r] = (TPEPS_ABLATE & 16) ? rawT[e - nC] : sym_at(rawT, pT, e - nC);
      old[r] = Tt[e - nC];
      mT = max(mT, abs_bits(v[r]));
    }
  }
  for (int64_t e = tid + KEEP * stride; e < n; e += stride) {
    if (e < nC) mC = max(mC, abs_bits(sym_at(rawC, pC, e)));
    else mT = max(mT, abs_bits(sym_at(rawT, pT, e - nC)));
  }
  if (done) return;  // the loop has ended: the state stays untouched
  block_reduce2<unsigned long long, true>(mC, mT, ubuf);
  unsigned long long* gmax = reinterpret_cast<unsigned long long*>(bar + 2);
  if (threadIdx.x == 0) {
    atomicMax(gmax, mC);
    atomicMax(gmax + 1, mT);
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

// the symmetrized z of element e of the index space C, T (raw's value and
// its partner's, the partner's z being the same bits), its cotangent g, its
// partner's (0 where there is none) and the partner's index in its tensor
// (-1: none)
template <typename T>
__device__ __forceinline__ void vjp_load(int64_t e, int64_t nC, const T* __restrict__ rawC,
                                         const T* __restrict__ rawT,
                                         const int64_t* __restrict__ pC,
                                         const int64_t* __restrict__ pT,
                                         const T* __restrict__ gC, const T* __restrict__ gT,
                                         T& z, T& g, T& gp, int64_t& p) {
  const bool c = e < nC;
  const int64_t i = c ? e : e - nC;
  const T* raw = c ? rawC : rawT;
  const T* gg = c ? gC : gT;
  p = (c ? pC : pT)[i];
  const int64_t j = (TPEPS_ABLATE & 512) ? i : p;  // the timing copy without gathers
  z = T(0.5) * (raw[i] + (p >= 0 ? raw[j] : T(0)));
  g = gg[i];
  gp = p >= 0 ? gg[j] : T(0);
}

// the index in cnt (C's layout blocks, then T's) of the tie count of entry i
// of C (c) or of T
__device__ __forceinline__ int count_index(bool c, int64_t i, const int* __restrict__ bC,
                                           const int* __restrict__ bT, int nbC) {
  return c ? bC[i] : nbC + bT[i];
}

// The words at bar: the grid barrier's two counters, a counter of the blocks
// done reading, the second barrier's arrivals, the two 64-bit maxima (C, T)
// and the two tied-block counts; zero before the launch and after it.
constexpr int EV_BAR_WORDS = 10;
// values a thread keeps across the barriers (4 x 512 x 132 = 270,336: a D=8
// chi=160 move's 237,601 all kept)
constexpr int EV_KEEP = 4;

template <typename T>
__global__ void __launch_bounds__(FC_NT)
epilogue_vjp_kernel(const T* __restrict__ rawC, const T* __restrict__ rawT,
                    const int64_t* __restrict__ pC, const int64_t* __restrict__ pT,
                    const T* __restrict__ gC, const T* __restrict__ gT,
                    const int* __restrict__ bC, const int* __restrict__ bT, int* __restrict__ cnt,
                    unsigned* __restrict__ bar, int nbC, int nbT, T* __restrict__ xC,
                    T* __restrict__ xT, T* __restrict__ part, int64_t nC, int64_t nT,
                    int sg_norm) {
  __shared__ T buf[2 * FC_NT / 32];
  __shared__ unsigned long long ubuf[2 * FC_NT / 32];
  __shared__ unsigned long long s_m[2];
  if (TPEPS_ABLATE & 32) return;
  const bool diff = !sg_norm;
  const int grid = static_cast<int>(gridDim.x);
  const int64_t n = nC + nT, stride = static_cast<int64_t>(grid) * FC_NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * FC_NT + threadIdx.x;
  unsigned long long* gmax = reinterpret_cast<unsigned long long*>(bar + 4);
  unsigned* ntb = bar + 8;
  // (a) this thread's share of the tie counts zeroed; z, g, the partner's g
  // and the partner's index of its first EV_KEEP elements kept in registers,
  // with the scale differentiated also the index of its tie count (read
  // with the rest, off the tie path's chain); |z| folded into the maxima as
  // bits (a NaN above inf) and g.z into the dot partials
  if (diff)
    for (int64_t b = tid; b < nbC + nbT; b += stride) cnt[b] = 0;
  T z[EV_KEEP], g[EV_KEEP], gp[EV_KEEP];
  int pp[EV_KEEP], ie[EV_KEEP];
  unsigned long long mC = 0ull, mT = 0ull;
  T dC = T(0), dT = T(0);
#pragma unroll
  for (int r = 0; r < EV_KEEP; ++r) {
    const int64_t e = tid + r * stride;
    z[r] = g[r] = gp[r] = T(0);
    pp[r] = -1;
    if (e < n) {
      int64_t q;
      vjp_load(e, nC, rawC, rawT, pC, pT, gC, gT, z[r], g[r], gp[r], q);
      pp[r] = static_cast<int>(q);
      if (diff) ie[r] = count_index(e < nC, e < nC ? e : e - nC, bC, bT, nbC);
      if (e < nC) {
        mC = max(mC, abs_bits(z[r]));
        dC += g[r] * z[r];
      } else {
        mT = max(mT, abs_bits(z[r]));
        dT += g[r] * z[r];
      }
    }
  }
  for (int64_t e = tid + EV_KEEP * stride; e < n; e += stride) {
    T zz, gg, unused;
    int64_t q;
    vjp_load(e, nC, rawC, rawT, pC, pT, gC, gT, zz, gg, unused, q);
    if (e < nC) {
      mC = max(mC, abs_bits(zz));
      dC += gg * zz;
    } else {
      mT = max(mT, abs_bits(zz));
      dT += gg * zz;
    }
  }
  block_reduce2<unsigned long long, true>(mC, mT, ubuf);
  if (diff) block_reduce2<T, false>(dC, dT, buf);
  if (threadIdx.x == 0) {
    atomicMax(gmax, mC);
    atomicMax(gmax + 1, mT);
    if (diff) {
      part[blockIdx.x] = dC;
      part[grid + blockIdx.x] = dT;
    }
  }
  if (!(TPEPS_ABLATE & 64)) grid_barrier(bar);
  // (b) the maxima and, with the scale differentiated, the dot sums (the
  // partials in one fixed order, the same bits in every block); the ties
  // counted per layout block, the first tie of a block counting the block
  // in its tensor's tied-block count
  if (threadIdx.x < 2) s_m[threadIdx.x] = __ldcg(gmax + threadIdx.x);
  T sC = T(0), sT = T(0);
  if (diff) {
    for (int b = threadIdx.x; b < grid; b += FC_NT) {
      sC += __ldcg(part + b);
      sT += __ldcg(part + grid + b);
    }
    block_reduce2<T, false>(sC, sT, buf);
  }
  __syncthreads();
  const T mCv = from_bits<T>(s_m[0]), mTv = from_bits<T>(s_m[1]);
  const T iC = T(1) / mCv, iT = T(1) / mTv;
  const T coefC = sC * iC * iC, coefT = sT * iT * iT;
  // the kept elements at the maximum, and the indices of their partners'
  // tie counts (the partner of a tied entry ties too)
  unsigned tied = 0u;
  bool any_tie = false;  // this thread's, past the kept elements too
  int ip[EV_KEEP];
  auto count = [&](int64_t e, int i_e) {
    if (atomicAdd(cnt + i_e, 1) == 0) atomicAdd(ntb + (e < nC ? 0 : 1), 1u);
  };
  if (diff) {
#pragma unroll
    for (int r = 0; r < EV_KEEP; ++r) {
      const int64_t e = tid + r * stride;
      if (e < n && fabs(z[r]) == (e < nC ? mCv : mTv)) {
        tied |= 1u << r;
        ip[r] = pp[r] >= 0 ? count_index(e < nC, pp[r], bC, bT, nbC) : -1;
        count(e, ie[r]);
      }
    }
    for (int64_t e = tid + EV_KEEP * stride; e < n; e += stride) {
      T zz, gg, gq;
      int64_t q;
      vjp_load(e, nC, rawC, rawT, pC, pT, gC, gT, zz, gg, gq, q);
      if (fabs(zz) == (e < nC ? mCv : mTv)) {
        any_tie = true;
        count(e, count_index(e < nC, e < nC ? e : e - nC, bC, bT, nbC));
      }
    }
  }
  // xbar = (zbar[e] + zbar[partner]) / 2, w and wp the weights of e's and of
  // its partner's block (0 off the maximum; zbar = g/m - (coef 0) sign(z)
  // there, as the twin)
  const T zero = T(0);
  auto store = [&](int64_t e, T zz, T gg, T gq, bool h, T w, T wp) {
    const bool c = e < nC;
    const T inv = c ? iC : iT, coef = c ? coefC : coefT, s = sgn(zz);
    const T zb = diff ? scale_vjp(gg, inv, coef, w, s) : mul_rn(gg, inv);
    const T zp = diff ? scale_vjp(gq, inv, coef, wp, s) : mul_rn(gq, inv);
    if (!(TPEPS_ABLATE & 128)) *(c ? xC + e : xT + (e - nC)) = T(0.5) * (zb + (h ? zp : zero));
  };
  // (c) every element off the maximum, the stores overlapping the second
  // barrier's wait
#pragma unroll
  for (int r = 0; r < EV_KEEP; ++r) {
    const int64_t e = tid + r * stride;
    if (e < n && !((tied >> r) & 1u)) store(e, z[r], g[r], gp[r], pp[r] >= 0, zero, zero);
  }
  for (int64_t e = tid + EV_KEEP * stride; e < n; e += stride) {
    T zz, gg, gq;
    int64_t q;
    vjp_load(e, nC, rawC, rawT, pC, pT, gC, gT, zz, gg, gq, q);
    if (!diff || fabs(zz) != (e < nC ? mCv : mTv)) store(e, zz, gg, gq, q >= 0, zero, zero);
  }
  // (d) with the scale differentiated, the second barrier (every tie
  // counted; only the blocks holding a tie wait), then the elements at the
  // maximum: w = 1 / (tied blocks x ties in the block), the counts read at
  // once
  if (diff && __syncthreads_or(tied != 0u || any_tie)) {
    if (!(TPEPS_ABLATE & (64 | 256))) {
      grid_arrive(bar + 3);
      grid_wait(bar + 3);
    }
    auto weight = [&](bool c, int i) {
      return i < 0 ? zero : T(1) / (T(__ldcg(ntb + (c ? 0 : 1))) * T(__ldcg(cnt + i)));
    };
#pragma unroll
    for (int r = 0; r < EV_KEEP; ++r) {
      const int64_t e = tid + r * stride;
      if ((tied >> r) & 1u)
        store(e, z[r], g[r], gp[r], pp[r] >= 0, weight(e < nC, ie[r]), weight(e < nC, ip[r]));
    }
    for (int64_t e = tid + EV_KEEP * stride; e < n; e += stride) {
      T zz, gg, gq;
      int64_t q;
      vjp_load(e, nC, rawC, rawT, pC, pT, gC, gT, zz, gg, gq, q);
      const bool c = e < nC;
      if (fabs(zz) == (c ? mCv : mTv))
        store(e, zz, gg, gq, q >= 0,
              weight(c, count_index(c, c ? e : e - nC, bC, bT, nbC)),
              weight(c, q >= 0 ? count_index(c, q, bC, bT, nbC) : -1));
    }
  } else if (diff && !(TPEPS_ABLATE & (64 | 256))) {
    grid_arrive(bar + 3);
  }
  // the last block done reading the maxima and the tied-block counts zeroes
  // them and the second barrier's arrivals (every block has read them and
  // arrived by then, and none waits)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // the arrival above counted before this block counts as done
    if (atomicAdd(bar + 2, 1u) == gridDim.x - 1) {
      gmax[0] = gmax[1] = 0ull;
      ntb[0] = ntb[1] = 0u;
      bar[2] = bar[3] = 0u;
    }
  }
}

template <typename T>
int epilogue_vjp_launch(const T* rawC, const T* rawT, const int64_t* pC, const int64_t* pT,
                        const T* gC, const T* gT, const int* bC, const int* bT, int* cnt,
                        unsigned* bar, int nbC, int nbT, T* xC, T* xT, T* part, int64_t nC,
                        int64_t nT, int sg_norm, cudaStream_t stream) {
  static int grid = 0;
  cudaError_t e = cudaSuccess;
  if (grid == 0)
    e = coop_grid(epilogue_vjp_kernel<T>, FC_NT, FC_BLOCKS_PER_SM, FC_MAX_GRID, grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&rawC, &rawT, &pC, &pT, &gC, &gT, &bC, &bT, &cnt, &bar, &nbC, &nbT,
                  &xC, &xT, &part, &nC, &nT, &sg_norm};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(epilogue_vjp_kernel<T>),
                                  dim3(grid), dim3(FC_NT), args, 0, stream);
  if (e != cudaSuccess) return e;
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

int tpeps_frozen_epilogue_vjp_partials(void) { return 2 * FC_MAX_GRID; }

// bar: frozen_epilogue_vjp's words (EV_BAR_WORDS), zero before the call and
// zero after it
int tpeps_frozen_epilogue_vjp_bar_words(void) { return EV_BAR_WORDS; }

int tpeps_adjoint_commit_partials(void) { return GRID; }

// cnt: nbC + nbT ints of scratch (C's tie counts, then T's), zeroed by the
// kernel
int tpeps_frozen_epilogue_vjp_f64(const double* rawC, const double* rawT, const int64_t* pC,
                                  const int64_t* pT, const double* gC, const double* gT,
                                  const int* bC, const int* bT, int* cnt, unsigned* bar, int nbC,
                                  int nbT, double* xC, double* xT, double* part, int64_t nC,
                                  int64_t nT, int sg_norm, void* stream) {
  return epilogue_vjp_launch<double>(rawC, rawT, pC, pT, gC, gT, bC, bT, cnt, bar, nbC, nbT, xC,
                                     xT, part, nC, nT, sg_norm,
                                     static_cast<cudaStream_t>(stream));
}

int tpeps_frozen_epilogue_vjp_f32(const float* rawC, const float* rawT, const int64_t* pC,
                                  const int64_t* pT, const float* gC, const float* gT,
                                  const int* bC, const int* bT, int* cnt, unsigned* bar, int nbC,
                                  int nbT, float* xC, float* xT, float* part, int64_t nC,
                                  int64_t nT, int sg_norm, void* stream) {
  return epilogue_vjp_launch<float>(rawC, rawT, pC, pT, gC, gT, bC, bT, cnt, bar, nbC, nbT, xC,
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
