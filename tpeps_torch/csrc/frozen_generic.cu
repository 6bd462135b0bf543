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
//   w = 1 / (n_tied_blocks * n_tied_in_the_block).  One cooperative launch
//   for every MAX_SEG rows of the table, by generic_epilogue's design: the
//   segments one index space, EPI_KEEP values and their cotangents kept in
//   registers, the maxima as shared and then global atomic maxima on |x|'s
//   bits (a NaN above inf: that output's cotangent NaN, as the twin's); the
//   kernel zeroes its rows' tie counts itself.  The dot g.x a segment: at
//   each step a warp's 32 elements are consecutive, summed by a butterfly
//   (or lane by lane across a segment boundary) into a slot a warp and
//   segment, then a partial a block and segment.  After the grid barrier
//   every block reads the maxima and, for the segments it holds, sums the
//   partials in one fixed order, loaded at once (the same bits in every
//   block), counts its ties per layout block (integer atomics; a block's
//   first tie counts the block in its segment's tied-block count) and
//   writes every element off the maximum (weight 0).  A second barrier,
//   skipped with sg_norm, at which every block arrives and only those
//   holding a tie wait, and then the elements at the maximum.  The last
//   block done reading the maxima and the counts zeroes them: every launch
//   leaves its words zero.
//   With sg_norm the result is the twin's bit for bit (its products are
//   never fused into an FMA); else the dot's order differs.
//
// What bounds them on an H100: one or two reads and one write of a move's
// outputs (a few hundred thousand elements at D=8, chi=160; generic_epilogue
// 16 bytes an element, 8.1 MB, 2.4 us; generic_epilogue_vjp 28 with the
// scale differentiated, 14.2 MB, 4.2 us): microseconds, latency rather than
// bandwidth.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "coop.cuh"

// timing copies (results wrong; timing only): generic_epilogue's 1 no work
// after the table is staged, 2 no grid barrier, 4 no stores;
// generic_epilogue_vjp's 32 the launch alone, 64 no grid barriers, 128 no
// stores, 256 no second barrier
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif

namespace {

constexpr int NT = 256;
constexpr int GRID = 264;  // sweep_commit's grid
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

// The words at bar: the grid barrier's two counters, a counter of the blocks
// done reading, the second barrier's arrivals, a 64-bit maximum a segment
// (at bar + 4) and a tied-block count a segment (at bar + 4 + 2 MAX_SEG);
// zero before the launch and after it.
constexpr int VJP_BAR_WORDS = 4 + 3 * MAX_SEG;
constexpr int NW = NT / 32;  // warps a block
constexpr int SUMS = 4;      // segments whose dot partials a block sums at once

// the sum of a warp's 32 values, the same bits in every lane (an xor
// butterfly)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// one step of a segmented inclusive scan over a warp (Hillis-Steele): the
// lanes whose segment q runs back o lanes add the value o lanes back; after
// the steps 1, 2, 4, 8, 16 the last lane of each run of equal q holds the
// run's sum (a run of lanes: the segments of consecutive elements)
template <typename T>
__device__ __forceinline__ void scan_step(T& d, int q, int o, int lane) {
  const T x = __shfl_up_sync(0xffffffffu, d, o);
  const int qo = __shfl_up_sync(0xffffffffu, q, o);
  if (lane >= o && qo == q) d += x;
}

template <typename T>
__global__ void __launch_bounds__(NT)
vjp_kernel(const T* __restrict__ raw, const T* __restrict__ g, const int64_t* __restrict__ seg,
           int nseg, const int* __restrict__ blk, T* __restrict__ part, int* __restrict__ cnt,
           unsigned* __restrict__ bar, int sg_norm, T* __restrict__ xbar) {
  __shared__ int64_t s_src[MAX_SEG], s_dst[MAX_SEG], s_beg[MAX_SEG + 1];
  __shared__ int64_t s_b0[MAX_SEG], s_b1[MAX_SEG];
  __shared__ unsigned long long s_max[MAX_SEG], s_touch;
  __shared__ T s_inv[MAX_SEG], s_coef[MAX_SEG], s_dot[MAX_SEG][NW], s_red[SUMS][NW];
  __shared__ int s_list[MAX_SEG], s_nlist, s_last;
  if (TPEPS_ABLATE & 32) return;
  const bool diff = !sg_norm;
  const int grid = static_cast<int>(gridDim.x), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t stride = static_cast<int64_t>(grid) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  unsigned long long* gmax = reinterpret_cast<unsigned long long*>(bar + 4);
  unsigned* ntb = bar + 4 + 2 * MAX_SEG;
  for (int q = threadIdx.x; q < nseg; q += NT) {  // the table, a row a thread
    s_src[q] = seg[SEGW * q];
    s_dst[q] = seg[SEGW * q + 1];
    s_beg[q + 1] = seg[SEGW * q + 2];
    s_b0[q] = seg[SEGW * q + 3];
    s_b1[q] = seg[SEGW * q + 4];
    s_max[q] = 0ull;
  }
  for (int i = threadIdx.x; i < MAX_SEG * NW; i += NT) s_dot[i / NW][i % NW] = T(0);
  if (threadIdx.x == 0) s_touch = 0ull;
  __syncthreads();
  if (threadIdx.x == 0) {  // the lengths' prefix sums
    s_beg[0] = 0;
    for (int q = 1; q <= nseg; ++q) s_beg[q] += s_beg[q - 1];
  }
  // (a) this thread's share of the rows' tie counts zeroed; the first
  // EPI_KEEP elements and their cotangents kept in registers; |x| folded into
  // the segments' maxima as bits (a NaN above inf), a running max and a
  // shared atomic where the segment changes
  if (diff)
    for (int q = 0; q < nseg; ++q)
      for (int64_t b = s_b0[q] + tid; b < s_b1[q]; b += stride) cnt[b] = 0;
  __syncthreads();
  const int64_t n = s_beg[nseg];
  // (with the scale differentiated also their tie counts' indices, read
  // with the rest, off the tie path's chain)
  T x[EPI_KEEP], gv[EPI_KEEP];
  int sg[EPI_KEEP], ib[EPI_KEEP];
  int s = 0;
#pragma unroll
  for (int r = 0; r < EPI_KEEP; ++r) {
    const int64_t e = tid + r * stride;
    x[r] = gv[r] = T(0);
    sg[r] = -1;
    if (e < n) {
      while (e >= s_beg[s + 1]) ++s;
      sg[r] = s;
      x[r] = raw[s_src[s] + (e - s_beg[s])];
      gv[r] = g[s_dst[s] + (e - s_beg[s])];
      if (diff) ib[r] = blk[s_src[s] + (e - s_beg[s])];
    }
  }
  int cur = -1;
  unsigned long long m = 0ull, touch = 0ull;
#pragma unroll
  for (int r = 0; r < EPI_KEEP; ++r) {
    if (sg[r] != cur) {
      if (cur >= 0) atomicMax(&s_max[cur], m);
      cur = sg[r];
      m = 0ull;
    }
    m = max(m, abs_bits(x[r]));
  }
  // the dot partials g.x a segment: at a step r a warp's 32 elements are
  // consecutive, so its segments are runs of lanes; a segmented scan leaves
  // each run's sum in its last lane, which adds it into the slot of its
  // segment and warp (the runs of a step in distinct slots; the steps in
  // order: a fixed order).  The kept steps' scans run side by side.
  auto run_end = [&](int q, T d) {  // after the scan
    const int qn = __shfl_down_sync(0xffffffffu, q, 1);
    if (q >= 0 && (lane == 31 || qn != q)) s_dot[q][warp] += d;
    if (q >= 0) touch |= 1ull << q;
    __syncwarp();  // another lane may end this slot's run at the next step
  };
  if (diff) {
    T d[EPI_KEEP];
#pragma unroll
    for (int r = 0; r < EPI_KEEP; ++r) d[r] = gv[r] * x[r];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int r = 0; r < EPI_KEEP; ++r) scan_step(d[r], sg[r], o, lane);
    }
#pragma unroll
    for (int r = 0; r < EPI_KEEP; ++r) run_end(sg[r], d[r]);
  }
  // the warp's first element at each step decides, for the whole warp, the
  // steps past EPI_KEEP
  const int64_t w0 = tid - lane;
  s = 0;
  for (int64_t r = EPI_KEEP; w0 + r * stride < n; ++r) {
    const int64_t e = tid + r * stride;
    int q = -1;
    T xe = T(0), ge = T(0);
    if (e < n) {
      while (e >= s_beg[s + 1]) ++s;
      q = s;
      xe = raw[s_src[s] + (e - s_beg[s])];
      ge = g[s_dst[s] + (e - s_beg[s])];
      if (s != cur) {
        if (cur >= 0) atomicMax(&s_max[cur], m);
        cur = s;
        m = 0ull;
      }
      m = max(m, abs_bits(xe));
    }
    if (diff) {
      T d = ge * xe;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) scan_step(d, q, o, lane);
      run_end(q, d);
    }
  }
  if (cur >= 0) atomicMax(&s_max[cur], m);
  if (diff) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) touch |= __shfl_xor_sync(0xffffffffu, touch, o);
    if (lane == 0) atomicOr(&s_touch, touch);
  }
  __syncthreads();
  // the block's maxima merged into the global ones (an atomic max, order
  // free); its dot partial a segment, the warps in order; the list of the
  // segments it holds
  if (threadIdx.x == 0) {
    int k = 0;
    for (unsigned long long t = s_touch; t; t &= t - 1)
      s_list[k++] = __ffsll(static_cast<long long>(t)) - 1;
    s_nlist = k;
  }
  for (int q = threadIdx.x; q < nseg; q += NT) {
    if (s_max[q]) atomicMax(gmax + q, s_max[q]);
    if (diff) {
      T d = s_dot[q][0];
#pragma unroll
      for (int w = 1; w < NW; ++w) d += s_dot[q][w];
      part[static_cast<int64_t>(q) * grid + blockIdx.x] = d;
    }
  }
  if (!(TPEPS_ABLATE & 64)) grid_barrier(bar);
  // (b) every block the same maxima and, for the segments it holds, the same
  // dot sums: SUMS segments at a time, their partials loaded at once (thread
  // t the partials t, t + NT, ... of each, added in order; the first SUMS
  // beside the maxima), then a butterfly and the warps in order (the same
  // bits in every block)
  T v[SUMS];
  auto load_sums = [&](int k0) {
#pragma unroll
    for (int k = 0; k < SUMS; ++k) {
      v[k] = T(0);
      if (diff && k0 + k < s_nlist) {
        const T* pq = part + static_cast<int64_t>(s_list[k0 + k]) * grid;
#pragma unroll
        for (int j = 0; j < EPI_MAX_GRID / NT; ++j)
          if (threadIdx.x + j * NT < grid) v[k] += __ldcg(pq + threadIdx.x + j * NT);
      }
    }
  };
  load_sums(0);
  for (int q = threadIdx.x; q < nseg; q += NT) {
    s_max[q] = __ldcg(gmax + q);
    s_inv[q] = T(1) / from_bits<T>(s_max[q]);
  }
  __syncthreads();
  if (diff) {
    for (int k0 = 0; k0 < s_nlist; k0 += SUMS) {
      if (k0 > 0) load_sums(k0);
#pragma unroll
      for (int k = 0; k < SUMS; ++k) {
        v[k] = warp_sum(v[k]);
        if (lane == 0) s_red[k][warp] = v[k];
      }
      __syncthreads();
      if (threadIdx.x < SUMS && k0 + threadIdx.x < s_nlist) {
        T d = s_red[threadIdx.x][0];
#pragma unroll
        for (int w = 1; w < NW; ++w) d += s_red[threadIdx.x][w];
        const int q = s_list[k0 + threadIdx.x];
        s_coef[q] = d * s_inv[q] * s_inv[q];
      }
      __syncthreads();
    }
  }
  // the ties counted per layout block, the first tie of a block counting the
  // block; every element off the maximum written (its weight 0: g/m - (coef
  // 0) sign(x), as the twin), the stores overlapping the second barrier's
  // wait
  const T zero = T(0);
  auto at_max = [&](int q, T xe) { return diff && fabs(xe) == from_bits<T>(s_max[q]); };
  auto store = [&](int q, int64_t off, T xe, T ge, T w) {
    const T v = diff ? scale_vjp(ge, s_inv[q], s_coef[q], w, sgn(xe)) : mul_rn(ge, s_inv[q]);
    if (!(TPEPS_ABLATE & 128)) xbar[s_src[q] + off] = v;
  };
  auto count = [&](int q, int i) {
    if (atomicAdd(cnt + i, 1) == 0) atomicAdd(ntb + q, 1u);
  };
  unsigned tied = 0u;
  bool any_tie = false;  // past the kept elements
#pragma unroll
  for (int r = 0; r < EPI_KEEP; ++r) {
    const int q = sg[r];
    if (q < 0) continue;
    const int64_t off = tid + r * stride - s_beg[q];
    if (at_max(q, x[r])) {
      tied |= 1u << r;
      count(q, ib[r]);
    } else {
      store(q, off, x[r], gv[r], zero);
    }
  }
  s = 0;
  for (int64_t e = tid + EPI_KEEP * stride; e < n; e += stride) {
    while (e >= s_beg[s + 1]) ++s;
    const int64_t off = e - s_beg[s];
    const T xe = raw[s_src[s] + off];
    if (at_max(s, xe)) {
      any_tie = true;
      count(s, blk[s_src[s] + off]);
    } else {
      store(s, off, xe, g[s_dst[s] + off], zero);
    }
  }
  // (c) with the scale differentiated, the second barrier (every tie
  // counted; only the blocks holding a tie wait), then the elements at the
  // maximum: w = 1 / (tied blocks x ties in the block), both counts read at
  // once
  if (diff && __syncthreads_or(tied != 0u || any_tie)) {
    if (!(TPEPS_ABLATE & (64 | 256))) {
      grid_arrive(bar + 3);
      grid_wait(bar + 3);
    }
    auto weight = [&](int q, int i) {
      return T(1) / (T(__ldcg(ntb + q)) * T(__ldcg(cnt + i)));
    };
#pragma unroll
    for (int r = 0; r < EPI_KEEP; ++r) {
      if (!((tied >> r) & 1u)) continue;
      const int q = sg[r];
      store(q, tid + r * stride - s_beg[q], x[r], gv[r], weight(q, ib[r]));
    }
    s = 0;
    for (int64_t e = tid + EPI_KEEP * stride; e < n; e += stride) {
      while (e >= s_beg[s + 1]) ++s;
      const int64_t off = e - s_beg[s];
      const T xe = raw[s_src[s] + off];
      if (at_max(s, xe))
        store(s, off, xe, g[s_dst[s] + off], weight(s, blk[s_src[s] + off]));
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
    s_last = atomicAdd(bar + 2, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (int q = threadIdx.x; q < nseg; q += NT) {
      gmax[q] = 0ull;
      ntb[q] = 0u;
    }
    if (threadIdx.x == 0) bar[2] = bar[3] = 0u;
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
               int* cnt, unsigned* bar, int sg_norm, T* xbar, cudaStream_t stream) {
  static int grid = 0;
  cudaError_t e = cudaSuccess;
  if (grid == 0) e = coop_grid(vjp_kernel<T>, NT, EPI_BLOCKS_PER_SM, EPI_MAX_GRID, grid);
  if (e != cudaSuccess) return e;
  for (int s0 = 0; s0 < nseg; s0 += MAX_SEG) {
    const int64_t* rows = seg + static_cast<int64_t>(SEGW) * s0;
    int n = nseg - s0 < MAX_SEG ? nseg - s0 : MAX_SEG;
    void* args[] = {&raw, &g, &rows, &n, &blk, &part, &cnt, &bar, &sg_norm, &xbar};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(vjp_kernel<T>), dim3(grid),
                                    dim3(NT), args, 0, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// partials of sweep_commit
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

// part: MAX_SEG x the grid partials (tpeps_generic_epilogue_vjp_partials);
// cnt: an int a block of the table (zeroed by the kernel); bar:
// VJP_BAR_WORDS words, zero before the call and zero after it
int tpeps_generic_epilogue_vjp_partials(void) { return MAX_SEG * EPI_MAX_GRID; }

int tpeps_generic_epilogue_vjp_bar_words(void) { return VJP_BAR_WORDS; }

int tpeps_generic_epilogue_vjp_f64(const double* raw, const double* g, const int64_t* seg,
                                   int nseg, const int* blk, double* part, int* cnt,
                                   unsigned* bar, int sg_norm, double* xbar, void* stream) {
  return vjp_launch<double>(raw, g, seg, nseg, blk, part, cnt, bar, sg_norm, xbar,
                            static_cast<cudaStream_t>(stream));
}

int tpeps_generic_epilogue_vjp_f32(const float* raw, const float* g, const int64_t* seg,
                                   int nseg, const int* blk, float* part, int* cnt,
                                   unsigned* bar, int sg_norm, float* xbar, void* stream) {
  return vjp_launch<float>(raw, g, seg, nseg, blk, part, cnt, bar, sg_norm, xbar,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
