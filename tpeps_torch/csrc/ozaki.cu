// K7: the Ozaki-scheme float64 matrix product on the int8 tensor cores.
//
// Replaces tpeps/linalg/ozaki.py: _split_int8 (:39-81) and _accumulate
// (:92-131), the pieces of ozaki_matmul / ozaki_presplit /
// ozaki_dot_general that backs dot_impl="ozaki[:s]" of the factored C4v
// move (tpeps/ctm/c4v/move_tpu.py:36-72, :205-224).
//
//   ozaki_split: for each row of the "row view" of an f64 matrix (the rows
//     of a left operand A (m, k), the columns of a right operand B (k, n)),
//     mx = max |x| (1 where 0), ex = floor(log2(mx)) + 1, e = 2^ex, and the
//     w-bit digits of |x| 2^-ex, most significant first, read in fixed point
//     28 // w digits (one int32 word) at a time, each times sign(x).  It
//     writes s int8 planes of (rows, kp), kp = k rounded up to 32 with zero
//     digits (exact: a zero digit adds nothing to any product), and e.  A's
//     planes are A's own rows, row-major (m, kp); B's are its columns,
//     (n, kp): both K-major, the only layout the int8 wgmma takes.
//   ozaki_gemm: for each total t = p + q in [2, s + 1], the group sum
//     sum_{p} A_p B_{t-p}^T as int8 x int8 -> int32 products (wgmma
//     .s32.s8.s8, no .satfinite: int32 wraps as XLA's int32 dot does, and a
//     wrapping sum is exact in any order); then, per element, the
//     recombination in _accumulate's order and precision: groups with
//     t w >= 42 chained in float32 (tail = tail 2^((t - t_prev) w) +
//     float(acc_t)), the others added to a float64 sum as acc_t 2^(-t w)
//     from t = s + 1 down, the f32 tail added last, and the sum times
//     e_A[row] e_B[col].  Every rounding step is an explicit _rn intrinsic,
//     so nvcc's FMA contraction cannot change it: the result is bit for bit
//     the twin's.  The scales and tail factors come from the host as a table
//     (tpeps_torch/kernels/ozaki.py:recombination_table), one per total,
//     or at s = 8, w = 7 compiled in (the launcher checks the table against it).
//
// What bounds ozaki_gemm on an H100.  s(s+1)/2 int8 products: 36 x 2mnk
// operations at s = 8.  M2 P (7203 x 7232 by 7232 x 147): 548 G int8
// operations, 0.28 ms at 1979 TOP/s (the FP64 product: 0.23 ms on DMMA).
// The layer products (m = 49 or 98, k = 49 or 98 -> kp 64/128, n = 1.06M)
// read B's planes (542 MB at kp = 64) and write C (415-830 MB): bound by
// bytes, 0.29-0.41 ms.  Two limits shape the design: the register file
// holds the 8 int32 group sums of at most ~6K outputs per SM (32 bytes
// each), and wgmma from shared memory at N = 32 reads 3 KB of operands per
// 65K multiply-adds, more than shared memory delivers at the tensor rate,
// where N = 64 reads 4 KB per 131K: a narrow N starves.  The recombination
// is ~20 floating-point operations and conversions per output, comparable
// to the MMAs at the layer shapes, so it has to be spread over many warps.
//
// Design.  One persistent block per SM walks 64 x 64 output tiles, n
// fastest, so that the blocks working at one time share A's rows through
// L2.  A producer warpgroup (one thread issues) feeds a ring of stages (TMA,
// cp.async.bulk.tensor, 32-byte swizzle, 32 bytes of k per stage: kp is a
// multiple of 32, so no k is padded, and the ring is twice as deep as one
// of 64-byte stages in the same space) through full/empty mbarriers; rows
// past m or n, and planes past s, come in as zeros, so all 36 pairs run
// without a branch.  The two consumer warpgroups compute the same tile with
// m64n64k32 wgmmas from shared memory and split the groups: the high one
// takes totals 9..6 (26 pairs: the float32 tail), the low one 5..2 (10
// pairs: the float64 sum), 4 x 32 int32 registers each; registers go by
// warpgroups, so setmaxnreg moves the producer's to the consumers.  Each
// writes its part of every element into a handoff buffer (two, used in
// turn, rows padded against bank conflicts); after one named barrier both
// finish half the tile each from it, with the exponents read before the
// tile's wgmmas, and store 64-double (512-byte) row runs of C; C's rows are
// not 16-byte aligned (n is odd), so no TMA store.  At s = 8, w = 7, which
// every caller uses, the recombination is compiled in (a table-driven
// instance serves the other s and w): each int32 goes to float64 scaled by
// its power of two in one exact add, and the fused multiply-adds round
// exactly where _accumulate's multiply-then-add does.  Where A has at most
// two row tiles and its planes fit (the layers: 64 KB at m = 98, kp = 64
// and at m = 49, kp = 128), A stays resident and the stages carry B alone,
// each B tile used for every row tile: B's planes come from device memory
// once.  No split-K: the path's shapes have 339-16545 work items for 132
// SMs.  Capturable in a CUDA graph: no host synchronisation, nothing
// allocated, the attributes set on the first call.
//
// What bounds ozaki_split: bytes.  X is read once and s planes of kp bytes
// a row are written: M2 (7203 x 7203) and Z, 415 MB in and 417 MB out, 0.25
// ms at 3.35 TB/s; a layer's B (49 x 1.06M), 415 MB in and 542 MB out (kp =
// 64), 0.29 ms.  Every element costs ~40 integer operations, so the split
// has to keep enough loads in flight and touch each byte once.
//
// Split design.  Each row (axis 1) or column (axis 0) is read from device
// memory once, in 16-byte loads where the address allows: rows of an odd k
// start 8 bytes past a 16-byte boundary on every other row, and there the
// row's first and last element are loaded alone.  A row or column is staged
// in shared memory, its max reduced there, and its digits formed from the
// staged values: F = floor(|x| 2^(s w - ex)) from x's exponent and
// significand fields (an integer shift), digit p = (F >> ((s-1-p) w)) & mask
// (row_scale, fixed_point, digits16), which is what the twin's words of
// 28 // w digits hold, with no floating point per digit.  Each thread forms
// 16 consecutive digits of a plane row and stores them as one 16-byte piece
// per plane.  Rows: L threads a row (up to the block), the row's pairs
// staged in a swizzled order so that each thread's 8 pairs fall on different
// banks.  Columns: a block stages a panel of 128 columns (1 KB row pieces)
// or 8 over a segment of k; where k is too long for one block, a cluster of
// up to 8 blocks (16 past that) takes the segments and the column maxima go
// round through distributed shared memory (Z and P at k = 7203: 8-column
// panels in clusters of 8; a two-pass split would read Z twice: 0.37 ms of
// bytes).  The launcher picks the plan (plan_cols); a row or column too
// long to stage is read twice, 16 columns a block.  s = 8, w = 7 is compiled in; other (s, w)
// take the instance that reads them at run time.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// parts of ozaki_gemm and ozaki_split left out for a timing breakdown, never
// in the library: chip_smoke.py --ablate builds copies with
// -DTPEPS_ABLATE=<bits>, 2 the wgmmas, 8 the recombination chains (one group
// sum converted instead), 16 the stores of C (kept only for a NaN, so the
// work before them stays); 32 the split's plane stores (kept for one
// pattern), 64 its digit pass (loads, maxima and exponents only)
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_S = 8;
constexpr int SNT = 256;        // threads of a split block
constexpr int SPLIT_MINB = 3;   // split blocks an SM its registers are held to
constexpr int SPLIT_UNROLL = 8; // 16-byte loads a split thread keeps in flight
constexpr int BK = 32;          // k bytes per plane row: the planes' alignment, a gemm stage, a wgmma
constexpr int TM = 64, TN = 64;    // the block tile: one wgmma m64n64 per pair
// two consumer warpgroups and a producer warpgroup: registers go by
// warpgroups, 65536 / 384 = 170 a thread at launch, and setmaxnreg moves
// them to the consumers (232 each) from the producer (40)
constexpr int GEMM_THREADS = 3 * 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_STAGES = 8;
// the handoff between the warpgroups, two buffers of a float64 sum and a
// float32 tail per element, from which both finish and store the tile; rows
// XP = 65 elements apart, which spreads the fragment writes over the banks
constexpr int XP = TN + 1;
constexpr int X_BYTES = 2 * TM * XP * (8 + 4);
constexpr int SMEM_LIMIT = 232448;
constexpr int RESIDENT_MAX = 64 * 1024;  // A's planes kept in shared memory up to this size

// max that propagates NaN (as jnp.max does)
__device__ __forceinline__ double nanmax(double a, double b) { return (a > b || a != a) ? a : b; }

// How a row's digits follow from its max |x| = mx, ex = floor(log2(mx)) + 1
// (1 where mx is 0), e = 2^ex, as _split_int8 forms them from R = x 2^-ex:
//   DIGITS    the usual case: the s w leading bits of |x| 2^-ex,
//             F = floor(|x| 2^(s w - ex)), read off x's bit fields as its
//             53-bit significand (hidden bit 0 for a subnormal) shifted by
//             exponent(x) - 52 - ex + s w; where R is subnormal, F is 0
//             either way, so the twin's rounding of R never shows
//   NONE      ex not finite (a NaN or an infinity in the row): R is NaN or
//             0 and every digit is 0
//   SATURATE  ex <= -1024 (the row's max below 2^-1024): 2^-ex is infinite,
//             R = +-inf for x != 0, whose truncation to int32 saturates:
//             every digit is the mask, times sign(x); NaN for x = 0: 0
enum : int { DIGITS = 0, NONE = 1, SATURATE = 2 };

struct RowScale {
  int mode;
  int base;  // DIGITS: s w - ex - 1075, so that F = sig << (E + base) for E >= 1
};

// ex of a row's max, as the twin forms it
__device__ __forceinline__ double row_exponent(double mx) {
  return floor(log2(mx == 0.0 ? 1.0 : mx)) + 1.0;
}

__device__ __forceinline__ RowScale row_scale(double ex, int sw) {
  RowScale r;
  r.mode = isfinite(ex) ? (ex <= -1024.0 ? SATURATE : DIGITS) : NONE;
  r.base = r.mode == DIGITS ? sw - static_cast<int>(ex) - 1075 : 0;
  return r;
}

__device__ __forceinline__ uint64_t fixed_point(double x, RowScale r) {
  const uint64_t mag = static_cast<uint64_t>(__double_as_longlong(x)) & 0x7fffffffffffffffull;
  if (r.mode != DIGITS) return r.mode == SATURATE && mag != 0 ? ~0ull : 0ull;
  const int E = static_cast<int>(mag >> 52);
  const uint64_t sig = (mag & 0x000fffffffffffffull) | (E ? 0x0010000000000000ull : 0ull);
  const int sh = (E ? E : 1) + r.base;
  return sh >= 0 ? sig << sh : (sh > -64 ? sig >> -sh : 0ull);
}

// the 4 x 4 byte transpose: w[p] byte j = a[j] byte p
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4], uint32_t& w0, uint32_t& w1,
                                           uint32_t& w2, uint32_t& w3) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140), t1 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t2 = __byte_perm(a[2], a[3], 0x5140), t3 = __byte_perm(a[2], a[3], 0x7362);
  w0 = __byte_perm(t0, t2, 0x5410);
  w1 = __byte_perm(t0, t2, 0x7632);
  w2 = __byte_perm(t1, t3, 0x5410);
  w3 = __byte_perm(t1, t3, 0x7632);
}

// four 7-bit digits of a 28-bit field, most significant in byte 0
__device__ __forceinline__ uint32_t spread7(uint32_t f) {
  return ((f >> 21) & 0x7fu) | ((f >> 6) & 0x7f00u) | ((f << 9) & 0x7f0000u) |
         ((f << 24) & 0x7f000000u);
}

// the digits of 16 consecutive elements of a row, plane p's 16 bytes in
// o[p]: digit p = (F >> ((s-1-p) w)) & mask, times sign(x).  S = 0: s and w
// at run time (the table-driven instance).  s = 8, w = 7: each element's
// digits 0-3 and 4-7 packed a byte each from F's two 28-bit halves, negated
// bytewise ((0x80 - d) ^ 0x80 is -d for d < 128), then four elements'
// words transposed into the planes' bytes
template <int S, int W>
__device__ __forceinline__ void digits16(const double (&v)[16], RowScale r, int s, int w,
                                         uint4 (&o)[MAX_S]) {
  uint32_t word[MAX_S][4];
  if constexpr (S == MAX_S && W == 7) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t F = fixed_point(v[4 * g + j], r);
        hi[j] = spread7(static_cast<uint32_t>(F >> 28));
        lo[j] = spread7(static_cast<uint32_t>(F));
        if (__double_as_longlong(v[4 * g + j]) < 0) {
          hi[j] = (0x80808080u - hi[j]) ^ 0x80808080u;
          lo[j] = (0x80808080u - lo[j]) ^ 0x80808080u;
        }
      }
      transpose4(hi, word[0][g], word[1][g], word[2][g], word[3][g]);
      transpose4(lo, word[4][g], word[5][g], word[6][g], word[7][g]);
    }
  } else {
    const uint32_t mask = (1u << w) - 1u;
#pragma unroll
    for (int p = 0; p < MAX_S; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) word[p][q] = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint64_t F = fixed_point(v[j], r);
      const bool neg = __double_as_longlong(v[j]) < 0;
#pragma unroll
      for (int p = 0; p < MAX_S; ++p) {
        if (p < s) {
          uint32_t d = static_cast<uint32_t>(F >> ((s - 1 - p) * w)) & mask;
          d = neg ? (0u - d) & 0xffu : d;
          word[p][j / 4] |= d << (8 * (j % 4));
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < MAX_S; ++p) o[p] = make_uint4(word[p][0], word[p][1], word[p][2], word[p][3]);
}

// plane p's 16 bytes at off of each of the s planes (plane bytes apart)
__device__ __forceinline__ void store16(int8_t* planes, int64_t plane, int64_t off, int s,
                                        const uint4 (&o)[MAX_S]) {
#pragma unroll
  for (int p = 0; p < MAX_S; ++p) {
    if (p < s) {
      uint4* dst = reinterpret_cast<uint4*>(planes + p * plane + off);
      if (!(TPEPS_ABLATE & 32) || (o[p].x == 0x5a5a5a5au && o[p].y == 0xa5a5a5a5u)) *dst = o[p];
    }
  }
}

// a row's or column's max over L lanes (a power of two; the whole block
// takes part, L > 32 through red, one slot a warp)
__device__ __forceinline__ double group_max(double mx, int L, double* red) {
  for (int o = (L < 32 ? L : 32) / 2; o > 0; o >>= 1)
    mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (L > 32) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
    __syncthreads();
    const int w0 = (threadIdx.x / L) * (L / 32);
    mx = red[w0];
    for (int i = 1; i < L / 32; ++i) mx = nanmax(mx, red[w0 + i]);
  }
  return mx;
}

// the staged row's pair q (elements 2q - h, 2q - h + 1) sits at slot
// q ^ ((q >> 3) & 7): the 8 pairs of a 16-element chunk that one thread reads
// land in 8 different 16-byte bank groups across neighbouring chunks
__device__ __forceinline__ int row_slot(int q) { return q ^ ((q >> 3) & 7); }

// rows of a row-major (m, k) matrix: L threads a row (a power of two, 4 to
// SNT), SNT / L rows a block.  STAGED: each row staged once in shared
// memory (pitch doubles: pairs of 16-byte loads, a scalar at a row's ends
// where it starts 8 bytes past a 16-byte boundary), its max reduced over the
// group, the digits formed from what is staged; else (a row too long to
// stage) read twice from device memory
template <int S, int W, bool STAGED>
__global__ void __launch_bounds__(SNT, SPLIT_MINB)
split_rows(const double* __restrict__ X, int8_t* __restrict__ planes, double* __restrict__ e,
           int64_t m, int k, int kp, int s, int w, int L, int pitch) {
  extern __shared__ double2 stage[];
  __shared__ double red[SNT / 32];
  const int g = threadIdx.x / L, lane = threadIdx.x % L;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (SNT / L) + g;
  const bool live = row < m;
  const double* x = X + (live ? row : 0) * k;
  const int h = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 3) & 1);
  double2* st = stage + static_cast<int64_t>(g) * (pitch / 2);
  double mx = 0.0;
  if (STAGED) {
    const int np = (kp + h + 1) / 2;  // pairs covering positions [0, kp + h)
    constexpr int U = SPLIT_UNROLL;
    for (int q0 = lane; q0 < np; q0 += U * L) {
      double2 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e0 = 2 * (q0 + u * L) - h;
        if (live && e0 >= 0 && e0 + 1 < k) {
          v[u] = __ldg(reinterpret_cast<const double2*>(x + e0));
        } else {
          v[u].x = live && e0 >= 0 && e0 < k ? __ldg(x + e0) : 0.0;
          v[u].y = live && e0 + 1 >= 0 && e0 + 1 < k ? __ldg(x + e0 + 1) : 0.0;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (q0 + u * L < np) {
          mx = nanmax(mx, nanmax(fabs(v[u].x), fabs(v[u].y)));
          st[row_slot(q0 + u * L)] = v[u];
        }
      }
    }
  } else if (live) {
    for (int c = lane; c < k; c += L) mx = nanmax(mx, fabs(__ldg(x + c)));
  }
  mx = group_max(mx, L, red);
  __syncthreads();  // the staged rows are complete
  const double ex = row_exponent(mx);
  const RowScale r = row_scale(ex, S ? S * W : s * w);
  if (live && lane == 0) e[row] = exp2(ex);
  if (!live || (TPEPS_ABLATE & 64)) return;
  const int64_t plane = m * kp;
  for (int c = lane; c < kp / 16; c += L) {
    double v[16];
    if (STAGED) {
      if (h == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const double2 d = st[row_slot(8 * c + i)];
          v[2 * i] = d.x;
          v[2 * i + 1] = d.y;
        }
      } else {
        double2 d = st[row_slot(8 * c)];
        v[0] = d.y;
#pragma unroll
        for (int i = 1; i < 8; ++i) {
          d = st[row_slot(8 * c + i)];
          v[2 * i - 1] = d.x;
          v[2 * i] = d.y;
        }
        v[15] = st[row_slot(8 * c + 8)].x;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = 16 * c + j < k ? __ldg(x + 16 * c + j) : 0.0;
    }
    uint4 o[MAX_S];
    digits16<S, W>(v, r, s, w, o);
    store16(planes, plane, row * kp + 16 * c, S ? S : s, o);
  }
}

// a staged column tile: row r (of the block's k segment), column c at
// r NC + (r >> 4) 8 + c.  The digit pass's warps read 8 columns x 4 pieces of
// 16 rows, rows 16 j + i: the 8 doubles a 16-row group is shifted by put the
// four pieces on the two halves of the banks
template <int NC>
__device__ __forceinline__ int col_pos(int r, int c) { return r * NC + (r >> 4) * 8 + c; }

struct ColPlan {
  int seg;  // rows of k a block takes (a multiple of 16); the cluster spans kp
  int cl;   // blocks of a cluster: ceil(kp / seg)
};

// columns of a row-major (k, n) matrix, planes (n, kp): a block a panel of NC
// columns and a segment of seg rows; the cl blocks of a cluster take a
// panel's segments, exchange the column maxima through distributed shared
// memory and write the digits of their own rows
template <int S, int W, int NC, bool STAGED>
__global__ void __launch_bounds__(SNT, SPLIT_MINB)
split_cols(const double* __restrict__ X, int8_t* __restrict__ planes, double* __restrict__ e,
           int k, int64_t n, int kp, int s, int w, ColPlan cp) {
  extern __shared__ double tile[];
  __shared__ double red[SNT];
  __shared__ double cmax[NC], cfin[NC];
  __shared__ RowScale csc[NC];
  constexpr int SLOTS = NC / 2 + 1;  // 16-byte loads of a row piece, one more where it starts 8 bytes in
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cp.cl > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x / cp.cl) * NC;
  const int nc = static_cast<int>(n - c0 < NC ? n - c0 : NC);
  const int k0 = rank * cp.seg;
  const int k1 = k0 + cp.seg < kp ? k0 + cp.seg : kp;
  const int kr = (k1 < k ? k1 : k) - k0;  // rows of X in the segment (<= 0: padding only)
  const double* xs = X + static_cast<int64_t>(k0) * n + c0;
  if (STAGED) {
    constexpr int U = SPLIT_UNROLL;
    for (int i0 = threadIdx.x; i0 < kr * SLOTS; i0 += U * SNT) {
      double2 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int it = i0 + u * SNT;
        const int rr = it / SLOTS, q = it - rr * SLOTS;
        const double* xr = xs + static_cast<int64_t>(rr) * n;
        const int h = static_cast<int>((reinterpret_cast<uintptr_t>(xr) >> 3) & 1);
        const int ca = 2 * q - h;
        v[u] = make_double2(0.0, 0.0);
        if (it < kr * SLOTS) {
          if (ca >= 0 && ca + 1 < nc) {
            v[u] = __ldg(reinterpret_cast<const double2*>(xr + ca));
          } else {
            if (ca >= 0 && ca < nc) v[u].x = __ldg(xr + ca);
            if (ca + 1 >= 0 && ca + 1 < nc) v[u].y = __ldg(xr + ca + 1);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int it = i0 + u * SNT;
        const int rr = it / SLOTS, q = it - rr * SLOTS;
        const double* xr = xs + static_cast<int64_t>(rr) * n;
        const int h = static_cast<int>((reinterpret_cast<uintptr_t>(xr) >> 3) & 1);
        const int ca = 2 * q - h;
        if (it < kr * SLOTS) {
          if (ca >= 0 && ca < nc) tile[col_pos<NC>(rr, ca)] = v[u].x;
          if (ca + 1 >= 0 && ca + 1 < nc) tile[col_pos<NC>(rr, ca + 1)] = v[u].y;
        }
      }
    }
    __syncthreads();
  }
  // the segment's column maxima: SNT / NC threads a column, then in order
  {
    constexpr int P = SNT / NC;
    const int c = threadIdx.x % NC, part = threadIdx.x / NC;
    double mx = 0.0;
    if (c < nc)
      for (int rr = part; rr < kr; rr += P)
        mx = nanmax(mx, fabs(STAGED ? tile[col_pos<NC>(rr, c)]
                                    : __ldg(xs + static_cast<int64_t>(rr) * n + c)));
    red[threadIdx.x] = mx;
    __syncthreads();
    if (threadIdx.x < NC) {
      for (int i = 1; i < P; ++i) mx = nanmax(mx, red[i * NC + threadIdx.x]);
      cmax[threadIdx.x] = mx;
    }
  }
  if (cp.cl > 1) {
    cluster.sync();  // every block's maxima are in place
    if (threadIdx.x < NC) {
      double mx = *cluster.map_shared_rank(cmax + threadIdx.x, 0);
      for (int b = 1; b < cp.cl; ++b) mx = nanmax(mx, *cluster.map_shared_rank(cmax + threadIdx.x, b));
      cfin[threadIdx.x] = mx;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");  // maxima read
  } else if (threadIdx.x < NC) {
    cfin[threadIdx.x] = cmax[threadIdx.x];
  }
  const int sw = S ? S * W : s * w;
  if (threadIdx.x < NC) {
    const double ex = row_exponent(cfin[threadIdx.x]);
    csc[threadIdx.x] = row_scale(ex, sw);
    if (rank == 0 && threadIdx.x < nc) e[c0 + threadIdx.x] = exp2(ex);
  }
  __syncthreads();
  // digits: a warp at a time 8 columns x 4 pieces of 16 rows
  const int J = (k1 - k0) / 16, jgs = (J + 3) / 4;
  const int64_t plane = n * kp;
  for (int t = threadIdx.x / 32; t < (NC / 8) * jgs && !(TPEPS_ABLATE & 64); t += SNT / 32) {
    const int c = (t % (NC / 8)) * 8 + threadIdx.x % 8;
    const int j = (t / (NC / 8)) * 4 + (threadIdx.x % 32) / 8;
    if (c >= nc || j >= J) continue;
    const RowScale r = csc[c];
    double v[16];
    if (STAGED) {
      const double* col = tile + col_pos<NC>(16 * j, c);  // rows 16 j + i at i NC
      if (16 * j + 16 <= kr) {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = col[i * NC];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = 16 * j + i < kr ? col[i * NC] : 0.0;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        v[i] = 16 * j + i < kr ? __ldg(xs + static_cast<int64_t>(16 * j + i) * n + c) : 0.0;
    }
    uint4 o[MAX_S];
    digits16<S, W>(v, r, s, w, o);
    store16(planes, plane, (c0 + c) * kp + k0 + 16 * j, S ? S : s, o);
  }
  // no block leaves while another may still read its maxima
  if (cp.cl > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}


// the recombination table of one (s, w), indexed by group g = t - 2
struct Recomb {
  int kind[MAX_S];          // 0 absent (t > s + 1), 1 float64 group, 2 first tail group, 3 tail group
  double scale[MAX_S];      // kind 1: 2^(-t w)
  float factor[MAX_S];      // kind 3: 2^((t - t_prev) w)
  double tail_scale;        // 2^(-t_last w) for the f32 tail, 0 when there is none
  int has_tail;
};

struct GemmParams {
  const double* ea;
  const double* eb;
  double* C;
  int64_t m, n;
  int kp;
  int resident;             // 1: A's planes (all m, at most two tiles) stay in shared memory
  int stages;
  int tiles_m, tiles_n;
  Recomb rc;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// waits for the phase of the given parity; a lost arrival traps (a launch
// error) after ~2^35 cycles instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 35)) __trap();
  }
}

// one box {BK, rows, s} of a (s, rows, kp) plane tensor into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k0, int row0,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(0), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 32-byte rows in the
// 32-byte swizzle that TMA wrote (layout type 3): 8-row groups 256 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64 int32, this thread's 32) += A (64 x 32 s8) B (64 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_acc(int (&acc)[4][32]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[g][i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a 2^-shift as float64, exact, by one add: 2^(52 - shift) + (a + 2^31)
// 2^-shift, less 2^(52 - shift) + 2^(31 - shift) (the conversion unit does
// 16 a clock per SM, the adder 64)
template <int SHIFT>
__device__ __forceinline__ double scaled_int(int a) {
  constexpr double magic = (4503599627370496.0 + 2147483648.0) / static_cast<double>(1LL << SHIFT);
  return __dsub_rn(__hiloint2double(0x43300000 - (SHIFT << 20), a ^ static_cast<int>(0x80000000u)),
                   magic);
}
__device__ __forceinline__ double int_to_double(int a) { return scaled_int<0>(a); }

// _accumulate's recombination steps for the groups g0 + 3 .. g0 of one
// element (g = t - 2, from the high totals down), on the running float64
// sum and float32 tail, as the table says
__device__ __forceinline__ void recombine_part(const Recomb& rc, int g0, const int (&acc)[4][32],
                                               int i, double& out, float& tail) {
#pragma unroll
  for (int g = 3; g >= 0; --g) {
    const int a = acc[g][i];
    const int kind = rc.kind[g0 + g];
    if (kind == 1) out = __dadd_rn(out, __dmul_rn(int_to_double(a), rc.scale[g0 + g]));
    else if (kind == 2) tail = __int2float_rn(a);
    else if (kind == 3) tail = __fadd_rn(__fmul_rn(tail, rc.factor[g0 + g]), __int2float_rn(a));
  }
}

// the pairs (p, q), p + q = g0 + g, of groups g0 .. g0 + 3 on one k slice
template <int G0>
__device__ __forceinline__ void mma_groups(int (&acc)[4][32], uint64_t da, uint64_t db,
                                           uint32_t a_plane, uint32_t b_plane) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int pa = 0; pa <= G0 + g; ++pa)
      wgmma_s8(acc[g], da + ((pa * a_plane) >> 4), db + (((G0 + g - pa) * b_plane) >> 4));
}

// One warpgroup's part of a block: the groups g0 .. g0 + 3 of every tile.
// HIGH (g0 = 4): totals 9..6, the 26 pairs whose recombination is the
// float32 tail; it hands the tail (and, off s = 8, w = 7, the float64 sum
// so far) to the other warpgroup through shared memory.  LOW (g0 = 0):
// totals 5..2, 10 pairs and the float64 sum; it finishes every element,
// stages the tile and stores it.  At s = 8, w = 7 (FAST) the recombination
// is compiled in: each scaling is by a power of two and exact, so the fused
// forms round once where _accumulate's multiply-then-add rounds once too.
template <bool FAST, bool HIGH>
__device__ __forceinline__ void consume(const GemmParams& p, unsigned char* ring,
                                        unsigned char* a_res, double* x_out, uint32_t full0,
                                        uint32_t empty0, uint32_t a_full) {
  constexpr int G0 = HIGH ? 4 : 0;
  const int nk = p.kp / BK;
  const int a_rows = p.resident ? TM * p.tiles_m : TM;
  const uint32_t a_plane = a_rows * BK, b_plane = TN * BK;  // bytes of one plane of a k slice
  const uint32_t a_slice = MAX_S * a_plane, b_slice = MAX_S * b_plane;
  const uint32_t stage_bytes = (p.resident ? 0 : a_slice) + b_slice;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, q4 = lane % 4;
  const Recomb rc = p.rc;  // in registers: read through a reference, every element reloads it
  if (p.resident) mbar_wait(a_full, 0);
  int acc[4][32];
  int tile_i = 0;  // this warpgroup's tiles so far: the handoff buffer alternates
  const int items = p.resident ? p.tiles_n : p.tiles_m * p.tiles_n;
  int64_t c0 = 0;  // this block's k slices so far: slot c % stages, phase (c / stages) & 1
  for (int item = blockIdx.x; item < items; item += gridDim.x, c0 += nk) {
    const int nt = p.resident ? item : item % p.tiles_n;
    const int mt_first = p.resident ? 0 : item / p.tiles_n;
    const int mt_last = p.resident ? p.tiles_m - 1 : mt_first;
    for (int mt = mt_first; mt <= mt_last; ++mt) {
      const bool release = mt == mt_last;  // else the slices stay for the next row tile
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[g][i] = 0;
      // the exponents of the rows and the column this thread stores, read
      // now so that their latency hides behind the wgmmas
      constexpr int FIN = (TM / 2) * TN / 128;  // elements a thread finishes
      double ea_v[FIN], eb_v;
      {
        const int64_t col = static_cast<int64_t>(nt) * TN + tid % TN;
        eb_v = col < p.n ? p.eb[col] : 0.0;
#pragma unroll
        for (int j = 0; j < FIN; ++j) {
          const int64_t row = static_cast<int64_t>(mt) * TM + (HIGH ? TM / 2 : 0) + 2 * j + tid / TN;
          ea_v[j] = row < p.m ? p.ea[row] : 0.0;
        }
      }
      for (int kk = 0; kk < nk; ++kk) {
        const int64_t c = c0 + kk;
        const int slot = static_cast<int>(c % p.stages);
        mbar_wait(full0 + 8 * slot, static_cast<uint32_t>((c / p.stages) & 1));
        unsigned char* st = ring + slot * stage_bytes;
        const uint32_t a_addr = p.resident ? smem_u32(a_res + kk * a_slice) + mt * TM * BK
                                           : smem_u32(st);
        const uint32_t b_addr = smem_u32(st + (p.resident ? 0 : a_slice));
        wgmma_fence();
        if (!(TPEPS_ABLATE & 2))
          mma_groups<G0>(acc, smem_desc(a_addr), smem_desc(b_addr), a_plane, b_plane);
        wgmma_commit();
        wgmma_wait<1>();
        if (release && kk > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((c - 1) % p.stages));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (release && lane == 0) mbar_arrive(empty0 + 8 * ((c0 + nk - 1) % p.stages));

      // register i holds row 16 warp + g8 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 q4 + i % 2
      // of the tile; the handoff holds each element at row * XP + column.  The
      // buffer was last read two tiles ago, before the previous barrier.
      const bool live = static_cast<int64_t>(mt) * TM + 16 * warp < p.m;  // else nothing to store
      double* xo = reinterpret_cast<double*>(reinterpret_cast<unsigned char*>(x_out) +
                                             (tile_i & 1) * (X_BYTES / 2));  // out (f64), then tail (f32)
      float* xt = reinterpret_cast<float*>(xo + TM * XP);
      auto at = [&](int i) { return (16 * warp + g8 + 8 * ((i / 2) % 2)) * XP + 8 * (i / 4) + 2 * q4 + i % 2; };
      if (FAST) {
        if (live)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            if (TPEPS_ABLATE & 8) {
              if (HIGH) xt[at(i)] = __int2float_rn(acc[0][i]);
              else xo[at(i)] = int_to_double(acc[0][i]);
            } else if (HIGH) {  // totals 9..6: the float32 tail
              float tail = __int2float_rn(acc[3][i]);
              tail = __fmaf_rn(tail, 0x1p-7f, __int2float_rn(acc[2][i]));
              tail = __fmaf_rn(tail, 0x1p-7f, __int2float_rn(acc[1][i]));
              xt[at(i)] = __fmaf_rn(tail, 0x1p-7f, __int2float_rn(acc[0][i]));
            } else {  // totals 5..2: the float64 sum (0 + a 2^-35 is a 2^-35, and +0 for 0)
              double out = scaled_int<35>(acc[3][i]);
              out = __dadd_rn(out, scaled_int<28>(acc[2][i]));
              out = __dadd_rn(out, scaled_int<21>(acc[1][i]));
              xo[at(i)] = __dadd_rn(out, scaled_int<14>(acc[0][i]));
            }
          }
        named_sync(4, 256);
      } else {  // the table's order: the high groups, then the low ones on their sums
        if (HIGH && live)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            double out = 0.0;
            float tail = 0.0f;
            recombine_part(rc, G0, acc, i, out, tail);
            xo[at(i)] = out;
            xt[at(i)] = tail;
          }
        named_sync(4, 256);
        if (!HIGH && live)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            double out = xo[at(i)];
            float tail = xt[at(i)];
            recombine_part(rc, G0, acc, i, out, tail);
            xo[at(i)] = out;
            xt[at(i)] = tail;
          }
        named_sync(5, 256);
      }
      // both warpgroups finish half the tile each, straight from the handoff:
      // out + tail 2^(-t w) (at s = 8, w = 7 the product is exact, so the fused
      // form rounds as _accumulate's multiply-then-add), times e_A e_B, stored
      // in 64-double row runs
      const double tail_scale = FAST ? 0x1p-42 : rc.tail_scale;
#pragma unroll
      for (int j = 0; j < FIN; ++j) {
        const int r = (HIGH ? TM / 2 : 0) + 2 * j + tid / TN, cc = tid % TN;
        const int64_t row = static_cast<int64_t>(mt) * TM + r, col = static_cast<int64_t>(nt) * TN + cc;
        if (row < p.m && col < p.n) {
          double out = xo[r * XP + cc];
          if (FAST || rc.has_tail) out = __fma_rn(static_cast<double>(xt[r * XP + cc]), tail_scale, out);
          out = __dmul_rn(__dmul_rn(out, ea_v[j]), eb_v);
          if (!(TPEPS_ABLATE & 16) || out != out) p.C[row * p.n + col] = out;
        }
      }
      ++tile_i;
    }
  }
}

// FAST: s = 8, w = 7 with the recombination compiled in; else the table's
template <bool FAST>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
ozaki_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const __grid_constant__ GemmParams p) {
  // the only shared memory of the kernel, so it starts on the swizzle's
  // 1024-byte boundary, and the compiler sees shared addresses throughout
  extern __shared__ __align__(1024) unsigned char smem[];
  const int nk = p.kp / BK;
  const int a_rows = p.resident ? TM * p.tiles_m : TM;
  const uint32_t a_slice = MAX_S * a_rows * BK, b_slice = MAX_S * TN * BK;
  const uint32_t stage_bytes = (p.resident ? 0 : a_slice) + b_slice;
  unsigned char* ring = smem;
  unsigned char* a_res = ring + p.stages * stage_bytes;  // resident A: nk slices
  double* x_out = reinterpret_cast<double*>(a_res + (p.resident ? nk * a_slice : 0));
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(x_out) + X_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + MAX_STAGES);
  const uint32_t a_full = smem_u32(bars + 2 * MAX_STAGES);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 2 * 4);  // one arrival per consumer warp
    }
    mbar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 2 * 4) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp != 2 * 4 || lane != 0) return;
    if (p.resident) {
      mbar_expect_tx(a_full, nk * a_slice);
      for (int kk = 0; kk < nk; ++kk) tma_load(smem_u32(a_res + kk * a_slice), &map_a, kk * BK, 0, a_full);
    }
    const int items = p.resident ? p.tiles_n : p.tiles_m * p.tiles_n;
    int64_t c = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int mt = p.resident ? 0 : item / p.tiles_n, nt = p.resident ? item : item % p.tiles_n;
      for (int kk = 0; kk < nk; ++kk, ++c) {
        const int slot = static_cast<int>(c % p.stages);
        mbar_wait(empty0 + 8 * slot, static_cast<uint32_t>(((c / p.stages) & 1) ^ 1));
        const uint32_t full = full0 + 8 * slot;
        unsigned char* st = ring + slot * stage_bytes;
        mbar_expect_tx(full, stage_bytes);
        if (!p.resident) tma_load(smem_u32(st), &map_a, kk * BK, mt * TM, full);
        tma_load(smem_u32(st + (p.resident ? 0 : a_slice)), &map_b, kk * BK, nt * TN, full);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  if (warp >= 4)
    consume<FAST, true>(p, ring, a_res, x_out, full0, empty0, a_full);
  else
    consume<FAST, false>(p, ring, a_res, x_out, full0, empty0, a_full);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point query (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (s, rows, kp) int8 plane tensor read in boxes {BK, box_rows, s}
bool plane_map(CUtensorMap* map, const int8_t* planes, int64_t rows, int kp, int s, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(s)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kp),
                                 static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(kp)};
  // MAX_S planes per box: those past s are out of bounds and come in as zeros
  const cuuint32_t box[3] = {BK, static_cast<cuuint32_t>(box_rows), MAX_S};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(planes), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the layout of ozaki_gemm_kernel's shared memory: the ring, resident A (all
// tiles_m row tiles), the handoff, the staged output tile, the mbarriers
int64_t gemm_smem_bytes(int resident, int stages, int kp, int tiles_m) {
  const int64_t a_slice = MAX_S * (resident ? TM * tiles_m : TM) * BK, b_slice = MAX_S * TN * BK;
  const int64_t ring = stages * ((resident ? 0 : a_slice) + b_slice);
  const int64_t a_res = resident ? (kp / BK) * a_slice : 0;
  return ring + a_res + X_BYTES + (2 * MAX_STAGES + 1) * 8;
}

// a row staged in shared memory up to this size (one block an SM); a
// column block's staging, so that three share an SM
constexpr int ROW_STAGE_MAX = 200 * 1024;
constexpr int COL_STAGE = 64 * 1024;

// a split instance's shared memory and non-portable cluster sizes (up to
// 16), raised once (outside any later stream capture)
template <typename K>
cudaError_t split_attrs(K kernel, bool& set) {
  if (set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         ROW_STAGE_MAX);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  set = err == cudaSuccess;
  return err;
}

template <int S, int W, bool STAGED>
cudaError_t launch_split_rows(const double* X, int8_t* planes, double* e, int64_t m, int k,
                              int kp, int s, int w, int L, int pitch, cudaStream_t st) {
  static bool set = false;
  cudaError_t err = split_attrs(split_rows<S, W, STAGED>, set);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (m + SNT / L - 1) / (SNT / L);
  split_rows<S, W, STAGED><<<static_cast<unsigned>(blocks), SNT, (SNT / L) * pitch * 8, st>>>(
      X, planes, e, m, k, kp, s, w, L, pitch);
  return cudaGetLastError();
}

template <int S, int W>
cudaError_t launch_split_rows(const double* X, int8_t* planes, double* e, int64_t m, int k,
                              int kp, int s, int w, cudaStream_t st) {
  // L threads a row, two 16-element chunks each where the row allows
  const int half = (kp / 16 + 1) / 2;
  int L = 4;
  while (L < half && L < SNT) L *= 2;
  int pitch = 16 * ((kp / 2 + 8) / 8);  // pairs of positions [0, kp + 1], in groups of 8
  if (static_cast<int64_t>(SNT / L) * pitch * 8 > ROW_STAGE_MAX)
    return launch_split_rows<S, W, false>(X, planes, e, m, k, kp, s, w, L, 0, st);
  return launch_split_rows<S, W, true>(X, planes, e, m, k, kp, s, w, L, pitch, st);
}

int col_stage_bytes(int rows, int nc) { return (rows * nc + (rows + 15) / 16 * 8) * 8; }

// 128-column panels (1 KB row pieces) where their segments fit COL_STAGE
// in a cluster of at most max_cl blocks and give every SM a block, else
// 8-column panels (the fewest blocks a cluster); else the plan with the most
// blocks; returns false where none fits
bool plan_cols(int k, int64_t n, int kp, int sms, int max_cl, int& nc_out, ColPlan& plan) {
  int64_t best = 0;
  constexpr int widths[2] = {128, 8};
  for (int nc : widths) {
    for (int cl = 1; cl <= max_cl; ++cl) {
      const int seg = ((kp + cl - 1) / cl + 15) / 16 * 16;
      const int rows = seg < k ? seg : k;
      if (col_stage_bytes(rows, nc) > COL_STAGE) continue;
      const int64_t blocks = (n + nc - 1) / nc * ((kp + seg - 1) / seg);
      if (blocks > best) {
        best = blocks;
        nc_out = nc;
        plan.seg = seg;
        plan.cl = (kp + seg - 1) / seg;
      }
      break;
    }
    if (best >= sms) return true;
  }
  return best > 0;
}

template <int S, int W, int NC, bool STAGED>
cudaError_t launch_split_cols(const double* X, int8_t* planes, double* e, int k, int64_t n,
                              int kp, int s, int w, ColPlan plan, cudaStream_t st) {
  static bool set = false;
  cudaError_t err = split_attrs(split_cols<S, W, NC, STAGED>, set);
  if (err != cudaSuccess) return err;
  const int rows = plan.seg < k ? plan.seg : k;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + NC - 1) / NC * plan.cl), 1, 1);
  cfg.blockDim = dim3(SNT, 1, 1);
  cfg.dynamicSmemBytes = STAGED ? col_stage_bytes(rows, NC) : 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, split_cols<S, W, NC, STAGED>, X, planes, e, k, n, kp, s, w,
                            plan);
}

template <int S, int W>
cudaError_t launch_split(const double* X, int8_t* planes, double* e, int64_t rows, int k, int kp,
                         int s, int w, int axis, cudaStream_t st) {
  if (axis == 1) return launch_split_rows<S, W>(X, planes, e, rows, k, kp, s, w, st);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // portable clusters first, then up to 16 blocks; else (k too long to
  // stage) a 16-column panel a block, read twice
  int nc = 16;
  ColPlan plan = {kp, 1};
  if (!plan_cols(k, rows, kp, sms, 8, nc, plan) &&
      !plan_cols(k, rows, kp, sms, 16, nc, plan))
    return launch_split_cols<S, W, 16, false>(X, planes, e, k, rows, kp, s, w, plan, st);
  return nc == 128 ? launch_split_cols<S, W, 128, true>(X, planes, e, k, rows, kp, s, w, plan, st)
                   : launch_split_cols<S, W, 8, true>(X, planes, e, k, rows, kp, s, w, plan, st);
}

}  // namespace

extern "C" {

int tpeps_ozaki_max_slices(void) { return MAX_S; }

// axis 1: X (rows, k) row-major, one exponent per row; axis 0: X (k, rows)
// row-major, one exponent per column.  planes: (s, rows, kp) int8, 16-byte
// aligned.  s = 8, w = 7 takes the instance with both compiled in.
int tpeps_ozaki_split(const double* X, int8_t* planes, double* e, int64_t rows, int k, int kp,
                      int s, int w, int axis, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (s < 1 || s > MAX_S || w < 1 || w > 7 || k < 1 || kp % BK != 0 || kp < k ||
      reinterpret_cast<uintptr_t>(X) % 8 != 0 || reinterpret_cast<uintptr_t>(planes) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s == MAX_S && w == 7 ? launch_split<MAX_S, 7>(X, planes, e, rows, k, kp, s, w, axis, st)
                              : launch_split<0, 0>(X, planes, e, rows, k, kp, s, w, axis, st);
}

// C (m, n) f64 row-major from A's planes (s, m, kp) and B's (s, n, kp),
// with the recombination table of tpeps_torch/kernels/ozaki.py:
// recombination_table: kind[8] per group g = t - 2, coef = scale[8],
// factor[8], tail_scale; at s = 8, w = 7 the kernel has the table compiled
// in, and this one must match it.  The launcher plans the grid: 64 x 64
// tiles; A's planes resident in shared memory where A has at most two row
// tiles and they fit RESIDENT_MAX (the layer products, whose B then streams
// from device memory once, each of its tiles used for every row tile); as
// many stages as fit, up to MAX_STAGES (resident, every k slice of an n tile
// at once); one persistent block per SM, at most one per work item.
int tpeps_ozaki_gemm(const int8_t* A, const double* ea, const int8_t* B, const double* eb,
                     double* C, int64_t m, int64_t n, int kp, int s, int w, const int* kind,
                     const double* coef, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  const int64_t tiles_m = (m + TM - 1) / TM, tiles_n = (n + TN - 1) / TN;
  if (kp <= 0 || kp % BK != 0 || s < 1 || s > MAX_S || w < 1 || w > 7 ||
      tiles_m * tiles_n > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16 != 0)
    return cudaErrorInvalidValue;
  const int nk = kp / BK;
  const int resident =
      tiles_m <= 2 && static_cast<int64_t>(nk) * MAX_S * TM * tiles_m * BK <= RESIDENT_MAX;
  const int64_t stage = (resident ? 0 : MAX_S * TM * BK) + MAX_S * TN * BK;
  const int64_t fit =
      (SMEM_LIMIT - gemm_smem_bytes(resident, 0, kp, static_cast<int>(tiles_m))) / stage;
  const int stages = static_cast<int>(fit < MAX_STAGES ? fit : MAX_STAGES);
  if (stages < (resident ? nk : 2)) return cudaErrorInvalidValue;  // no plan fits
  const int64_t smem = gemm_smem_bytes(resident, stages, kp, static_cast<int>(tiles_m));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  static bool attr_set = false;  // set once, outside any later stream capture
  if (!attr_set) {
    for (auto kernel : {ozaki_gemm_kernel<true>, ozaki_gemm_kernel<false>}) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_LIMIT);
      if (e != cudaSuccess) return e;
    }
    attr_set = true;
  }
  CUtensorMap map_a, map_b;
  if (!plane_map(&map_a, A, m, kp, s, static_cast<int>(resident ? TM * tiles_m : TM)) ||
      !plane_map(&map_b, B, n, kp, s, TN))
    return cudaErrorInvalidValue;
  GemmParams p;
  p.ea = ea;
  p.eb = eb;
  p.C = C;
  p.m = m;
  p.n = n;
  p.kp = kp;
  p.resident = resident;
  p.stages = stages;
  p.tiles_m = static_cast<int>(tiles_m);
  p.tiles_n = static_cast<int>(tiles_n);
  for (int g = 0; g < MAX_S; ++g) {
    p.rc.kind[g] = kind[g];
    p.rc.scale[g] = coef[g];
    p.rc.factor[g] = static_cast<float>(coef[MAX_S + g]);
  }
  p.rc.tail_scale = coef[2 * MAX_S];
  p.rc.has_tail = coef[2 * MAX_S] != 0.0;
  const int64_t items = resident ? tiles_n : tiles_m * tiles_n;
  const int blocks = static_cast<int>(sms < items ? sms : items);
  const bool fast = s == MAX_S && w == 7;
  if (fast) {  // the table must be the one compiled into the fast instance
    const int k8[MAX_S] = {1, 1, 1, 1, 3, 3, 3, 2};
    const double c8[2 * MAX_S + 1] = {0x1p-14, 0x1p-21, 0x1p-28, 0x1p-35, 0, 0, 0, 0,
                                      0, 0, 0, 0, 0x1p-7, 0x1p-7, 0x1p-7, 0, 0x1p-42};
    for (int g = 0; g < MAX_S; ++g)
      if (kind[g] != k8[g]) return cudaErrorInvalidValue;
    for (int g = 0; g < 2 * MAX_S + 1; ++g)
      if (coef[g] != c8[g]) return cudaErrorInvalidValue;
  }
  auto kernel = fast ? ozaki_gemm_kernel<true> : ozaki_gemm_kernel<false>;
  kernel<<<blocks, GEMM_THREADS, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, p);
  return cudaGetLastError();
}

}  // extern "C"
