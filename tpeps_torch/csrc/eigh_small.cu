// eigh_small: the symmetric eigendecomposition H = V diag(w) V^T of a small
// real matrix (k <= 170, V^T in one block's shared memory; the wrapper routes
// k <= 169, the factored move's largest chi on the card, where K6's polar
// kernel stops too) with nothing read to the host, for the Rayleigh-Ritz
// step of the factored C4v move (tpeps/ctm/c4v/move_tpu.py:147, eigh_desc
// of H = P^T M P, chi x chi).
//
// Why a kernel: cuSOLVER's syevd and syevj do not capture into a CUDA graph
// (measured on the H100: the capture is invalidated in every capture
// mode), and torch.linalg.eigh reads its info to the host, which stalls the
// stream of every move.  This keeps the decomposition on the card.
//
// What bounds it on an H100: a chain of dependent Jacobi rounds in one
// block: each round's subproblems are a latency chain of scalar rotations,
// its block updates read and write H once in shared memory (~0.5 MB a
// round at k = 147), so latency, instruction throughput and shared-memory
// bandwidth, not HBM or the tensor cores (the bound of the work, 4 k^3 on
// the FP64 tensor cores, is 0.2 us).  The Rayleigh-Ritz H of the move is
// near-diagonal (the move starts its subspace iteration from the previous
// eigenbasis), so few sweeps run.
//
// Design: a block Jacobi method on a cluster of two blocks.  The k indices
// are cut into blocks of NB = 8 (k = 147: 19 blocks and a dummy).  A sweep
// is a round-robin over block pairs, m - 1 rounds of m / 2 disjoint pairs
// (19 rounds at k = 147, against the 146 of a scalar Jacobi sweep).  Block 0
// keeps H and runs the rounds: (A) each pair's 16 x 16 diagonal subproblem
// is reduced by one pass of scalar Jacobi rotations (more passes did not
// save enough outer sweeps to pay for themselves) in XOR order (in
// inner round R index x pairs with x ^ R): a full cyclic sweep in the first
// round of a sweep, which reaches the pairs inside each block, and only the
// 64 pairs that cross the pair's two blocks (R = 8..15) in the others.  One
// half-warp takes a subproblem: lane l keeps column l of it and row l of
// its rotation J in registers, indexed relative to l (entry j is row or
// column l ^ j), so every register index is a constant of the unrolled
// code; the partner's column and the rotations pass through shared memory;
// a pair with |H_pq| <= 1e-18 ||H||_F is skipped and a rotated pair's
// entries are set exactly; the pair's diagonal blocks of H and its J (16 x
// 16) go to shared memory.
// (B) every block of H between two pairs a < b becomes J_a^T H[S_a, S_b]
// J_b: two m16n8k16 products each on the FP64 tensor cores (DMMA) by one
// warp, the intermediate parked in place.  Block 1 keeps V^T (k^2 f64 = 173
// KB at k = 147, too large for shared memory beside H) and applies each
// round's J as V^T[S_a, :] <- J_a^T V^T[S_a, :] on DMMA, reading J from
// block 0 through distributed shared memory while block 0 goes on to the
// next round (J double buffered, one cluster barrier a round), so the V
// update takes no instruction slot or shared-memory bandwidth of block 0.
// H is kept as its upper block triangle only (8 x 8 blocks, swizzled so
// that every fragment load is conflict-free, the diagonal blocks full and
// symmetric), so it stays exactly symmetric and the off-norm is read from
// it; it is scaled by a power of two (exactly) to max |H_ij| in [0.5, 1), so
// the rotations need no division and no guarded hypot.  Sweeps run until
// off(H) <= 1e-15 ||H||_F or max_sweeps; a decomposition that did not
// converge (or met a NaN) writes NaN to w and V^T.  Every sum has a fixed order and nothing is atomic, so two calls
// agree bit for bit; nothing is allocated and nothing read to the host,
// so it captures into a CUDA graph.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// parts left out for a timing breakdown, never in the library:
// chip_smoke.py --ablate builds copies with -DTPEPS_ABLATE=<bits>, 1 the
// subproblems (J = I), 2 the block updates of H, 4 the V updates, 8 a full
// sweep of every subproblem in every round, 64 every sweep run (no stopping
// test)
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif

namespace {

constexpr int NB = 8;                // block edge; a pair's subproblem is 2 NB = 16
constexpr int NT = 256;              // threads: 8 warps (up to 255 registers: no spill)
constexpr int NWARP = NT / 32;
constexpr int BLK = NB * NB;         // doubles of a stored block
constexpr int JSZ = 4 * BLK;         // doubles of a pair's J (16 x 16)
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block on sm_90
constexpr double OFF_TOL = 1e-15;    // stop at off(H) <= OFF_TOL ||H||_F
constexpr double SKIP_TOL = 1e-18;   // skip rotations with |H_pq| <= SKIP_TOL ||H||_F
constexpr unsigned FULL = 0xffffffffu;

struct Plan {
  int k, nb, odd, m, np;  // nb blocks, m = nb + odd players (odd: a dummy), np = m / 2 pairs
};

__host__ __device__ inline Plan plan_of(int k) {
  Plan p;
  p.k = k;
  p.nb = (k + NB - 1) / NB;
  p.odd = p.nb & 1;
  p.m = p.nb + p.odd;
  p.np = p.m / 2;
  return p;
}

__host__ __device__ inline int stored_blocks(const Plan& p) { return p.nb * (p.nb + 1) / 2; }
// the block pairs (a, b), a < b, of a round
__host__ __device__ inline int items_of(const Plan& p) { return p.np * (p.np - 1) / 2; }

// round-robin (circle) schedule over m players: player 0 stays, the others
// rotate; the blocks (x, y), x < y, of pair a in round r, x = -1 for the
// dummy (player 0 when nb is odd)
__device__ __forceinline__ int round_robin(int r, int pos, int m) {
  return pos == 0 ? 0 : 1 + (pos - 1 + r) % (m - 1);
}
__device__ __forceinline__ void pair_blocks(const Plan& p, int r, int a, int& x, int& y) {
  int u = round_robin(r, a, p.m), v = round_robin(r, p.m - 1 - a, p.m);
  if (u > v) {
    const int s = u;
    u = v;
    v = s;
  }
  x = u - p.odd;
  y = v - p.odd;
}

// block (x, y), x <= y, of the packed upper block triangle (row-major)
__device__ __forceinline__ int boff(const Plan& p, int x, int y) {
  return (x * (2 * p.nb - x + 1) / 2 + (y - x)) * BLK;
}
// entry (r, c) of an 8 x 8 block, its column swizzled by row bit 1
__device__ __forceinline__ int sw8(int r, int c) { return r * NB + (c ^ (((r >> 1) & 1) << 2)); }
// entry (r, c) of the symmetric H's block (bx, by), read from the upper triangle
__device__ __forceinline__ int hidx(const Plan& p, int bx, int by, int r, int c) {
  return bx <= by ? boff(p, bx, by) + sw8(r, c) : boff(p, by, bx) + sw8(c, r);
}
// entry (i, j) of a pair's 16 x 16 J, its column swizzled by row bits 0-1
__device__ __forceinline__ int jidx(int i, int j) { return i * 16 + (j ^ ((i & 3) << 2)); }

// c (16 x 8) += a (16 x 16) b (16 x 8) on the FP64 tensor cores; lane (g, t) =
// (lane / 4, lane % 4) holds a[i] = A(g + 8 (i % 2), t + 4 (i / 2)),
// b[i] = B(t + 4 i, g), c[i] = C(g + 8 (i / 2), 2 t + i % 2)
__device__ __forceinline__ void dmma16(double* c, const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ double block_max(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < NWARP; ++w) s = fmax(s, red[w]);
  return s;
}

__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < NWARP; ++w) s += red[w];
  return s;
}

// one inner round R of a 16 x 16 subproblem in XOR order (index x pairs
// with x ^ R), for half-warp lane l: A[j] = S(l ^ j, l), Jr[j] = J(l, l ^ j);
// every register index is a constant.  Both lanes of a pair (p, q) compute
// its rotation from the same operands (the lower lane's S(q, p), d = S_qq -
// S_pp, e = 2 S_pq), so they agree bit for bit.
// The partner's column and every lane's (c, signed sine) pass through the
// half-warp's scratch X (16 columns of 16, relative order, rows padded to 9
// double2 so that a quarter-warp's 16-byte accesses are conflict-free) and
// Pp (16).
template <int R>
__device__ __forceinline__ void inner_round(double (&A)[16], double (&Jr)[16], int l,
                                            double2* __restrict__ X, double2* __restrict__ Pp,
                                            double skip2) {
  constexpr int hb = R >= 8 ? 8 : R >= 4 ? 4 : R >= 2 ? 2 : 1;  // R's highest bit
  const bool lower = (l & hb) == 0;                              // l < l ^ R
#pragma unroll
  for (int u = 0; u < 8; ++u) X[9 * l + u] = make_double2(A[2 * u], A[2 * u + 1]);
  const double own = A[0];
  const double other = __shfl_xor_sync(FULL, own, R);
  const double apq_up = __shfl_xor_sync(FULL, A[R], R);
  const double apq = lower ? A[R] : apq_up;
  const double app = lower ? own : other, aqq = lower ? other : own;
  const double d = aqq - app;
  const double e = apq * apq > skip2 ? 2.0 * apq : 0.0;
  // c = (r + |d|) q, s = sign(d) e q, q = 1 / sqrt(2 r (r + |d|)), r =
  // sqrt(d^2 + e^2): Golub & Van Loan's inner rotation (c >= 1 / sqrt 2)
  // without a division (H is scaled to ||H||_F ~ 1, so d^2 + e^2 neither
  // overflows nor underflows where it matters)
  const double r = sqrt(d * d + e * e), ad = fabs(d) + r;
  const double q = rsqrt(2.0 * r * ad);
  const double c = e == 0.0 ? 1.0 : ad * q;
  const double sn = e == 0.0 ? 0.0 : (d >= 0.0 ? e : -e) * q;
  const double sg = lower ? -sn : sn;  // this column's signed sine
  // this index's new diagonal entry: c^2 app - 2 c s apq + s^2 aqq, or the
  // same with p and q swapped
  const double cs2 = 2.0 * c * sn * apq;
  const double dl = lower ? c * c * app - cs2 + sn * sn * aqq : sn * sn * app + cs2 + c * c * aqq;
  Pp[l] = make_double2(c, sg);
  __syncwarp();
  // columns: S(:, l) <- c S(:, l) + sg S(:, l ^ R); the partner keeps S(l ^ j,
  // l ^ R) at its relative index j ^ R
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const double2 v = X[9 * (l ^ R) + (u ^ (R >> 1))];
    const double p0 = (R & 1) ? v.y : v.x, p1 = (R & 1) ? v.x : v.y;
    A[2 * u] = c * A[2 * u] + sg * p0;
    A[2 * u + 1] = c * A[2 * u + 1] + sg * p1;
  }
  // rows l ^ j and l ^ j ^ R, and the same columns of J, with the rotation
  // of row l ^ j (its lane's c and signed sine)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j & hb) continue;
    const double2 q = j == 0 ? make_double2(c, sg) : Pp[l ^ j];
    const double y0 = A[j], y1 = A[j ^ R];
    A[j] = q.x * y0 + q.y * y1;
    A[j ^ R] = q.x * y1 - q.y * y0;
    const double z0 = Jr[j], z1 = Jr[j ^ R];
    Jr[j] = q.x * z0 + q.y * z1;
    Jr[j ^ R] = q.x * z1 - q.y * z0;
  }
  // the rotated pair's entries, exactly
  A[0] = sn != 0.0 ? dl : A[0];
  A[R] = sn != 0.0 ? 0.0 : A[R];
  __syncwarp();  // the scratch is read before the next round writes it
}

// inner rounds R0..15: a full cyclic sweep from R0 = 1, the 64 pairs that
// cross the pair's two blocks from R0 = 8
template <int R>
__device__ __forceinline__ void inner_rounds(double (&A)[16], double (&Jr)[16], int l,
                                             double2* X, double2* Pp, double skip2) {
  inner_round<R>(A, Jr, l, X, Pp, skip2);
  if constexpr (R < 15) inner_rounds<R + 1>(A, Jr, l, X, Pp, skip2);
}

// (A) the 16 x 16 subproblem H[S_a, S_a] of the pair (x, y) in J slot a (S_a:
// block x, then block y; x = -1 the dummy), by half-warp lane l (0-15) with
// its scratch X, Pp: one pass, a full cyclic sweep if full, else the
// crossing pairs only;
// writes J_a and the pair's three blocks of H.  An idle half-warp (a < 0) takes
// part in the shuffles only.
__device__ void inner_solve(const Plan& p, double* __restrict__ H, double* __restrict__ J, int x,
                            int y, int a, int l, double2* X, double2* Pp, bool full,
                            double skip2) {
  const int bl = l < NB ? x : y, ll = l % NB;
  double A[16], Jr[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int i = l ^ j, bi = i < NB ? x : y;
    A[j] = (bi >= 0 && bl >= 0) ? H[hidx(p, bi, bl, i % NB, ll)] : 0.0;
    Jr[j] = j == 0 ? 1.0 : 0.0;
  }
  if (full)
    inner_rounds<1>(A, Jr, l, X, Pp, skip2);
  else
    inner_rounds<8>(A, Jr, l, X, Pp, skip2);
  if (a < 0) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) J[a * JSZ + jidx(l, l ^ j)] = Jr[j];
  // each entry once, from the upper triangle; mirrored inside a diagonal block
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int i = l ^ j, bi = i < NB ? x : y;
    if (i > l || bi < 0 || bl < 0) continue;
    H[hidx(p, bi, bl, i % NB, ll)] = A[j];
    if (bi == bl) H[hidx(p, bl, bl, ll, i % NB)] = A[j];
  }
}

// the stored block behind block (u, v) of H: its offset (or -1 for the
// dummy) and whether it is stored transposed
__device__ __forceinline__ void quadrant(const Plan& p, int u, int v, int& base, bool& tr) {
  tr = u > v;
  base = (u < 0 || v < 0) ? -1 : tr ? boff(p, v, u) : boff(p, u, v);
}
// a lane's offsets in an 8 x 8 block, stored as is (n) or transposed (t):
// P[u] = (t + 4 u, g), Q[u] = (g, t + 4 u), S[j] = (g, 2 t + j); (r, c) at n,
// (c, r) at t
struct Frag {
  int pn[2], pt[2], sn[2], st[2];
};
__device__ __forceinline__ Frag frag_of(int lane) {
  const int g = lane >> 2, t = lane & 3;
  Frag f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    f.pn[u] = sw8(t + 4 * u, g);
    f.pt[u] = sw8(g, t + 4 * u);
    f.sn[u] = sw8(g, 2 * t + u);
    f.st[u] = sw8(2 * t + u, g);
  }
  return f;
}

// (B) one block pair (a, b), a < b, of a round: H[S_a, S_b] <- J_a^T H[S_a,
// S_b] J_b by one warp, T = J_a^T M parked in M's place, then Y = T J_b.
// M's quadrant q = 2 (row >= 8) + (col >= 8) is a stored block (or the
// dummy: reads 0, not written).  pr: the round's pairs (x, y)
__device__ void block_item(const Plan& p, double* __restrict__ H, const double* __restrict__ J,
                           const signed char* __restrict__ pr, int a, int b, const Frag& f,
                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int xa = pr[2 * a], ya = pr[2 * a + 1], xb = pr[2 * b], yb = pr[2 * b + 1];
  int qb[4];
  bool qt[4];
  quadrant(p, xa, xb, qb[0], qt[0]);
  quadrant(p, xa, yb, qb[1], qt[1]);
  quadrant(p, ya, xb, qb[2], qt[2]);
  quadrant(p, ya, yb, qb[3], qt[3]);
  auto at = [&](int q, int on, int ot) { return qb[q] < 0 ? -1 : qb[q] + (qt[q] ? ot : on); };
  const double* Ja = J + a * JSZ;
  const double* Jb = J + b * JSZ;
  double af[8], b0[4], b1[4], c0[4] = {0.0, 0.0, 0.0, 0.0}, c1[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int i = 0; i < 8; ++i) af[i] = Ja[jidx(t + 4 * (i / 2), g + 8 * (i % 2))];  // J_a^T
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // M(t + 4 i, g) and M(t + 4 i, 8 + g)
    const int e0 = at(2 * (i / 2), f.pn[i % 2], f.pt[i % 2]);
    const int e1 = at(2 * (i / 2) + 1, f.pn[i % 2], f.pt[i % 2]);
    b0[i] = e0 >= 0 ? H[e0] : 0.0;
    b1[i] = e1 >= 0 ? H[e1] : 0.0;
  }
  dmma16(c0, af, b0);
  dmma16(c1, af, b1);
  int eo[8];  // where this lane's outputs go: M(g + 8 (i / 2), 2 t + i % 2 (+ 8))
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    eo[i] = at(2 * (i / 2), f.sn[i % 2], f.st[i % 2]);
    eo[4 + i] = at(2 * (i / 2) + 1, f.sn[i % 2], f.st[i % 2]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (eo[i] >= 0) H[eo[i]] = c0[i];
    if (eo[4 + i] >= 0) H[eo[4 + i]] = c1[i];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // T(g + 8 (i % 2), t + 4 (i / 2))
    const int e = at(2 * (i % 2) + i / 4, f.pt[(i / 2) % 2], f.pn[(i / 2) % 2]);
    af[i] = e >= 0 ? H[e] : 0.0;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b0[i] = Jb[jidx(t + 4 * i, g)];
    b1[i] = Jb[jidx(t + 4 * i, g + 8)];
    c0[i] = 0.0;
    c1[i] = 0.0;
  }
  dmma16(c0, af, b0);
  dmma16(c1, af, b1);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (eo[i] >= 0) H[eo[i]] = c0[i];
    if (eo[4 + i] >= 0) H[eo[4 + i]] = c1[i];
  }
}

// V^T[S_a, :] <- J_a^T V^T[S_a, :] for the pairs pr of a round, V^T in
// shared memory (row pitch vp), J read from the other block of the cluster: a
// warp per (pair, 32 columns), four m16n8k16 products
__device__ void update_v(const Plan& p, double* __restrict__ Vs, int vp, const double* J,
                         const signed char* __restrict__ pr, int w0, int nw, int lane) {
  const int g = lane >> 2, t = lane & 3, k = p.k;
  const int groups = (k + 31) / 32;
  for (int it = w0; it < p.np * groups; it += nw) {
    const int a = it / groups, col0 = (it % groups) * 32;
    const int blk[2] = {pr[2 * a], pr[2 * a + 1]};
    const double* Ja = J + a * JSZ;
    double af[8], bf[4][4], acc[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) af[i] = Ja[jidx(t + 4 * (i / 2), g + 8 * (i % 2))];  // J_a^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows t + 4 i of S_a
      const int gi = blk[i / 2] * NB + t + 4 * (i % 2);
      const bool in = blk[i / 2] >= 0 && gi < k;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = col0 + 8 * n + g;
        bf[n][i] = (in && col < k) ? Vs[gi * vp + col] : 0.0;
        acc[n][i] = 0.0;
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) dmma16(acc[n], af, bf[n]);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of S_a
      const int gi = blk[h] * NB + g;
      if (blk[h] < 0 || gi >= k) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + 8 * n + 2 * t + j;
          if (col < k) Vs[gi * vp + col] = acc[n][2 * h + j];
        }
    }
  }
}

// byte offsets in dynamic shared memory.  Block 0: H's upper block
// triangle, J's two buffers, the subproblems' scratch, the reduction
// scratch, the round descriptors block 1 reads (two slots of round, J
// buffer, converged), the coordinates of each stored block, the pairs of
// every round, the items (a, b).  Block 1: V^T (row pitch vp, 4 mod 16 where
// it fits), its pairs.
struct Layout {
  int j, xs, red, ctl, bxy, ptab, itab, bytes0;
  int vp, ptab1, bytes1;
};

__host__ __device__ inline Layout layout_of(const Plan& p) {
  Layout L;
  const int nst = stored_blocks(p), npt = 2 * (p.m - 1) * p.np, ni = items_of(p);
  L.j = nst * BLK * 8;
  L.xs = L.j + 2 * p.np * JSZ * 8;  // per half-warp: X 16 x 9 double2, Pp 16
  L.red = L.xs + 2 * ((p.np + 1) / 2) * 160 * 16;
  L.ctl = L.red + NWARP * 8;
  L.bxy = L.ctl + 6 * 4;
  L.ptab = L.bxy + 2 * nst;
  L.itab = L.ptab + npt;
  L.bytes0 = L.itab + 2 * ni;
  L.vp = (p.k + 11) / 16 * 16 + 4;
  if (static_cast<size_t>(p.k) * L.vp * 8 + npt > SMEM_LIMIT) L.vp = p.k;
  L.ptab1 = p.k * L.vp * 8;
  L.bytes1 = L.ptab1 + npt;
  return L;
}

size_t jacobi_smem(int k) {
  const Layout L = layout_of(plan_of(k));
  return static_cast<size_t>(L.bytes0 > L.bytes1 ? L.bytes0 : L.bytes1);
}

__device__ void fill_pairs(const Plan& p, signed char* ptab) {
  for (int e = threadIdx.x; e < (p.m - 1) * p.np; e += NT) {
    int x, y;
    pair_blocks(p, e / p.np, e % p.np, x, y);
    ptab[2 * e] = static_cast<signed char>(x);
    ptab[2 * e + 1] = static_cast<signed char>(y);
  }
}

// A cluster of two blocks: block 0 keeps H and runs the rounds, block 1
// keeps V^T and applies each round's J, read from block 0 through
// distributed shared memory, while block 0 goes on (one cluster barrier a
// round; J and the round descriptor are double buffered).  state: [0]
// sweeps, [1] converged
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT, 1)
block_jacobi(const double* __restrict__ Hg, double* __restrict__ w, double* __restrict__ Vt,
             int* __restrict__ state, int k, int max_sweeps) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p = plan_of(k);
  const Layout L = layout_of(p);
  const int nst = stored_blocks(p);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int* ctl = reinterpret_cast<int*>(smem + L.ctl);  // [2][3]

  if (cluster.block_rank() == 1) {
    double* Vs = reinterpret_cast<double*>(smem);
    signed char* ptab = reinterpret_cast<signed char*>(smem + L.ptab1);
    const double* Jr = cluster.map_shared_rank(reinterpret_cast<double*>(smem + L.j), 0);
    const int* ctl0 = cluster.map_shared_rank(ctl, 0);
    fill_pairs(p, ptab);
    for (int r = warp; r < k; r += NWARP)
      for (int c = lane; c < k; c += 32) Vs[r * L.vp + c] = r == c ? 1.0 : 0.0;
    cluster.sync();  // block 0 has started; both are set up
    int conv = 0;
    for (int nbar = 0;; ++nbar) {
      cluster.sync();  // block 0 has written the round's J (or stopped)
      const int r = ctl0[3 * (nbar & 1)], b = ctl0[3 * (nbar & 1) + 1];
      conv = ctl0[3 * (nbar & 1) + 2];
      if (r < 0) break;
      if (!(TPEPS_ABLATE & 4))
        update_v(p, Vs, L.vp, Jr + b * p.np * JSZ, ptab + 2 * r * p.np, warp, NWARP, lane);
    }
    cluster.sync();  // block 0 may exit: its shared memory is no longer read
    for (int r = warp; r < k; r += NWARP)
      for (int c = lane; c < k; c += 32)
        Vt[static_cast<int64_t>(r) * k + c] = conv ? Vs[r * L.vp + c] : NAN;
    return;
  }

  double* H = reinterpret_cast<double*>(smem);
  double* Jbuf = reinterpret_cast<double*>(smem + L.j);  // [2][np][JSZ]
  double* red = reinterpret_cast<double*>(smem + L.red);
  unsigned char* bxy = smem + L.bxy;  // [nst][2]
  signed char* ptab = reinterpret_cast<signed char*>(smem + L.ptab);  // [m - 1][np][2]
  unsigned char* itab = smem + L.itab;                                // [items][2]
  for (int x = tid; x < p.nb; x += NT)
    for (int y = x; y < p.nb; ++y) {
      const int b = boff(p, x, y) / BLK;
      bxy[2 * b] = static_cast<unsigned char>(x);
      bxy[2 * b + 1] = static_cast<unsigned char>(y);
    }
  fill_pairs(p, ptab);
  for (int a = tid; a < p.np; a += NT)  // the items (a, b), a < b, in row-major order
    for (int b = a + 1; b < p.np; ++b) {
      const int it = a * p.np - a * (a + 1) / 2 + (b - a - 1);
      itab[2 * it] = static_cast<unsigned char>(a);
      itab[2 * it + 1] = static_cast<unsigned char>(b);
    }
  const int nit = items_of(p);
  __syncthreads();
  // H into the upper block triangle, zero-padded, scaled by 2^-ex (exactly)
  // so that max |H_ij| is in [0.5, 1); ||H||_F^2
  double amax = 0.0;
  for (int e = tid; e < nst * BLK; e += NT) {
    const int b = e / BLK, x = bxy[2 * b], y = bxy[2 * b + 1];
    const int r = (e % BLK) / NB, c = (e % NB) ^ (((r >> 1) & 1) << 2);
    const int i = x * NB + r, j = y * NB + c;
    const double h = (i < k && j < k) ? Hg[i * k + j] : 0.0;
    H[e] = h;
    amax = fmax(amax, fabs(h));
  }
  amax = block_max(amax, red);
  int ex = 0;
  if (amax > 0.0 && isfinite(amax)) frexp(amax, &ex);
  double part = 0.0;
  for (int e = tid; e < nst * BLK; e += NT) {
    const double h = ldexp(H[e], -ex);
    H[e] = h;
    part += (bxy[2 * (e / BLK)] == bxy[2 * (e / BLK) + 1] ? 1.0 : 2.0) * h * h;
  }
  const double norm2 = block_sum(part, red);  // block_sum syncs before reading H
  const double skip2 = SKIP_TOL * SKIP_TOL * norm2;
  const double stop = OFF_TOL * OFF_TOL * norm2;
  const int ni = (p.np + 1) / 2;  // warps solving subproblems, two per warp
  const Frag f = frag_of(lane);
  cluster.sync();
  int sweep = 0, converged = 0, buf = 0, nbar = 0;
  for (; sweep < max_sweeps; ++sweep) {
    part = 0.0;
    for (int e = tid; e < nst * BLK; e += NT) {
      const int b = e / BLK, r = (e % BLK) / NB, c = (e % NB) ^ (((r >> 1) & 1) << 2);
      const double h = H[e];
      part += (bxy[2 * b] != bxy[2 * b + 1] ? 2.0 : (r != c ? 1.0 : 0.0)) * h * h;
    }
    const double off = block_sum(part, red);
    if (off <= stop) converged = 1;
    if (!(TPEPS_ABLATE & 64) && !(off > stop)) break;  // also stops on NaN
    for (int r = 0; r < p.m - 1; ++r) {
      double* J = Jbuf + buf * p.np * JSZ;
      const signed char* pr = ptab + 2 * r * p.np;
      if (warp < ni) {
        const int a = 2 * warp + lane / 16, l = lane % 16;
        const bool on = a < p.np;
        if (!(TPEPS_ABLATE & 1)) {
          double2* X = reinterpret_cast<double2*>(smem + L.xs) + (2 * warp + lane / 16) * 160;
          inner_solve(p, H, J, on ? pr[2 * a] : -1, on ? pr[2 * a + 1] : -1, on ? a : -1, l, X,
                      X + 144, r == 0 || (TPEPS_ABLATE & 8), skip2);
        } else if (on) {
#pragma unroll
          for (int j = 0; j < 16; ++j) J[a * JSZ + jidx(l, l ^ j)] = j == 0 ? 1.0 : 0.0;
        }
      }
      if (tid == 0) {
        ctl[3 * (nbar & 1)] = r;
        ctl[3 * (nbar & 1) + 1] = buf;
      }
      cluster.sync();  // J is complete, here and for block 1
      ++nbar;
      if (!(TPEPS_ABLATE & 2))
        for (int it = warp; it < nit; it += NWARP)
          block_item(p, H, J, pr, itab[2 * it], itab[2 * it + 1], f, lane);
      __syncthreads();
      buf ^= 1;
    }
  }
  if (tid == 0) {
    ctl[3 * (nbar & 1)] = -1;
    ctl[3 * (nbar & 1) + 2] = converged;
  }
  cluster.sync();  // block 1 stops
  for (int i = tid; i < k; i += NT)
    w[i] = converged ? ldexp(H[boff(p, i / NB, i / NB) + sw8(i % NB, i % NB)], ex) : NAN;
  if (tid == 0) {
    state[0] = sweep;
    state[1] = converged;
  }
  cluster.sync();  // block 1 has read the descriptors
}

// the kernel's shared memory limit, raised once (outside any later stream
// capture)
cudaError_t jacobi_attr() {
  static bool set = false;
  if (set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      block_jacobi, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_LIMIT));
  set = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

// H (k x k, symmetric, row-major) -> unordered eigenvalues w and V^T (rows
// are the eigenvectors); state: [0] sweeps, [1] converged
int tpeps_eigh_small_f64(const double* H, double* w, double* Vt, int* state, int k,
                         int max_sweeps, void* stream) {
  if (k <= 0) return cudaSuccess;
  const size_t smem = jacobi_smem(k);
  if (smem > SMEM_LIMIT || max_sweeps < 1) return cudaErrorInvalidValue;
  const cudaError_t e = jacobi_attr();
  if (e != cudaSuccess) return e;
  block_jacobi<<<2, NT, smem, static_cast<cudaStream_t>(stream)>>>(H, w, Vt, state, k,
                                                                   max_sweeps);
  return cudaGetLastError();
}

}  // extern "C"
