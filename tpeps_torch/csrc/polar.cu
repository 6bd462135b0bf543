// K6: unitary polar factor of a small square real matrix O (k x k,
// row-major), the function tpeps/linalg/power.py:polar_unitary (:32-57)
// computes, and the vector-Jacobian product of its closed-form derivative
// (_polar_unitary_stable_jvp, :124-130):
//   polar_unitary: W = O (O^T O)^-1/2, the exact polar factor, or W = I when
//                  the overlap is ill-conditioned, W is not finite or the
//                  method did not converge;
//   polar_vjp:     O_bar = W skew(W^T W_bar), skew(A) = (A - A^T) / 2.
// procrustes_align (:60-99) calls it once per CTMRG move on the
// chi x chi overlap O = P^T P_ref (chi = 147 at the slice); the VJP runs once
// per move VJP of the implicit adjoint.
//
// What bounds it on an H100.  The work is tiny (a k^3 product is 6.4 MFLOP
// at k = 147, 0.1 us on the FP64 tensor cores) and the method is a chain of
// dependent steps, so it is bound by the latency of a step: its products on
// a few SMs, the exchange of the iterate between them, and one barrier.  At
// k = 147 a step takes ~11 us, of it ~4 us of products (the 10 SMs' DMMAs
// near their peak) and ~4 us of exchange (loads from other blocks' shared
// memory, bound by their latency; pushing the panels with the bulk-copy
// engine instead took ~11 us).
//
// polar_unitary design: the Newton-Schulz iteration Y <- Y (3 I - Y^T Y) / 2
// from Y = c O, c = lam^-1/2 with lam = min(||H||_1, ||H||_F, 1 + ||H - I||_F)
// >= ||H||_2 (H = O^T O), so every singular value of Y lies in (0, 1]: it
// converges to the polar factor of O (the scale does not change it), the
// singular values below ~0.5 growing by 1.5 a step, then quadratically.
// The loop stops after the step whose ||Y^T Y - I||_F was <= 1e-8: that step
// leaves every singular value within ~1e-16 of 1.  An overlap at the JAX
// guard's edge (w_min = 1e-20 w_max, sigma_min = 1e-10 sigma_max) needs at
// most 66 steps (c sigma_max >= k^-1/4); the wrapper caps the loop at 70, and
// a loop that did not converge by then, or met a non-finite value, writes
// W = I.  So the condition guard is the convergence within the cap:
// exactly singular directions never grow, a ridged one (sigma = 1e-12
// sigma_max, procrustes_align's ridge) needs at least 74 steps; both give I
// as the eigh-based guard does.  Above the guard every eigenvalue of H is
// kept (1e-24 < 1e-20), so the function is the polar factor itself.  Its
// error is ~eps cond(O) (the eigh of O^T O loses eps cond(O)^2).
//
// One launch, a cluster of nb = ceil(k / 16) blocks (<= 12: k <= 192), nb
// warps each.  Block b keeps the 16-column panel Y[:, C_b] in shared memory
// (rows padded with zeros to kp = 16 nb; columns c and c + 8 side by side,
// so a lane's two fragment values are one 16-byte access, swizzled by row
// so that every access is conflict-free).  A step in block b: (G) warp w
// forms G[C_w, C_b] = Y_w^T Y_b (16 x 16, depth kp) on the FP64 tensor
// cores (mma.sync m16n8k4), Y_w read from block w through distributed
// shared memory (8 k-steps of loads in flight) and kept in a local copy as
// it goes (every copy that fits: all at k <= 160); (S) S[:, C_b] = 3/2 I -
// 1/2 G[:, C_b] into the other buffer of the panel; (Y) warp w forms
// Y'[R_w, C_b]^T = S[:, C_b]^T Y[R_w, :]^T on DMMA from the local copies; Y'
// replaces S; one cluster barrier.  Before it each block pushes its share
// of ||G - I||_F^2 and the finiteness of its panel of Y' into every block's
// shared memory, and after it every block sums the shares in rank order, so
// all take the same decision.  Step 0 forms G = H from O and, across one
// more barrier, lam and c.  Every sum has a fixed order and nothing is
// atomic, so two calls agree bit for bit; nothing is allocated and nothing
// read to the host, so it captures into a CUDA graph.
// Double precision only: the wrapper computes a float32 overlap's factor in
// float64.
//
// polar_vjp design: one launch of nb x nb blocks (a cluster of nb per column
// panel b), 8 warps each.  Block (w, b) stages W[:, C_w], W_bar[:, C_w],
// W[:, C_b], W_bar[:, C_b] and W[R_w, :] with cp.async (110 KB at k = 147 in
// float64: two blocks an SM, so the 100 blocks run in one wave), forms the
// tile S[C_w, C_b] = (W_w^T W_bar_b - W_bar_w^T W_b) / 2 (A = W^T W_bar is
// never formed twice: the second term is A[C_b, C_w]^T), gathers the panel
// S[:, C_b] from its cluster and forms O_bar[R_w, C_b] = W[R_w, :] S[:, C_b]
// on DMMA (the k-steps split among four pairs of warps, summed in a fixed
// order); float32 operands are multiplied in float64 and rounded once.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// parts left out for a timing breakdown, never in the library:
// chip_smoke.py --ablate builds copies with -DTPEPS_ABLATE=<bits>, 1 the
// exchange (every panel read from the block's own), 2 the products (the
// DMMAs), 4 the cluster barrier of a step (and the exchange), 8 the
// stopping test (every step up to the cap runs; 1 and 4 imply it); of
// polar_vjp 16 the staging of its operands, 32 the gather of S
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif
// batches of four k-steps of remote loads in flight in a step's first product
// (a copy with 3 spills registers and is slower)
#ifndef TPEPS_POLAR_DEPTH
#define TPEPS_POLAR_DEPTH 2
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int PW = 16;                 // columns of a panel, rows of a tile
constexpr int MAX_NB = 12;             // blocks of a cluster
constexpr int MAX_K = PW * MAX_NB;     // 192
constexpr int STATS = 128;             // bins of the step histogram
constexpr int MAX_STEPS = STATS - 2;   // the largest cap the histogram holds
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block on sm_90
constexpr double STOP2 = 1e-16;        // stop after the step with ||Y^T Y - I||_F^2 <= STOP2
constexpr double NEAR2 = 0.81;         // info[4]: ||O^T O - I||_F^2 below this
constexpr int DEPTH = TPEPS_POLAR_DEPTH;
constexpr int VNT = 256;               // threads of a VJP block
constexpr unsigned FULL = 0xffffffffu;
constexpr bool kAllSteps = (TPEPS_ABLATE & 13) != 0;
constexpr bool kNoExchange = (TPEPS_ABLATE & 5) != 0;

// entry (r, c) of a panel (rows of PW): columns c and c + 8 side by side, so
// a lane's two fragment values are one 16-byte pair, the pairs of a row
// swizzled by row bits 0-1, so the pair accesses below (row 4 s + t, pair g;
// or row 16 w + 8 n + g, pair 4 u + t) are conflict-free
__device__ __forceinline__ int pos(int r, int c) {
  return r * PW + 2 * ((c & 7) ^ (((r & 1) << 2) | (r & 2))) + (c >> 3);
}
template <typename T>
struct PairOf {
  using type = double2;
};
template <>
struct PairOf<float> {
  using type = float2;
};
// the pair (P[r][c], P[r][c + 8]), c < 8, of a panel P
template <typename T>
__device__ __forceinline__ typename PairOf<T>::type pair(const T* P, int r, int c) {
  return *reinterpret_cast<const typename PairOf<T>::type*>(P + pos(r, c));
}

// c (16 x 8) += a (16 x 4) b (4 x 8) on the FP64 tensor cores; lane (g, t) =
// (lane / 4, lane % 4) holds a0 = A(g, t), a1 = A(g + 8, t), b = B(t, g),
// c[2h + e] = C(g + 8h, 2t + e)
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b) {
  if (TPEPS_ABLATE & 2) {
    asm volatile("" ::"d"(a0), "d"(a1), "d"(b));
    return;
  }
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// the values v[0, n) of every block of the cluster (in rank order) summed, or
// their minimum: each block pushed its own into slot rank of every block
__device__ __forceinline__ double cluster_reduce(const double* mine, int n, int stride, bool min_) {
  const int lane = threadIdx.x & 31;
  const double v = lane < n ? mine[lane * stride] : 0.0;
  double s = min_ ? 1.0 : 0.0;
  for (int x = 0; x < n; ++x) {
    const double y = __shfl_sync(FULL, v, x);
    s = min_ ? fmin(s, y) : s + y;
  }
  return s;
}

struct PolarArgs {
  const double* O;
  double* W;
  int* info;   // 5 ints, or null
  int* stats;  // STATS ints (a histogram accumulated over calls), or null
  int k, nb, nslot, max_steps;
};

// the shared memory of the polar kernel: two buffers of the block's panel,
// nslot local copies of other panels, the per-warp scratch and what the
// cluster pushes (3 init values and 2 x 2 step values per block)
__host__ __device__ inline int polar_panel(int nb) { return PW * PW * nb; }
constexpr int SCRATCH = MAX_NB * PW + 3 * MAX_NB + 7 * MAX_NB;
__host__ inline size_t polar_bytes(int nb, int nslot) {
  return (static_cast<size_t>(2 + nslot) * polar_panel(nb) + SCRATCH) * sizeof(double);
}
__host__ inline int polar_slots(int nb) {
  const size_t fixed = polar_bytes(nb, 0), panel = polar_panel(nb) * sizeof(double);
  const int fit = static_cast<int>((SMEM_LIMIT - fixed) / panel);
  return fit < nb - 1 ? fit : nb - 1;
}

__global__ void __launch_bounds__(32 * MAX_NB, 1) polar_kernel(PolarArgs p) {
  extern __shared__ __align__(16) double sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int nb = p.nb, k = p.k, ps = polar_panel(nb);
  double* X0 = sm;
  double* X1 = sm + ps;
  double* stg = sm + 2 * ps;          // nslot copies of panels b + 1, b + 2, ...
  double* wcol = stg + p.nslot * ps;  // [nb][PW] column sums of |H| per warp
  double* wsum = wcol + MAX_NB * PW;  // [3][MAX_NB] per-warp partials
  double* rinit = wsum + 3 * MAX_NB;  // [nb][3] pushed by each block
  double* rstep = rinit + 3 * MAX_NB; // [2][nb][2] pushed by each block, by step parity
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;

  for (int e = tid; e < ps; e += blockDim.x) {
    const int r = e / PW, c = e % PW, col = b * PW + c;
    const bool in = r < k && col < k;
    cp_async(X0 + pos(r, c), p.O + (in ? static_cast<int64_t>(r) * k + col : 0), in);
  }
  cp_async_wait();
  cluster.sync();  // every panel of Y_0 = O is in place

  double alpha = 1.0, beta = 1.0;  // step 0: S = c (3/2 I - 1/2 c^2 H)
  int j = 0, conv = 0, fin = 0, near = 0;
  for (;;) {
    double* cur = (j & 1) ? X1 : X0;
    double* nxt = (j & 1) ? X0 : X1;
    // (G) G[C_w, C_b] = Y_w^T Y_b, Y_w read from block w (DEPTH batches of
    // four k-steps in flight) and copied into a slot; two accumulator
    // chains per n-tile (even and odd batches)
    const int q = (w - b - 1 + nb) % nb;
    const double* Yw = (w == b || kNoExchange) ? cur : cluster.map_shared_rank(cur, w);
    double* slot = (w != b && q < p.nslot) ? stg + q * ps : nullptr;
    double cn[2][2][4] = {};
    {
      double2 ra[DEPTH][4];
      auto load = [&](double2 (&x)[4], int i) {
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = pair(Yw, 16 * i + 4 * u + t, g);
      };
#pragma unroll
      for (int d = 0; d < DEPTH; ++d)
        if (d < nb) load(ra[d], d);
      for (int i0 = 0; i0 < nb; i0 += DEPTH) {
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          const int i = i0 + d;
          if (i < nb) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = 16 * i + 4 * u + t;
              const double2 a = ra[d][u], bb = pair(cur, r, g);
              if (slot != nullptr) *reinterpret_cast<double2*>(slot + pos(r, g)) = a;
              dmma(cn[d & 1][0], a.x, a.y, bb.x);
              dmma(cn[d & 1][1], a.x, a.y, bb.y);
            }
            if (i + DEPTH < nb) load(ra[d], i + DEPTH);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cn[0][n][e] += cn[1][n][e];
    if (j == 0) {
      // lam from the cluster's shares of ||H||_F^2, ||H - I||_F^2 and the
      // largest column sum of |H|
      double fro = 0.0, dev = 0.0, col[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int R = PW * w + g + 8 * h, C = PW * b + 8 * n + 2 * t + e;
            const double v = cn[0][n][2 * h + e], d = v - ((R == C && R < k) ? 1.0 : 0.0);
            fro += v * v;
            dev += d * d;
            col[n][e] += fabs(v);
          }
      fro = warp_sum(fro);
      dev = warp_sum(dev);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          double v = col[n][e];
          for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(FULL, v, o);
          if (g == 0) wcol[w * PW + 8 * n + 2 * t + e] = v;
        }
      if (lane == 0) {
        wsum[w] = fro;
        wsum[MAX_NB + w] = dev;
      }
      __syncthreads();
      if (tid < nb) {  // push this block's three values to block tid
        double f = 0.0, d = 0.0, m = 0.0;
        for (int x = 0; x < nb; ++x) {
          f += wsum[x];
          d += wsum[MAX_NB + x];
        }
        for (int c = 0; c < PW; ++c) {
          double s = 0.0;
          for (int x = 0; x < nb; ++x) s += wcol[x * PW + c];
          m = fmax(m, s);
        }
        double* dst = cluster.map_shared_rank(rinit, tid) + 3 * b;
        dst[0] = f;
        dst[1] = d;
        dst[2] = m;
      }
      cluster.sync();
      const double fro2 = cluster_reduce(rinit, nb, 3, false);
      const double dev2 = cluster_reduce(rinit + 1, nb, 3, false);
      double n1 = 0.0;
      for (int x = 0; x < nb; ++x) n1 = fmax(n1, rinit[3 * x + 2]);
      near = dev2 < NEAR2 ? 1 : 0;
      const double lam = fmin(n1, fmin(sqrt(fro2), 1.0 + sqrt(dev2)));
      alpha = 1.0 / sqrt(lam);
      beta = alpha * alpha;
    }
    // (S) S[R_w, C_b] = alpha (3/2 I - 1/2 beta G) into nxt; this warp's
    // share of ||beta G - I||_F^2
    double d2 = 0.0;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int R = PW * w + g + 8 * h, c = 8 * n + 2 * t + e;
          const double dg = (R == PW * b + c && R < k) ? 1.0 : 0.0;
          const double v = beta * cn[0][n][2 * h + e];
          d2 += (v - dg) * (v - dg);
          nxt[pos(R, c)] = alpha * (1.5 * dg - 0.5 * v);
        }
    d2 = warp_sum(d2);
    if (lane == 0) wsum[2 * MAX_NB + w] = d2;
    __syncthreads();  // S and the copied panels are complete
    double* rs = rstep + 2 * MAX_NB * (j & 1);
    if (tid < nb) {  // push this block's share of ||G - I||_F^2 to block tid
      double sum = 0.0;
      for (int x = 0; x < nb; ++x) sum += wsum[2 * MAX_NB + x];
      cluster.map_shared_rank(rs, tid)[2 * b] = sum;
    }
    // (Y) Y'[R_w, C_b]^T = sum over panels a of S[C_a, C_b]^T Y_a[R_w, :]^T,
    // two batches (panels) in flight, two accumulator chains per n-tile
    double yn[2][2][4] = {};  // [chain: u][n-tile]
    {
      auto load = [&](double2 (&x)[8], int a) {
        const int qa = (a - b - 1 + nb) % nb;
        const double* src = a == b ? cur
                            : qa < p.nslot ? stg + qa * ps
                            : kNoExchange ? cur
                                                 : cluster.map_shared_rank(cur, a);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          x[4 * u] = pair(nxt, PW * a + 4 * u + t, g);
          x[4 * u + 1] = pair(nxt, PW * a + 4 * u + t + 8, g);
          x[4 * u + 2] = pair(src, PW * w + g, 4 * u + t);
          x[4 * u + 3] = pair(src, PW * w + 8 + g, 4 * u + t);
        }
      };
      auto use = [&](const double2 (&x)[8]) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            dmma(yn[u][n], x[4 * u].x, x[4 * u].y, x[4 * u + 2 + n].x);
            dmma(yn[u][n], x[4 * u + 1].x, x[4 * u + 1].y, x[4 * u + 2 + n].y);
          }
      };
      double2 x0[8], x1[8];
      load(x0, 0);
      for (int a = 0; a < nb; a += 2) {
        if (a + 1 < nb) load(x1, a + 1);
        use(x0);
        if (a + 2 < nb) load(x0, a + 2);
        if (a + 1 < nb) use(x1);
      }
    }
    int f = 1;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        yn[0][n][e] += yn[1][n][e];
        f &= isfinite(yn[0][n][e]);
      }
    f = __syncthreads_and(f);  // and every warp has read S
    if (tid < nb) cluster.map_shared_rank(rs, tid)[2 * b + 1] = f ? 1.0 : 0.0;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<double2*>(nxt + pos(PW * w + 8 * n + 2 * t + e, g)) =
            make_double2(yn[0][n][e], yn[0][n][2 + e]);
    if (TPEPS_ABLATE & 4)
      __syncthreads();
    else
      cluster.sync();  // Y' and the pushed values are in place, every read of Y is done
    // the cluster's decision on ||Y_j^T Y_j - I||_F^2 and Y_{j+1}'s finiteness
    const double dd = cluster_reduce(rs, nb, 2, false);
    const double ff = cluster_reduce(rs + 1, nb, 2, true);
    ++j;
    alpha = beta = 1.0;
    conv = dd <= STOP2 ? 1 : 0;
    fin = ff == 1.0 ? 1 : 0;
    if (!kAllSteps && !(dd <= 1e300)) break;  // a NaN or an overflow: not converged
    if (conv && !kAllSteps) break;
    if (j >= p.max_steps) break;
  }

  // W = Y (the panel's newest buffer), or I unless converged and finite
  const double* res = (j & 1) ? X1 : X0;
  const bool ok = conv && fin;
  for (int e = tid; e < ps; e += blockDim.x) {
    const int r = e / PW, c = e % PW, col = b * PW + c;
    if (r < k && col < k)
      p.W[static_cast<int64_t>(r) * k + col] = ok ? res[pos(r, c)] : (r == col ? 1.0 : 0.0);
  }
  if (b == 0 && tid == 0) {
    if (p.info != nullptr) {
      p.info[0] = j;
      p.info[1] = conv;
      p.info[2] = ok ? 1 : 0;
      p.info[3] = fin;
      p.info[4] = near;
    }
    if (p.stats != nullptr) atomicAdd(p.stats + (conv ? j : STATS - 1), 1);
  }
  // the last step's barrier ended every access to another block's shared
  // memory; without it (an ablation copy) one more barrier does
  if (TPEPS_ABLATE & 4) cluster.sync();
}

// the VJP's shared memory: the panels (elements of T) W[R_w, :]^T, W[:, C_w],
// W_bar[:, C_w], W[:, C_b], W_bar[:, C_b], then (doubles) the tile S[C_w,
// C_b]; S[:, C_b] and, between uses, the four partial tiles (doubles) take
// the place of the panels from the second on (110 KB at k = 147 and 112 KB at
// k = 169 in float64: two blocks an SM)
template <typename T>
__host__ __device__ inline size_t vjp_tile_offset(int nb) {
  const size_t panel = static_cast<size_t>(polar_panel(nb)) * sizeof(T);
  const size_t parts = panel + 4 * PW * PW * sizeof(double);
  return 5 * panel > parts ? 5 * panel : parts;
}
template <typename T>
__host__ __device__ inline size_t vjp_bytes(int nb) {
  return vjp_tile_offset<T>(nb) + PW * PW * sizeof(double);
}

// the 16 x 16 tile op(A1)^T B1 (- A2^T B2 when A2 is given) over the panels'
// kp rows, on DMMA in float64: warp v takes n-tile v % 2 and the k-steps s =
// v / 2 mod 4, two accumulator chains each; once every warp is done with the
// panels, the four partial tiles go to part
template <typename T>
__device__ __forceinline__ void tile_product(const T* A1, const T* B1, const T* A2, const T* B2,
                                             int kp, double* part) {
  const int lane = threadIdx.x & 31, v = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int n = v & 1, ns = kp / 4;
  double c[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
  auto step = [&](double (&acc)[4], int s) {
    const int r = 4 * s + t;
    const auto a = pair(A1, r, g);
    const auto bb = pair(B1, r, g);
    dmma(acc, a.x, a.y, n ? bb.y : bb.x);
    if (A2 != nullptr) {
      const auto a2 = pair(A2, r, g);
      const auto b2 = pair(B2, r, g);
      dmma(acc, -static_cast<double>(a2.x), -static_cast<double>(a2.y), n ? b2.y : b2.x);
    }
  };
  for (int s = v >> 1; s < ns; s += 8) {
    step(c[0], s);
    if (s + 4 < ns) step(c[1], s + 4);
  }
  __syncthreads();  // part takes the panels' place
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      part[(v >> 1) * PW * PW + (g + 8 * h) * PW + 8 * n + 2 * t + e] =
          c[0][2 * h + e] + c[1][2 * h + e];
}

template <typename T>
__global__ void __launch_bounds__(VNT) polar_vjp_kernel(const T* __restrict__ W,
                                                        const T* __restrict__ G,
                                                        T* __restrict__ Ob, int k, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int w = static_cast<int>(cluster.block_rank()), b = blockIdx.y;
  const int kp = PW * nb, ps = polar_panel(nb);
  T* Wr = sm;  // Wr[pos(m, i)] = W[16 w + i][m]
  T* Wc = Wr + ps;
  T* Gc = Wc + ps;
  T* Wb = Gc + ps;
  T* Gb = Wb + ps;
  T* Sp = Wc;  // S[:, C_b], once the first product is done
  double* part = reinterpret_cast<double*>(Wc);
  double* tile = reinterpret_cast<double*>(smem_raw + vjp_tile_offset<T>(nb));
  const int tid = threadIdx.x;
  if (!(TPEPS_ABLATE & 16)) {
    // the column panels: a thread per (row mod 16, column)
    const int c = tid % PW, cw = PW * w + c, cb = PW * b + c;
    for (int r = tid / PW; r < kp; r += VNT / PW) {
      const bool inw = r < k && cw < k, inb = r < k && cb < k;
      const int64_t ow = inw ? static_cast<int64_t>(r) * k + cw : 0;
      const int64_t ob = inb ? static_cast<int64_t>(r) * k + cb : 0;
      cp_async(Wc + pos(r, c), W + ow, inw);
      cp_async(Gc + pos(r, c), G + ow, inw);
      cp_async(Wb + pos(r, c), W + ob, inb);
      cp_async(Gb + pos(r, c), G + ob, inb);
    }
    // W's row panel, read along its rows
    for (int m = tid; m < kp; m += VNT)
      for (int i = 0; i < PW; ++i) {
        const int row = PW * w + i;
        const bool in = row < k && m < k;
        cp_async(Wr + pos(m, i), W + (in ? static_cast<int64_t>(row) * k + m : 0), in);
      }
  }
  cp_async_wait();
  __syncthreads();
  // S[C_w, C_b] = (W_w^T G_b - G_w^T W_b) / 2
  tile_product<T>(Wc, Gb, Gc, Wb, kp, part);
  __syncthreads();
  for (int e = tid; e < PW * PW; e += VNT)
    tile[e] = 0.5 * (part[e] + part[PW * PW + e] + part[2 * PW * PW + e] + part[3 * PW * PW + e]);
  cluster.sync();
  // the panel S[:, C_b] from the cluster's tiles: every load, then every store
  constexpr int MAXU = PW * MAX_K / VNT;
  double v[MAXU];
#pragma unroll
  for (int u = 0; u < MAXU; ++u) {
    const int e = tid + u * VNT;
    if (e < ps)
      v[u] = (TPEPS_ABLATE & 32) ? tile[e % (PW * PW)]
                                 : cluster.map_shared_rank(tile, e / (PW * PW))[e % (PW * PW)];
  }
#pragma unroll
  for (int u = 0; u < MAXU; ++u) {
    const int e = tid + u * VNT;
    if (e < ps) Sp[pos(e / PW, e % PW)] = static_cast<T>(v[u]);
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");  // tile read
  __syncthreads();
  // O_bar[R_w, C_b] = W[R_w, :] S[:, C_b] (its partials replace S)
  tile_product<T>(Wr, Sp, static_cast<const T*>(nullptr), static_cast<const T*>(nullptr), kp,
                  part);
  __syncthreads();
  for (int e = tid; e < PW * PW; e += VNT) {
    const int row = PW * w + e / PW, col = PW * b + e % PW;
    if (row < k && col < k)
      Ob[static_cast<int64_t>(row) * k + col] = static_cast<T>(
          part[e] + part[PW * PW + e] + part[2 * PW * PW + e] + part[3 * PW * PW + e]);
  }
  // no block leaves while another may still read its tile
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

cudaLaunchAttribute cluster_attr(int n) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// a kernel's shared memory and non-portable cluster sizes, raised once per
// instance (outside any later stream capture)
template <typename K>
cudaError_t raise_attrs(K kernel, bool& set) {
  if (set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_LIMIT));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  set = e == cudaSuccess;
  return e;
}

int launch_polar(const double* O, double* W, int* info, int* stats, int k, int max_steps,
                 cudaStream_t stream) {
  if (k <= 0) return cudaSuccess;
  if (k > MAX_K || max_steps < 1 || max_steps > MAX_STEPS) return cudaErrorInvalidValue;
  static bool set = false;
  const cudaError_t e = raise_attrs(polar_kernel, set);
  if (e != cudaSuccess) return e;
  PolarArgs p;
  p.O = O;
  p.W = W;
  p.info = info;
  p.stats = stats;
  p.k = k;
  p.nb = (k + PW - 1) / PW;
  p.nslot = polar_slots(p.nb);
  p.max_steps = max_steps;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nb, 1, 1);
  cfg.blockDim = dim3(32 * p.nb, 1, 1);
  cfg.dynamicSmemBytes = polar_bytes(p.nb, p.nslot);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_attr(p.nb)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, polar_kernel, p);
}

template <typename T>
int launch_polar_vjp(const T* W, const T* G, T* Ob, int k, cudaStream_t stream) {
  if (k <= 0) return cudaSuccess;
  if (k > MAX_K) return cudaErrorInvalidValue;
  static bool set = false;
  const cudaError_t e = raise_attrs(polar_vjp_kernel<T>, set);
  if (e != cudaSuccess) return e;
  const int nb = (k + PW - 1) / PW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, nb, 1);
  cfg.blockDim = dim3(VNT, 1, 1);
  cfg.dynamicSmemBytes = vjp_bytes<T>(nb);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {cluster_attr(nb)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, polar_vjp_kernel<T>, W, G, Ob, k, nb);
}

}  // namespace

extern "C" {

int tpeps_polar_max_k() { return MAX_K; }
int tpeps_polar_max_steps() { return MAX_STEPS; }
int tpeps_polar_stats_len() { return STATS; }

// W = the guarded polar factor of O (k x k); info (5 ints, or null): the
// steps run, converged, W kept (converged and finite), W finite,
// ||O^T O - I||_F < 0.9; stats (STATS ints, or null): the call adds one to
// bin `steps` when it converged, to bin STATS - 1 when it did not
int tpeps_polar_unitary_f64(const double* O, double* W, int* info, int* stats, int k,
                            int max_steps, void* stream) {
  return launch_polar(O, W, info, stats, k, max_steps, static_cast<cudaStream_t>(stream));
}

int tpeps_polar_vjp_f64(const double* W, const double* G, double* Ob, int k, void* stream) {
  return launch_polar_vjp<double>(W, G, Ob, k, static_cast<cudaStream_t>(stream));
}

int tpeps_polar_vjp_f32(const float* W, const float* G, float* Ob, int k, void* stream) {
  return launch_polar_vjp<float>(W, G, Ob, k, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
