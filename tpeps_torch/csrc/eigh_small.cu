// eigh_small: the symmetric eigendecomposition H = V diag(w) V^T of a small
// real matrix (k <= 169: H in shared memory; the factored move's largest chi
// on the card, where K6's polar kernel stops too) with nothing read to the
// host, for the Rayleigh-Ritz step of the factored C4v move
// (tpeps/ctm/c4v/move_tpu.py:147, eigh_desc of H = P^T M P, chi x chi).
//
// Why a kernel: cuSOLVER's syevd and syevj do not capture into a CUDA graph
// (measured on the H100: the capture is invalidated in every capture
// mode), and torch.linalg.eigh reads its info to the host, which stalls the
// stream of every move.  This keeps the decomposition on the card.
//
// What bounds it on an H100: a chain of dependent Jacobi rounds in one
// block; each round reads and writes H once in shared memory.  Latency, not
// bandwidth or arithmetic.  The Rayleigh-Ritz H of the move is near-diagonal
// (the move starts its subspace iteration from the previous eigenbasis), so
// few sweeps run.
//
// Design: the cyclic two-sided Jacobi method of csrc/polar.cu in round-robin
// order (k-1 rounds of k/2 disjoint pairs per sweep), recast so that a round
// touches each element of H once: (1) a thread per pair computes its
// rotation J = [[c, s], [-s, c]] (Golub & Van Loan, sym.schur2); a pair
// whose |H_pq| <= 1e-18 ||H||_F is skipped (all of them together stay below
// the stopping threshold); (2) every 2x2 block H[S_a, S_b] of two pairs,
// a < b, becomes J_a^T H[S_a, S_b] J_b, written to H[S_b, S_a] transposed
// as well (H stays exactly symmetric; each element is read once and written
// once), the diagonal blocks their exact values.
// Sweeps run until off(H) <= 1e-15 ||H||_F or max_sweeps.  V is not touched
// inside the rounds: each round's rotations are written to global memory,
// and a second launch applies them to V^T, one block per column (the
// columns of V^T rotate independently), staging the rotations of 16 rounds
// at a time in shared memory.  A decomposition that did not converge (or
// met a NaN) writes NaN to w and V^T.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;             // threads of the Jacobi block
constexpr int NWARP = NT / 32;
constexpr int VNT = 128;             // threads of a V block (>= k/2 pairs)
constexpr int CHUNK = 16;            // rounds of rotations staged per V step
constexpr int MAX_K = 2 * VNT;       // the V launch takes k <= 2 VNT
constexpr int B_SLOTS = 3;           // pairs per lane in a round: k <= 192
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block on sm_90: k <= 169
constexpr double OFF_TOL = 1e-15;    // stop at off(H) <= OFF_TOL ||H||_F
constexpr double SKIP_TOL = 1e-18;   // skip rotations with |H_pq| <= SKIP_TOL ||H||_F

// round-robin (circle) schedule over m players: player 0 stays, the others
// rotate; the pair at position pr of round r, ordered p < q (q >= k: the
// dummy of an odd k)
__device__ __forceinline__ int round_robin(int r, int pos, int m) {
  return pos == 0 ? 0 : 1 + (pos - 1 + r) % (m - 1);
}
__device__ __forceinline__ void pair_of(int r, int pr, int m, int& p, int& q) {
  p = round_robin(r, pr, m);
  q = round_robin(r, m - 1 - pr, m);
  if (p > q) {
    const int x = p;
    p = q;
    q = x;
  }
}

__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < NWARP; ++w) s += red[w];
  return s;
}

size_t jacobi_smem(int k) {
  const int np = (k + (k & 1)) / 2;
  return (static_cast<size_t>(k) * k + 4 * np + NWARP) * sizeof(double) + 2 * np * sizeof(int);
}

// rot: (max_sweeps * (m - 1) * np) rotations (c, s); state: [0] sweeps,
// [1] converged
__global__ void __launch_bounds__(NT)
jacobi_rounds(const double* __restrict__ Hg, double* __restrict__ w, double2* __restrict__ rot,
              int* __restrict__ state, int k, int max_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = k + (k & 1);
  const int np = m / 2;
  const int kk = k * k;
  double* H = reinterpret_cast<double*>(smem);
  double* pc = H + kk;    // np: cos of each pair's rotation
  double* ps = pc + np;   // np: sin
  double* dp = ps + np;   // np: new H[p][p]
  double* dq = dp + np;   // np: new H[q][q]
  double* red = dq + np;  // NWARP: reduction scratch
  int* pp = reinterpret_cast<int*>(red + NWARP);  // np: p of each pair
  int* pq = pp + np;                              // np: q of each pair
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  double part = 0.0;
  for (int e = tid; e < kk; e += NT) {
    const double h = Hg[e];
    H[e] = h;
    part += h * h;
  }
  const double norm2 = block_sum(part, red);  // block_sum syncs before reading H
  const double skip2 = SKIP_TOL * SKIP_TOL * norm2;
  int sweep = 0, converged = 0;
  for (; sweep < max_sweeps; ++sweep) {
    part = 0.0;
    for (int e = tid; e < kk; e += NT)
      if (e / k != e % k) part += H[e] * H[e];
    const double off = block_sum(part, red);
    const double stop = OFF_TOL * OFF_TOL * norm2;
    if (off <= stop) converged = 1;
    if (!(off > stop)) break;  // also stops on NaN
    for (int r = 0; r < m - 1; ++r) {
      for (int pr = tid; pr < np; pr += NT) {
        int p, q;
        pair_of(r, pr, m, p, q);
        double c = 1.0, s = 0.0, hp = 0.0, hq = 0.0;
        if (q < k) {
          const double hpq = H[p * k + q];
          hp = H[p * k + p];
          hq = H[q * k + q];
          if (hpq * hpq > skip2) {
            const double tau = (hq - hp) / (2.0 * hpq);
            const double t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
            c = 1.0 / sqrt(1.0 + t * t);
            s = t * c;
            hp -= t * hpq;
            hq += t * hpq;
          }
        }
        pp[pr] = p;
        pq[pr] = q;
        pc[pr] = c;
        ps[pr] = s;
        dp[pr] = hp;
        dq[pr] = hq;
        rot[(static_cast<int64_t>(sweep) * (m - 1) + r) * np + pr] = make_double2(c, s);
      }
      __syncthreads();
      // H[S_a, S_b] <- J_a^T H[S_a, S_b] J_b for a < b, and its transpose into
      // H[S_b, S_a]; a warp takes rows a = warp + 32 i, its lanes the
      // columns b = lane + 32 t; an index >= k (the dummy) is absent, and a
      // block between two skipped pairs is unchanged
      {
        int bp[B_SLOTS], bq[B_SLOTS];
        double bc[B_SLOTS], bs[B_SLOTS];
#pragma unroll
        for (int t = 0; t < B_SLOTS; ++t) {
          const int b = lane + 32 * t;
          bp[t] = b < np ? pp[b] : 0;
          bq[t] = b < np ? pq[b] : k;
          bc[t] = b < np ? pc[b] : 1.0;
          bs[t] = b < np ? ps[b] : 0.0;
        }
        for (int a = warp; a < np; a += NWARP) {
          const int pa = pp[a], qa = pq[a];
          const double ca = pc[a], sa = ps[a];
          const bool a_id = ca == 1.0 && sa == 0.0, qa_in = qa < k;
#pragma unroll
          for (int t = 0; t < B_SLOTS; ++t) {
            const int b = lane + 32 * t;
            if (b >= np || b < a) continue;
            const bool b_id = bc[t] == 1.0 && bs[t] == 0.0;
            if (b == a) {
              if (a_id) continue;  // skipped pair: unchanged
              H[pa * k + pa] = dp[a];
              H[qa * k + qa] = dq[a];
              H[pa * k + qa] = 0.0;
              H[qa * k + pa] = 0.0;
              continue;
            }
            if (a_id && b_id) continue;
            const int pb = bp[t], qb = bq[t];
            const double cb = bc[t], sb = bs[t];
            const bool qb_in = qb < k;
            const double x_pp = H[pa * k + pb];
            const double x_pq = qb_in ? H[pa * k + qb] : 0.0;
            const double x_qp = qa_in ? H[qa * k + pb] : 0.0;
            const double x_qq = qa_in && qb_in ? H[qa * k + qb] : 0.0;
            // rows: J_a^T, then columns: J_b
            const double l_pp = ca * x_pp - sa * x_qp, l_pq = ca * x_pq - sa * x_qq;
            const double l_qp = sa * x_pp + ca * x_qp, l_qq = sa * x_pq + ca * x_qq;
            const double y_pp = cb * l_pp - sb * l_pq, y_pq = sb * l_pp + cb * l_pq;
            const double y_qp = cb * l_qp - sb * l_qq, y_qq = sb * l_qp + cb * l_qq;
            H[pa * k + pb] = y_pp;
            H[pb * k + pa] = y_pp;
            if (qb_in) {
              H[pa * k + qb] = y_pq;
              H[qb * k + pa] = y_pq;
            }
            if (qa_in) {
              H[qa * k + pb] = y_qp;
              H[pb * k + qa] = y_qp;
            }
            if (qa_in && qb_in) {
              H[qa * k + qb] = y_qq;
              H[qb * k + qa] = y_qq;
            }
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += NT) w[i] = converged ? H[i * k + i] : NAN;
  if (tid == 0) {
    state[0] = sweep;
    state[1] = converged;
  }
}

// column j of V^T (= row j of V... the j-th components of every eigenvector)
// from e_j through every recorded round, in order
__global__ void __launch_bounds__(VNT)
apply_rotations(const double2* __restrict__ rot, const int* __restrict__ state,
                double* __restrict__ Vt, int k) {
  __shared__ double col[MAX_K];
  __shared__ double2 stage[CHUNK][VNT];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int m = k + (k & 1);
  const int np = m / 2;
  for (int i = tid; i < k; i += VNT) col[i] = (i == j) ? 1.0 : 0.0;
  const int rounds = state[0] * (m - 1);
  for (int r0 = 0; r0 < rounds; r0 += CHUNK) {
    const int nr = min(CHUNK, rounds - r0);
    __syncthreads();  // the previous chunk is done with stage[]
    for (int e = tid; e < nr * np; e += VNT) stage[e / np][e % np] = rot[static_cast<int64_t>(r0) * np + e];
    __syncthreads();
    for (int rr = 0; rr < nr; ++rr) {
      if (tid < np) {
        int p, q;
        pair_of((r0 + rr) % (m - 1), tid, m, p, q);
        const double2 cs = stage[rr][tid];
        if (q < k && !(cs.x == 1.0 && cs.y == 0.0)) {
          const double a = col[p], b = col[q];
          col[p] = cs.x * a - cs.y * b;
          col[q] = cs.y * a + cs.x * b;
        }
      }
      __syncthreads();
    }
  }
  const bool ok = state[1] != 0;
  for (int i = tid; i < k; i += VNT) Vt[static_cast<int64_t>(i) * k + j] = ok ? col[i] : NAN;
}

}  // namespace

extern "C" {

// the rotation scratch tpeps_eigh_small_f64 needs, in double2 (c, s)
int64_t tpeps_eigh_small_rotations(int k, int max_sweeps) {
  const int m = k + (k & 1);
  return static_cast<int64_t>(max_sweeps) * (m - 1) * (m / 2);
}

// H (k x k, symmetric, row-major) -> unordered eigenvalues w and V^T (rows
// are the eigenvectors); rot: tpeps_eigh_small_rotations(k, max_sweeps)
// double2; state: [0] sweeps, [1] converged
int tpeps_eigh_small_f64(const double* H, double* w, double* Vt, double* rot, int* state, int k,
                         int max_sweeps, void* stream) {
  if (k <= 0) return cudaSuccess;
  const size_t smem = jacobi_smem(k);
  if (k > MAX_K || k > 64 * B_SLOTS || smem > SMEM_LIMIT || max_sweeps < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(jacobi_rounds, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  double2* r = reinterpret_cast<double2*>(rot);
  jacobi_rounds<<<1, NT, smem, st>>>(H, w, r, state, k, max_sweeps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  apply_rotations<<<k, VNT, 0, st>>>(r, state, Vt, k);
  return cudaGetLastError();
}

}  // extern "C"
