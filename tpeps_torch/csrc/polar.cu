// K6: unitary polar factor of a small square real matrix O (k x k,
// row-major), computed as tpeps/linalg/power.py:polar_unitary (:32-57) does,
// and the vector-Jacobian product of its closed-form derivative
// (_polar_unitary_stable_jvp, :124-130):
//   polar_unitary: H = O^T O = V diag(w) V^T,
//                  W = O V diag(w^-1/2) V^T over the kept w > 1e-24 w_max,
//                  W = I when w_min <= 1e-20 w_max or W is not finite;
//   polar_vjp:     O_bar = W skew(W^T W_bar), skew(A) = (A - A^T) / 2.
// procrustes_align (:60-99) calls it once per CTMRG move on the
// chi x chi overlap O = P^T P_ref (chi = 147 at the slice); the VJP runs once
// per move VJP of the implicit adjoint.
//
// What bounds it on an H100.  The work is tiny (a k^3 product is 6.4 MFLOP
// at k = 147) and the eigendecomposition is a long chain of dependent steps,
// so it is latency-bound.  What it saves is elsewhere: the cuSOLVER eigh it
// replaces copies to the host and stalls the stream of the move; this
// kernel keeps the decomposition and both guards on the card.
//
// Design.  No host read; the branch is chosen on the card.  (1) H = O^T O
// on the two-operand Gram kernel of cholqr.cu.  (2) One block measures
// ||H - I||_F.  Below 0.9 every eigenvalue of H lies in (0.1, 1.9): both
// guards pass and every eigenvalue is kept, so the function is exactly the
// polar factor O H^-1/2, and the Newton-Schulz iteration Y <- Y (3I -
// Y^T Y) / 2 from Y = O reaches it to rounding within 8 steps (10 are
// run, as 20 tiled products over many blocks).  This is the main path: the
// overlap of consecutive CTMRG projectors is near-orthogonal.  Otherwise
// (cold starts, rank jumps) the same block diagonalises H by the cyclic
// two-sided Jacobi method in round-robin order, H in dynamic shared memory
// (173 KB at k = 147 in f64, attribute raised): each round rotates the k/2
// disjoint index pairs at once (rows, then columns, then each pair's own
// 2x2 block set exactly), k-1 rounds to a sweep, until the off-diagonal
// Frobenius norm is at most 1e-15 ||H||_F or a cap of sweeps (20 from
// the wrapper); a decomposition that did not converge counts as failed, as
// a cuSOLVER eigh that reports failure would: the guard writes I.  A
// warp takes a pair, its lanes the columns (rows).  V^T is accumulated in
// global memory (it stays in L2).  The block applies the guards to the
// unordered eigenvalues, picking w_max and w_min as eigh_desc's first and
// last entries would be picked (largest |w|, ties to the smaller value;
// smallest |w|, ties to the larger), and writes w^-1/2 (0 where not kept);
// two tiled products form Z = O V diag(w^-1/2) and W = Z V^T.  The last
// product's blocks vote on the finiteness of W, and (5) a guard launch
// writes I unless the decomposition converged, the overlap is
// well-conditioned and W is finite.  Every
// launch of the branch not taken returns at once.  Double precision only:
// the wrapper computes a float32 overlap's factor in float64.
// polar_vjp is one small launch of column tiles: each block forms its
// columns of skew(W^T W_bar) in shared memory and multiplies by W.
#include <cuda_runtime.h>
#include <stdint.h>

// the two-operand Gram of cholqr.cu, linked into the same library
extern "C" {
int tpeps_gram_f64(const double* A, const double* B, double* part, double* G, int n, int ka,
                   int kb, double eps, void* stream);
}

namespace {

constexpr int PNT = 1024;       // threads of the Jacobi block
constexpr int NWARP = PNT / 32;
constexpr int MAX_SLOTS = 6;    // columns per lane: k <= 192
constexpr int GT = 16;          // tile edge of the products
constexpr int NS_ITERS = 10;    // Newton-Schulz steps (8 reach rounding)
constexpr double NS_DEV2 = 0.81;  // ||H - I||_F^2 below which they run
constexpr int VNT = 256;        // threads of a VJP block
constexpr int VTJ = 8;          // columns of O_bar per VJP block

constexpr double OFF_TOL = 1e-15;    // Jacobi stops at off(H) <= OFF_TOL ||H||_F
constexpr double W_FLOOR = 1e-300;   // the clamp of w_max (as torch.clamp)

int gram(const double* A, double* part, double* G, int k, cudaStream_t s) {
  return tpeps_gram_f64(A, A, part, G, k, k, k, 0.0, s);
}

// round-robin (circle) schedule over m players: player 0 stays, the others
// rotate; position pos of round r holds this player
__device__ __forceinline__ int round_robin(int r, int pos, int m) {
  return pos == 0 ? 0 : 1 + (pos - 1 + r) % (m - 1);
}

// sum over the block in a fixed order; every thread gets the result
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T s = T(0);
  for (int w = 0; w < NWARP; ++w) s += red[w];
  return s;
}

size_t jacobi_smem(int k, size_t elem) {
  const int np = (k + (k & 1)) / 2;
  return (static_cast<size_t>(k) * k + 4 * np + 32) * elem + 2 * np * sizeof(int);
}

// state: [0] Jacobi sweeps, [1] converged, [2] condition ok, [3] W finite
// (set to 1 here, cleared by the product blocks), [4] 1 for the
// Newton-Schulz branch, 0 for Jacobi
template <typename T, int SLOTS>
__global__ void __launch_bounds__(PNT)
jacobi_kernel(const T* __restrict__ Hg, T* __restrict__ Vt, T* __restrict__ inv,
              int* __restrict__ state, int k, int max_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = k + (k & 1);  // players: one dummy when k is odd
  const int np = m / 2;       // pairs per round
  const int kk = k * k;
  T* H = reinterpret_cast<T*>(smem);
  T* pc = H + kk;     // np: cos of each pair's rotation
  T* ps = pc + np;    // np: sin
  T* dp = ps + np;    // np: new H[p][p]
  T* dq = dp + np;    // np: new H[q][q]
  T* red = dq + np;   // 32: reduction scratch
  int* pp = reinterpret_cast<int*>(red + 32);  // np: p of each pair
  int* pq = pp + np;                           // np: q, or -1 for no rotation
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  T part = T(0), dev = T(0);
  for (int e = tid; e < kk; e += PNT) {
    const T h = Hg[e];
    const T d = h - ((e / k == e % k) ? T(1) : T(0));
    H[e] = h;
    part += h * h;
    dev += d * d;
  }
  const T norm2 = block_sum(part, red);  // block_sum syncs before reading H
  const T dev2 = block_sum(dev, red);
  if (dev2 < T(NS_DEV2)) {  // near-orthogonal: the Newton-Schulz branch
    if (tid == 0) {
      state[0] = 0;
      state[1] = 1;
      state[2] = 1;
      state[3] = 1;
      state[4] = 1;
    }
    return;
  }
  for (int e = tid; e < kk; e += PNT) Vt[e] = (e / k == e % k) ? T(1) : T(0);

  int sweep = 0;
  int converged = 0;
  for (; sweep < max_sweeps; ++sweep) {
    part = T(0);
    for (int e = tid; e < kk; e += PNT)
      if (e / k != e % k) part += H[e] * H[e];
    const T off = block_sum(part, red);
    const T stop = T(OFF_TOL * OFF_TOL) * norm2;
    if (off <= stop) converged = 1;
    if (!(off > stop)) break;  // also stops on NaN
    for (int r = 0; r < m - 1; ++r) {
      // the rotation of each pair (Golub & Van Loan, sym.schur2): J^T H J
      // zeroes H[p][q] with J = [[c, s], [-s, c]] on rows/columns (p, q)
      for (int pr = tid; pr < np; pr += PNT) {
        int p = round_robin(r, pr, m), q = round_robin(r, m - 1 - pr, m);
        if (p > q) { const int x = p; p = q; q = x; }
        pp[pr] = p;
        pq[pr] = -1;
        if (q >= k) continue;  // paired with the dummy
        const T hpq = H[p * k + q];
        if (hpq == T(0)) continue;
        const T hpp = H[p * k + p], hqq = H[q * k + q];
        const T tau = (hqq - hpp) / (T(2) * hpq);
        const T t = (tau >= T(0) ? T(1) : T(-1)) / (fabs(tau) + sqrt(T(1) + tau * tau));
        const T c = T(1) / sqrt(T(1) + t * t);
        pc[pr] = c;
        ps[pr] = t * c;
        dp[pr] = hpp - t * hpq;
        dq[pr] = hqq + t * hpq;
        pq[pr] = q;
      }
      __syncthreads();
      // rows: H <- J^T H and V <- V J as rows of V^T; a warp per pair
      for (int pr = warp; pr < np; pr += NWARP) {
        const int q = pq[pr];
        if (q < 0) continue;
        const int p = pp[pr];
        const T c = pc[pr], s = ps[pr];
        T* hp = H + p * k;
        T* hq = H + q * k;
        T* vp = Vt + static_cast<int64_t>(p) * k;
        T* vq = Vt + static_cast<int64_t>(q) * k;
        T va[SLOTS], vb[SLOTS];
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const int j = lane + 32 * t;
          if (j < k) {
            va[t] = vp[j];
            vb[t] = vq[j];
          }
        }
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const int j = lane + 32 * t;
          if (j < k) {
            const T a = hp[j], b = hq[j];
            hp[j] = c * a - s * b;
            hq[j] = s * a + c * b;
            vp[j] = c * va[t] - s * vb[t];
            vq[j] = s * va[t] + c * vb[t];
          }
        }
      }
      __syncthreads();
      // columns: H <- H J; the pair's own 2x2 block gets its exact values
      for (int pr = warp; pr < np; pr += NWARP) {
        const int q = pq[pr];
        if (q < 0) continue;
        const int p = pp[pr];
        const T c = pc[pr], s = ps[pr];
#pragma unroll
        for (int t = 0; t < SLOTS; ++t) {
          const int i = lane + 32 * t;
          if (i >= k) continue;
          if (i == p) {
            H[p * k + p] = dp[pr];
            H[p * k + q] = T(0);
          } else if (i == q) {
            H[q * k + p] = T(0);
            H[q * k + q] = dq[pr];
          } else {
            const T a = H[i * k + p], b = H[i * k + q];
            H[i * k + p] = c * a - s * b;
            H[i * k + q] = s * a + c * b;
          }
        }
      }
      __syncthreads();
    }
  }

  // the guards of polar_unitary on the unordered eigenvalues; the sync keeps
  // red[] from being overwritten while the last block_sum is still read
  __syncthreads();
  if (tid == 0) {
    T w0 = H[0], wl = H[0];
    for (int i = 1; i < k; ++i) {
      const T w = H[i * k + i];
      if (fabs(w) > fabs(w0) || (fabs(w) == fabs(w0) && w < w0)) w0 = w;
      if (fabs(w) < fabs(wl) || (fabs(w) == fabs(wl) && w > wl)) wl = w;
    }
    w0 = w0 > T(W_FLOOR) ? w0 : T(W_FLOOR);
    red[0] = w0;
    state[0] = sweep;
    state[1] = converged;
    state[2] = (wl > T(1e-20) * w0) ? 1 : 0;
    state[3] = 1;
    state[4] = 0;
  }
  __syncthreads();
  const T w0 = red[0];
  for (int i = tid; i < k; i += PNT) {
    const T w = H[i * k + i];
    inv[i] = (w > T(1e-24) * w0) ? T(1) / sqrt(w) : T(0);
  }
}

// C = alpha op(A) op(B) diag(scale) + beta I (k x k, row-major), op = ^T
// where TA / TB; with `ok`, a block that wrote a non-finite entry clears
// ok[0]; the launch does nothing unless *branch == run_on
template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(GT * GT)
small_gemm(const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ scale,
           T alpha, T beta, T* __restrict__ C, int* __restrict__ ok,
           const int* __restrict__ branch, int run_on, int k) {
  if (*branch != run_on) return;
  __shared__ T As[GT][GT + 1];  // As[i][m] = op(A)[i0 + i][m0 + m]
  __shared__ T Bs[GT][GT + 1];  // Bs[m][j] = op(B)[m0 + m][j0 + j]
  const int tx = threadIdx.x % GT, ty = threadIdx.x / GT;
  const int i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  T acc = T(0);
  for (int m0 = 0; m0 < k; m0 += GT) {
    if (TA)  // op(A)[i][m] = A[m][i]: read A rows m0 + ty, coalesced in i
      As[tx][ty] = (m0 + ty < k && i0 + tx < k) ? A[(m0 + ty) * k + i0 + tx] : T(0);
    else
      As[ty][tx] = (i0 + ty < k && m0 + tx < k) ? A[(i0 + ty) * k + m0 + tx] : T(0);
    if (TB)  // op(B)[m][j] = B[j][m]: read B rows j0 + ty, coalesced in m
      Bs[tx][ty] = (j0 + ty < k && m0 + tx < k) ? B[(j0 + ty) * k + m0 + tx] : T(0);
    else
      Bs[ty][tx] = (m0 + ty < k && j0 + tx < k) ? B[(m0 + ty) * k + j0 + tx] : T(0);
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < GT; ++mm)
      acc = fma(As[ty][mm], Bs[mm][tx], acc);
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  int finite = 1;
  if (i < k && j < k) {
    if (scale != nullptr) acc *= scale[j];
    const T c = alpha * acc + (i == j ? beta : T(0));
    C[i * k + j] = c;
    finite = isfinite(c) ? 1 : 0;
  }
  if (ok != nullptr && !__syncthreads_and(finite) && threadIdx.x == 0) ok[0] = 0;
}

template <typename T>
__global__ void polar_guard(T* __restrict__ W, const int* __restrict__ state, int k) {
  if (state[1] && state[2] && state[3]) return;
  const int64_t kk = static_cast<int64_t>(k) * k;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < kk;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x)
    W[e] = (e / k == e % k) ? T(1) : T(0);
}

template <typename T>
__global__ void __launch_bounds__(VNT)
polar_vjp_kernel(const T* __restrict__ W, const T* __restrict__ G, T* __restrict__ Ob, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);  // S[mm][jj] = skew(W^T G)[mm][j0 + jj]
  const int j0 = blockIdx.x * VTJ;
  const int nj = min(VTJ, k - j0);
  for (int e = threadIdx.x; e < k * nj; e += VNT) {
    const int mm = e % k, jj = e / k;
    const int j = j0 + jj;
    T bc = T(0), br = T(0);  // B[mm][j] and B[j][mm], B = W^T G
    for (int l = 0; l < k; ++l) {
      bc = fma(W[l * k + mm], G[l * k + j], bc);
      br = fma(W[l * k + j], G[l * k + mm], br);
    }
    S[mm * VTJ + jj] = T(0.5) * (bc - br);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < k * nj; e += VNT) {
    const int i = e / nj, jj = e % nj;
    T o = T(0);
    for (int mm = 0; mm < k; ++mm) o = fma(W[i * k + mm], S[mm * VTJ + jj], o);
    Ob[i * k + j0 + jj] = o;
  }
}

template <typename T, int SLOTS>
int launch_jacobi(const T* H, T* Vt, T* inv, int* state, int k, int max_sweeps,
                  cudaStream_t stream) {
  const size_t smem = jacobi_smem(k, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(jacobi_kernel<T, SLOTS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  jacobi_kernel<T, SLOTS><<<1, PNT, smem, stream>>>(H, Vt, inv, state, k, max_sweeps);
  return cudaGetLastError();
}

// scratch: part (the Gram's partials, k*k), H, Vt, Z (k*k each), inv (k)
template <typename T>
int launch_polar(const T* O, T* part, T* H, T* Vt, T* Z, T* inv, T* W, int* state, int k,
                 int max_sweeps, cudaStream_t stream) {
  if (k <= 0) return cudaSuccess;
  if (k > 32 * MAX_SLOTS) return cudaErrorInvalidValue;
  int err = gram(O, part, H, k, stream);
  if (err != cudaSuccess) return err;
  switch ((k + 31) / 32) {  // columns per lane: exactly ceil(k / 32)
    case 1: err = launch_jacobi<T, 1>(H, Vt, inv, state, k, max_sweeps, stream); break;
    case 2: err = launch_jacobi<T, 2>(H, Vt, inv, state, k, max_sweeps, stream); break;
    case 3: err = launch_jacobi<T, 3>(H, Vt, inv, state, k, max_sweeps, stream); break;
    case 4: err = launch_jacobi<T, 4>(H, Vt, inv, state, k, max_sweeps, stream); break;
    case 5: err = launch_jacobi<T, 5>(H, Vt, inv, state, k, max_sweeps, stream); break;
    default: err = launch_jacobi<T, 6>(H, Vt, inv, state, k, max_sweeps, stream); break;
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((k + GT - 1) / GT, (k + GT - 1) / GT);
  const int* branch = state + 4;
  // Jacobi branch: Z = O V diag(w^-1/2), W = Z V^T
  small_gemm<T, false, true><<<grid, GT * GT, 0, stream>>>(O, Vt, inv, T(1), T(0), Z, nullptr,
                                                           branch, 0, k);
  small_gemm<T, false, false><<<grid, GT * GT, 0, stream>>>(Z, Vt, nullptr, T(1), T(0), W,
                                                            state + 3, branch, 0, k);
  // Newton-Schulz branch: M = 3/2 I - Y^T Y / 2 (in H), Y <- Y M, from Y = O;
  // Z and V^T are the ping-pong buffers, the last step writes W
  const T* y = O;
  for (int it = 0; it < NS_ITERS; ++it) {
    const bool last = it == NS_ITERS - 1;
    T* out = last ? W : (it % 2 == 0 ? Z : Vt);
    small_gemm<T, true, false><<<grid, GT * GT, 0, stream>>>(y, y, nullptr, T(-0.5), T(1.5), H,
                                                             nullptr, branch, 1, k);
    small_gemm<T, false, false><<<grid, GT * GT, 0, stream>>>(
        y, H, nullptr, T(1), T(0), out, last ? state + 3 : nullptr, branch, 1, k);
    y = out;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  polar_guard<T><<<(k * k + 255) / 256, 256, 0, stream>>>(W, state, k);
  return cudaGetLastError();
}

template <typename T>
int launch_polar_vjp(const T* W, const T* G, T* Ob, int k, cudaStream_t stream) {
  if (k <= 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(k) * VTJ * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(polar_vjp_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  polar_vjp_kernel<T><<<(k + VTJ - 1) / VTJ, VNT, smem, stream>>>(W, G, Ob, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int64_t tpeps_polar_smem(int k, int elem) { return static_cast<int64_t>(jacobi_smem(k, elem)); }

int tpeps_polar_unitary_f64(const double* O, double* scratch, double* W, int* state, int k,
                            int max_sweeps, void* stream) {
  // scratch: 4 k*k + k elements (Gram partials, H, V^T, Z, w^-1/2)
  const int64_t kk = static_cast<int64_t>(k) * k;
  return launch_polar<double>(O, scratch, scratch + kk, scratch + 2 * kk, scratch + 3 * kk,
                              scratch + 4 * kk, W, state, k, max_sweeps,
                              static_cast<cudaStream_t>(stream));
}

int tpeps_polar_vjp_f64(const double* W, const double* G, double* Ob, int k, void* stream) {
  return launch_polar_vjp<double>(W, G, Ob, k, static_cast<cudaStream_t>(stream));
}

int tpeps_polar_vjp_f32(const float* W, const float* G, float* Ob, int k, void* stream) {
  return launch_polar_vjp<float>(W, G, Ob, k, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
