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
// What bounds it on an H100: a few reads and writes of C and T (~250k
// elements at D=8, chi=160): microseconds, latency rather than bandwidth.
//
// Design: every block symmetrizes its grid-stride share into a scratch
// buffer and writes its partial maxima; the last block to arrive (a counter
// in ctl, reset by that block) reduces the partials in a fixed order, then
// alone scales, forms dist2 and commits.  The scale is applied as a product
// with 1 / max, as the JAX code does, so C and T are bit-identical to the
// plain twin's; dist2 differs from it only in summation order.
//
// Two kernels of the implicit adjoint of converge_frozen (the backward of
// tpeps/ctm/c4v_abelian/frozen.py:_make_converge_frozen, :160-233) live here
// too:
//
// frozen_epilogue_vjp: the backward of the epilogue above with the scale
//   differentiated (the JAX package's move_frozen at sg_norm=False).  With z = sym(x),
//   m = max|z| and y = z * (1/m): zbar = ybar/m - (sum ybar.z / m^2) w sign(z),
//   w splitting 1 evenly over every element with |z| = m (a symmetrized
//   off-diagonal maximum appears at least twice, bit for bit), and
//   xbar = sym(zbar).  A reduction pass (per block: max, count at the max,
//   sum ybar.z, for C and T) and an elementwise pass, in which every block
//   first reduces the partials in the same fixed order; no atomics.
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

namespace {

constexpr int NT = 256;
constexpr int GRID = 264;

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

template <typename T>
__device__ T symmetrize(T* __restrict__ sym, const T* __restrict__ raw,
                        const int64_t* __restrict__ partner, int64_t n) {
  T m = T(0);
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride) {
    const int64_t p = partner[e];
    const T v = T(0.5) * (raw[e] + (p >= 0 ? raw[p] : T(0)));
    sym[e] = v;
    m = fmax(m, fabs(v));
  }
  return m;
}

template <typename T>
__device__ T scale_commit(T* __restrict__ dst, const T* __restrict__ sym, T inv, int64_t n) {
  T d = T(0);
  for (int64_t e = threadIdx.x; e < n; e += NT) {
    const T v = __ldcg(sym + e) * inv;
    const T x = v - dst[e];
    d += x * x;
    dst[e] = v;
  }
  return d;
}

template <typename T>
__global__ void __launch_bounds__(NT)
frozen_commit_kernel(T* __restrict__ C, T* __restrict__ Tt, T* __restrict__ dist2,
                     const double* __restrict__ conv_tol, int* __restrict__ ctl,
                     T* __restrict__ sym, T* __restrict__ part, const T* __restrict__ rawC,
                     const T* __restrict__ rawT, const int64_t* __restrict__ pC,
                     const int64_t* __restrict__ pT, int64_t nC, int64_t nT) {
  __shared__ T buf[NT];
  __shared__ int last;
  if (ctl[1]) return;  // the loop has ended
  const T mC = block_reduce(symmetrize(sym, rawC, pC, nC), true, buf);
  const T mT = block_reduce(symmetrize(sym + nC, rawT, pT, nT), true, buf);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = mC;
    part[GRID + blockIdx.x] = mT;
    __threadfence();
    last = atomicAdd(&ctl[2], 1) == GRID - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T sC = T(0), sT = T(0);
  for (int b = threadIdx.x; b < GRID; b += NT) {
    sC = fmax(sC, __ldcg(part + b));
    sT = fmax(sT, __ldcg(part + GRID + b));
  }
  sC = block_reduce(sC, true, buf);
  sT = block_reduce(sT, true, buf);
  T d = scale_commit(C, sym, T(1) / sC, nC) + scale_commit(Tt, sym + nC, T(1) / sT, nT);
  d = block_reduce(d, false, buf);
  if (threadIdx.x == 0) {
    dist2[0] = d;
    const int it = ctl[0] + 1;
    ctl[0] = it;
    const double tol = conv_tol[0];
    ctl[1] = (it < ctl[3] && static_cast<double>(d) > tol * tol) ? 0 : 1;
    ctl[2] = 0;
  }
}

template <typename T>
int launch(T* C, T* Tt, T* dist2, const double* conv_tol, int* ctl, T* sym, T* part,
           const T* rawC, const T* rawT, const int64_t* pC, const int64_t* pT, int64_t nC,
           int64_t nT, cudaStream_t stream) {
  frozen_commit_kernel<T><<<GRID, NT, 0, stream>>>(C, Tt, dist2, conv_tol, ctl, sym, part, rawC,
                                                   rawT, pC, pT, nC, nT);
  return cudaGetLastError();
}

// ---- frozen_epilogue_vjp ---------------------------------------------------

// (max, count at the max) merged with another pair
template <typename T>
__device__ __forceinline__ void merge_max(T& m, T& c, T m2, T c2) {
  if (m2 > m) {
    m = m2;
    c = c2;
  } else if (m2 == m) {
    c += c2;
  }
}

// block-wide merge of (max, count, sum); the result is in every thread
template <typename T>
__device__ void block_reduce3(T& m, T& c, T& d, T* bm, T* bc, T* bd) {
  bm[threadIdx.x] = m;
  bc[threadIdx.x] = c;
  bd[threadIdx.x] = d;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      T m1 = bm[threadIdx.x], c1 = bc[threadIdx.x];
      merge_max(m1, c1, bm[threadIdx.x + s], bc[threadIdx.x + s]);
      bm[threadIdx.x] = m1;
      bc[threadIdx.x] = c1;
      bd[threadIdx.x] += bd[threadIdx.x + s];
    }
    __syncthreads();
  }
  m = bm[0];
  c = bc[0];
  d = bd[0];
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T sym_at(const T* __restrict__ raw, const int64_t* __restrict__ partner,
                                    int64_t e) {
  const int64_t p = partner[e];
  return T(0.5) * (raw[e] + (p >= 0 ? raw[p] : T(0)));
}

template <typename T>
__device__ void epi_local(const T* __restrict__ raw, const int64_t* __restrict__ partner,
                          const T* __restrict__ g, int64_t n, T* bm, T* bc, T* bd, T* out) {
  T m = T(0), c = T(0), d = T(0);
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride) {
    const T z = sym_at(raw, partner, e);
    merge_max(m, c, fabs(z), T(1));
    d += g[e] * z;
  }
  block_reduce3(m, c, d, bm, bc, bd);
  if (threadIdx.x == 0) {
    out[3 * blockIdx.x] = m;
    out[3 * blockIdx.x + 1] = c;
    out[3 * blockIdx.x + 2] = d;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_vjp_reduce(const T* __restrict__ rawC, const T* __restrict__ rawT,
                    const int64_t* __restrict__ pC, const int64_t* __restrict__ pT,
                    const T* __restrict__ gC, const T* __restrict__ gT, int64_t nC, int64_t nT,
                    T* __restrict__ part) {
  __shared__ T bm[NT], bc[NT], bd[NT];
  epi_local(rawC, pC, gC, nC, bm, bc, bd, part);
  epi_local(rawT, pT, gT, nT, bm, bc, bd, part + 3 * GRID);
}

template <typename T>
__device__ void epi_apply(const T* __restrict__ raw, const int64_t* __restrict__ partner,
                          const T* __restrict__ g, T* __restrict__ x, int64_t n,
                          const T* __restrict__ part, T* bm, T* bc, T* bd) {
  T m = T(0), c = T(0), d = T(0);
  for (int b = threadIdx.x; b < GRID; b += NT) {
    merge_max(m, c, part[3 * b], part[3 * b + 1]);
    d += part[3 * b + 2];
  }
  block_reduce3(m, c, d, bm, bc, bd);
  const T inv = T(1) / m;
  const T coef = d * inv * inv / c;
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride) {
    const int64_t p = partner[e];
    const T z = sym_at(raw, partner, e);
    // the max term at a tie; z and its partner's z are equal bit for bit
    const T tie = fabs(z) == m ? (z > T(0) ? coef : -coef) : T(0);
    const T zb = g[e] * inv - tie;
    x[e] = T(0.5) * (zb + (p >= 0 ? g[p] * inv - tie : T(0)));
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
epilogue_vjp_apply(const T* __restrict__ rawC, const T* __restrict__ rawT,
                   const int64_t* __restrict__ pC, const int64_t* __restrict__ pT,
                   const T* __restrict__ gC, const T* __restrict__ gT, T* __restrict__ xC,
                   T* __restrict__ xT, int64_t nC, int64_t nT, const T* __restrict__ part) {
  __shared__ T bm[NT], bc[NT], bd[NT];
  epi_apply(rawC, pC, gC, xC, nC, part, bm, bc, bd);
  epi_apply(rawT, pT, gT, xT, nT, part + 3 * GRID, bm, bc, bd);
}

template <typename T>
int epilogue_vjp_launch(const T* rawC, const T* rawT, const int64_t* pC, const int64_t* pT,
                        const T* gC, const T* gT, T* xC, T* xT, T* part, int64_t nC,
                        int64_t nT, cudaStream_t stream) {
  epilogue_vjp_reduce<T><<<GRID, NT, 0, stream>>>(rawC, rawT, pC, pT, gC, gT, nC, nT, part);
  epilogue_vjp_apply<T><<<GRID, NT, 0, stream>>>(rawC, rawT, pC, pT, gC, gT, xC, xT, nC, nT,
                                                 part);
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

int tpeps_frozen_commit_partials(void) { return 2 * GRID; }

int tpeps_frozen_epilogue_vjp_partials(void) { return 6 * GRID; }

int tpeps_adjoint_commit_partials(void) { return GRID; }

int tpeps_frozen_epilogue_vjp_f64(const double* rawC, const double* rawT, const int64_t* pC,
                                  const int64_t* pT, const double* gC, const double* gT,
                                  double* xC, double* xT, double* part, int64_t nC, int64_t nT,
                                  void* stream) {
  return epilogue_vjp_launch<double>(rawC, rawT, pC, pT, gC, gT, xC, xT, part, nC, nT,
                                     static_cast<cudaStream_t>(stream));
}

int tpeps_frozen_epilogue_vjp_f32(const float* rawC, const float* rawT, const int64_t* pC,
                                  const int64_t* pT, const float* gC, const float* gT, float* xC,
                                  float* xT, float* part, int64_t nC, int64_t nT, void* stream) {
  return epilogue_vjp_launch<float>(rawC, rawT, pC, pT, gC, gT, xC, xT, part, nC, nT,
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

int tpeps_frozen_commit_f64(double* C, double* Tt, double* dist2, const double* conv_tol,
                            int* ctl, double* sym, double* part, const double* rawC,
                            const double* rawT, const int64_t* pC, const int64_t* pT,
                            int64_t nC, int64_t nT, void* stream) {
  return launch<double>(C, Tt, dist2, conv_tol, ctl, sym, part, rawC, rawT, pC, pT, nC, nT,
                        static_cast<cudaStream_t>(stream));
}

int tpeps_frozen_commit_f32(float* C, float* Tt, float* dist2, const double* conv_tol, int* ctl,
                            float* sym, float* part, const float* rawC, const float* rawT,
                            const int64_t* pC, const int64_t* pT, int64_t nC, int64_t nT,
                            void* stream) {
  return launch<float>(C, Tt, dist2, conv_tol, ctl, sym, part, rawC, rawT, pC, pT, nC, nT,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
