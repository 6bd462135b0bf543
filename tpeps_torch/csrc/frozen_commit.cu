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

}  // namespace

extern "C" {

int tpeps_frozen_commit_partials(void) { return 2 * GRID; }

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
