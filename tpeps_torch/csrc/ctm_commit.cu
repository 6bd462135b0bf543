// K5 loop control: the body and condition of run_fixed_point_tpu's
// lax.while_loop (tpeps/ctm/c4v/move_tpu.py:288-303) after each factored
// move, on the card, so that a CUDA graph of several moves needs no host
// read between them.
//
// One launch after each move (C2, T2, P2, W2, spec2 = the move's outputs;
// C, T, P, W, |spec_prev|, dist, conv_tol, ctl = the committed loop state
// and its limits, W the move's Procrustes rotation, ctl = [i, done, arrival
// counter, max_iter]; the limits are read on the card, so a captured graph
// serves any):
//   if done: return, the committed state untouched (a move after the loop
//     ended is discarded);
//   dist = || |spec2| - |spec_prev| ||_2   (conv_on "spec")
//        = max(max |C2 - C|, max |T2 - T|) (conv_on "env"),
//   a non-finite dist becomes +inf;
//   commit C, T, P, W <- C2, T2, P2, W2, |spec_prev| <- |spec2|, dist,
//   i <- i + 1;
//   done = !(i < max_iter && dist > conv_tol).
//
// What bounds it on an H100: the commit copies C, T, P and W (2 D^2 chi^2 +
// 2 chi^2 elements, 17 MB each way in f64 at D=7, chi=147) and, for "env",
// reads the old C and T once more: memory-bound, microseconds.
//
// Design: one launch with a fixed grid.  Every block first reads done (set
// by the previous launch), copies its grid-stride share of C, T, P and W
// (reading the old value for "env" before overwriting it) and writes its
// partial max.  The last block to arrive (a counter in ctl, reset by that
// block) reduces the partials in a fixed order, forms dist over the chi
// spectrum values, and writes dist, i, done and |spec_prev|.  The result
// does not depend on the order the blocks ran in.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int GRID = 264;  // two blocks per SM on a 132-SM card

template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) { return (a > b || a != a) ? a : b; }

// fixed-order tree reduction over the block (max or sum)
template <typename T>
__device__ T block_reduce(T v, bool is_max, T* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const T o = buf[threadIdx.x + s];
      buf[threadIdx.x] = is_max ? nanmax(buf[threadIdx.x], o) : buf[threadIdx.x] + o;
    }
    __syncthreads();
  }
  const T r = buf[0];
  __syncthreads();
  return r;
}

// -DTPEPS_CTM_VEC=1: a timing copy (chip_smoke.py --ablate --only commit)
// that copies in 16-byte vectors, UNROLL loads in flight a thread; not the
// kernel's copy: it was no faster in "spec" mode, in graphs or with the L2
// flushed
#ifndef TPEPS_CTM_VEC
#define TPEPS_CTM_VEC 0
#endif

#if !TPEPS_CTM_VEC
template <typename T>
__device__ T copy_diff(T* __restrict__ dst, const T* __restrict__ src, int64_t n, bool diff) {
  T acc = T(0);
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < n; e += stride) {
    const T v = src[e];
    if (diff) acc = nanmax(acc, fabs(v - dst[e]));
    dst[e] = v;
  }
  return acc;
}
#else
template <typename T> struct Vec16;
template <> struct Vec16<double> { using V = double2; static constexpr int L = 2; };
template <> struct Vec16<float> { using V = float4; static constexpr int L = 4; };

template <typename T>
__device__ __forceinline__ T vec_diff(T acc, const double2& a, const double2& b) {
  return nanmax(nanmax(acc, T(fabs(a.x - b.x))), T(fabs(a.y - b.y)));
}
template <typename T>
__device__ __forceinline__ T vec_diff(T acc, const float4& a, const float4& b) {
  acc = nanmax(nanmax(acc, T(fabsf(a.x - b.x))), T(fabsf(a.y - b.y)));
  return nanmax(nanmax(acc, T(fabsf(a.z - b.z))), T(fabsf(a.w - b.w)));
}

constexpr int UNROLL = 4;

// scalar until dst is 16-byte aligned, then 16-byte vectors (UNROLL loads a
// thread sent together, the old values beside them for "env"), then a
// scalar tail; all scalar where src is not aligned with dst
template <typename T>
__device__ T copy_diff(T* __restrict__ dst, const T* __restrict__ src, int64_t n, bool diff) {
  using V = typename Vec16<T>::V;
  constexpr int L = Vec16<T>::L;
  const int64_t stride = static_cast<int64_t>(GRID) * NT;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const uintptr_t ad = reinterpret_cast<uintptr_t>(dst), as = reinterpret_cast<uintptr_t>(src);
  int64_t head = ((16 - (ad & 15)) & 15) / sizeof(T);
  if (((ad - as) & 15) != 0 || head > n) head = n;
  const int64_t nv = (n - head) / L;
  T acc = T(0);
  for (int64_t e = tid; e < head; e += stride) {
    const T v = src[e];
    if (diff) acc = nanmax(acc, fabs(v - dst[e]));
    dst[e] = v;
  }
  const V* __restrict__ vs = reinterpret_cast<const V*>(src + head);
  V* __restrict__ vd = reinterpret_cast<V*>(dst + head);
  for (int64_t b = tid; b < nv; b += UNROLL * stride) {
    V v[UNROLL], o[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (b + u * stride < nv) v[u] = vs[b + u * stride];
    if (diff) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (b + u * stride < nv) o[u] = vd[b + u * stride];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (b + u * stride < nv) {
        if (diff) acc = vec_diff<T>(acc, v[u], o[u]);
        vd[b + u * stride] = v[u];
      }
  }
  for (int64_t e = head + nv * L + tid; e < n; e += stride) {
    const T v = src[e];
    if (diff) acc = nanmax(acc, fabs(v - dst[e]));
    dst[e] = v;
  }
  return acc;
}
#endif

template <typename T>
__global__ void __launch_bounds__(NT)
ctm_commit_kernel(T* __restrict__ C, T* __restrict__ Tt, T* __restrict__ P, T* __restrict__ W,
                  T* __restrict__ spec_prev, T* __restrict__ dist,
                  const double* __restrict__ conv_tol, int* __restrict__ ctl,
                  T* __restrict__ part, const T* __restrict__ C2, const T* __restrict__ T2,
                  const T* __restrict__ P2, const T* __restrict__ W2,
                  const T* __restrict__ spec2, int64_t nC, int64_t nT, int64_t nP, int64_t nW,
                  int chi, int conv_env) {
  __shared__ T buf[NT];
  __shared__ int last;
  if (ctl[1]) return;  // the loop has ended
  const bool env = conv_env != 0;
  T acc = copy_diff(C, C2, nC, env);
  acc = nanmax(acc, copy_diff(Tt, T2, nT, env));
  copy_diff(P, P2, nP, false);
  copy_diff(W, W2, nW, false);
  acc = block_reduce(acc, true, buf);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc;
    __threadfence();
    last = atomicAdd(&ctl[2], 1) == GRID - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T d;
  if (env) {
    T m = T(0);
    for (int b = threadIdx.x; b < GRID; b += NT) m = nanmax(m, __ldcg(part + b));
    d = block_reduce(m, true, buf);
  } else {
    T sq = T(0);
    for (int i = threadIdx.x; i < chi; i += NT) {
      const T x = fabs(spec2[i]) - spec_prev[i];
      sq += x * x;
    }
    d = sqrt(block_reduce(sq, false, buf));
  }
  for (int i = threadIdx.x; i < chi; i += NT) spec_prev[i] = fabs(spec2[i]);
  if (threadIdx.x == 0) {
    if (!isfinite(d)) d = T(INFINITY);
    dist[0] = d;
    const int it = ctl[0] + 1;
    ctl[0] = it;
    ctl[1] = (it < ctl[3] && static_cast<double>(d) > conv_tol[0]) ? 0 : 1;
    ctl[2] = 0;
  }
}

template <typename T>
int launch(T* C, T* Tt, T* P, T* W, T* spec_prev, T* dist, const double* conv_tol, int* ctl,
           T* part, const T* C2, const T* T2, const T* P2, const T* W2, const T* spec2,
           int64_t nC, int64_t nT, int64_t nP, int64_t nW, int chi, int conv_env,
           cudaStream_t stream) {
  ctm_commit_kernel<T><<<GRID, NT, 0, stream>>>(C, Tt, P, W, spec_prev, dist, conv_tol, ctl, part,
                                                C2, T2, P2, W2, spec2, nC, nT, nP, nW, chi,
                                                conv_env);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpeps_ctm_commit_partials(void) { return GRID; }

int tpeps_ctm_commit_f64(double* C, double* Tt, double* P, double* W, double* spec_prev,
                         double* dist, const double* conv_tol, int* ctl, double* part,
                         const double* C2, const double* T2, const double* P2, const double* W2,
                         const double* spec2, int64_t nC, int64_t nT, int64_t nP, int64_t nW,
                         int chi, int conv_env, void* stream) {
  return launch<double>(C, Tt, P, W, spec_prev, dist, conv_tol, ctl, part, C2, T2, P2, W2, spec2,
                        nC, nT, nP, nW, chi, conv_env, static_cast<cudaStream_t>(stream));
}

int tpeps_ctm_commit_f32(float* C, float* Tt, float* P, float* W, float* spec_prev, float* dist,
                         const double* conv_tol, int* ctl, float* part, const float* C2,
                         const float* T2, const float* P2, const float* W2, const float* spec2,
                         int64_t nC, int64_t nT, int64_t nP, int64_t nW, int chi, int conv_env,
                         void* stream) {
  return launch<float>(C, Tt, P, W, spec_prev, dist, conv_tol, ctl, part, C2, T2, P2, W2, spec2,
                       nC, nT, nP, nW, chi, conv_env, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
