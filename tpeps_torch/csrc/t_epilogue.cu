// Edge epilogue: out = sym(x) / scale with
//   sym(x)[b, i, j] = 0.5 * (x[b, i, j] + x[b, j, i])   (b over the D^2 axes)
//   scale = max |sym(x)|  (mode 0)   or   ||sym(x)||_2  (mode 1)
//
// Replaces the epilogue of tpeps/ctm/c4v/move_tpu.py:ctm_move_sl_tpu
// (:239-248): hermitian symmetrisation of T' over its two chi axes, then
// division by max|T'| or by its 2-norm.  Real inputs only (for real T' the
// conjugate is the identity); the complex case raises in the wrapper.
//
// What bounds it on an H100: one read of T' and two writes of the result,
// D^2 chi^2 elements (8.5 MB in f64 at D=7, chi=147), plus a global
// reduction: memory and launch latency, not arithmetic.
//
// Design: two passes with a fixed grid, so the reduction order never
// depends on scheduling and repeated runs agree bit for bit.  Pass 1
// symmetrises into `out` and writes one partial (max or sum of squares)
// per block after a fixed-order tree reduction in shared memory.  Pass 2
// has every block reduce the same partials in the same order, so each
// gets the identical scale, then divides its grid-stride share of `out`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int GRID = 264;    // fixed grid (two blocks per SM on a 132-SM card)

template <typename T>
__device__ T block_reduce(T v, int mode, T* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const T o = buf[threadIdx.x + s];
      buf[threadIdx.x] = mode == 0 ? fmax(buf[threadIdx.x], o) : buf[threadIdx.x] + o;
    }
    __syncthreads();
  }
  const T r = buf[0];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(NT)
sym_partial(const T* __restrict__ x, T* __restrict__ out, T* __restrict__ part, int64_t batch,
            int m, int mode) {
  __shared__ T buf[NT];
  const int64_t mm = static_cast<int64_t>(m) * m;
  const int64_t total = batch * mm;
  T acc = T(0);
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < total;
       e += static_cast<int64_t>(GRID) * NT) {
    const int64_t b = e / mm, ij = e % mm;
    const int64_t i = ij / m, j = ij % m;
    const T v = T(0.5) * (x[e] + x[b * mm + j * m + i]);
    out[e] = v;
    acc = mode == 0 ? fmax(acc, fabs(v)) : fma(v, v, acc);
  }
  const T r = block_reduce(acc, mode, buf);
  if (threadIdx.x == 0) part[blockIdx.x] = r;
}

template <typename T>
__global__ void __launch_bounds__(NT)
apply_scale(T* __restrict__ out, const T* __restrict__ part, int64_t total, int mode) {
  __shared__ T buf[NT];
  T acc = T(0);
  for (int t = threadIdx.x; t < GRID; t += NT)
    acc = mode == 0 ? fmax(acc, part[t]) : acc + part[t];
  const T r = block_reduce(acc, mode, buf);
  const T scale = mode == 0 ? r : sqrt(r);
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x; e < total;
       e += static_cast<int64_t>(GRID) * NT)
    out[e] = out[e] / scale;
}

template <typename T>
int launch(const T* x, T* out, T* part, int64_t batch, int m, int mode, cudaStream_t stream) {
  if (batch == 0 || m == 0) return cudaSuccess;
  sym_partial<T><<<GRID, NT, 0, stream>>>(x, out, part, batch, m, mode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  apply_scale<T><<<GRID, NT, 0, stream>>>(out, part, batch * m * m, mode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpeps_t_epilogue_partials(void) { return GRID; }

int tpeps_t_epilogue_f64(const double* x, double* out, double* part, int64_t batch, int m,
                         int mode, void* stream) {
  return launch<double>(x, out, part, batch, m, mode, static_cast<cudaStream_t>(stream));
}

int tpeps_t_epilogue_f32(const float* x, float* out, float* part, int64_t batch, int m,
                         int mode, void* stream) {
  return launch<float>(x, out, part, batch, m, mode, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
