// Helpers of the cooperative kernels (t_epilogue.cu, frozen_commit.cu,
// frozen_generic.cu): the grid barrier (whole, or in two halves), the grid
// that fits on the card at once, |x| as bits that order like the values (for an order-free atomic
// max of non-negative floats), and the two epilogue VJPs' arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace {

// every block of the grid waits here; the last to leave resets both counters
// to zero (bar[0] arrivals, bar[1] departures), as every launch leaves them
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned*>(bar) < gridDim.x) __nanosleep(32);
    __threadfence();
    if (atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
      bar[0] = 0u;
      bar[1] = 0u;
    }
  }
  __syncthreads();
}

// a grid barrier in two halves on an arrival counter c of its own: every
// block arrives, after a block-wide __syncthreads of the caller's (the
// block's writes before it visible to those that wait), and only the blocks
// that read the others' writes wait; the caller resets c once every block
// has arrived and none waits (the last block done, say)
__device__ void grid_arrive(unsigned* c) {
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(c, 1u);
  }
}
__device__ void grid_wait(unsigned* c) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile unsigned*>(c) < gridDim.x) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// the cooperative grid of `kernel` at `nt` threads a block: the occupancy
// query's blocks an SM, at most `per_sm_max`, times the SMs, at most
// `max_grid` (the callers cache it)
template <typename Kernel>
cudaError_t coop_grid(Kernel kernel, int nt, int per_sm_max, int max_grid, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt, 0);
  if (e != cudaSuccess) return e;
  const int g = sms * (per_sm < per_sm_max ? per_sm : per_sm_max);
  if (g < 1) return cudaErrorInvalidConfiguration;
  grid = g < max_grid ? g : max_grid;
  return cudaSuccess;
}

// |x| as bits that order like the values (a NaN above inf), and back
__device__ __forceinline__ unsigned long long abs_bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(x)));
}
__device__ __forceinline__ unsigned long long abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double(static_cast<long long>(b));
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float(static_cast<unsigned>(b));
}

// torch.sign: +-1, a zero or a NaN as it is
template <typename T>
__device__ __forceinline__ T sgn(T z) {
  return z > T(0) ? T(1) : z < T(0) ? T(-1) : z;
}

// a product rounded on its own, never fused with a following sum into an
// FMA (the twin rounds every product)
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// the cotangent of z for the cotangent g of y = z * (1 / max|z|):
// g/m - (coef w) sign(z), coef = sum g.z / m^2, w the element's share of the
// max's derivative (0 off the maximum), in the twin's order
template <typename T>
__device__ __forceinline__ T scale_vjp(T g, T inv, T coef, T w, T s) {
  return mul_rn(g, inv) - mul_rn(mul_rn(coef, w), s);
}

}  // namespace
