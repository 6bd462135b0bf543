// Helpers of the cooperative kernels (t_epilogue.cu, frozen_commit.cu,
// frozen_generic.cu): the grid barrier, the grid that fits on the card at
// once, and |x| as bits that order like the values (for an order-free atomic
// max of non-negative floats).
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

}  // namespace
