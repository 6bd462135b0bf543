// Corner apply: Y = M2 @ P for the enlarged corner M2 (n x n, row-major)
// and a tall basis P (n x m, row-major), n = chi*D^2, m = chi.
//
// Replaces tpeps/ctm/c4v/move_tpu.py:_m_apply (:121-130), which applies the
// factored corner M6[f,g,e,r,j,i] to P and transposes the result from
// (f,e,j) to (j,e,f) rows.  Here the corner arrives already as the matrix
// M2[(j,e,f),(i,r,g)] (the bra-layer launch of layer_contract writes it in
// that order), so the product reads plain strides and no transpose follows.
//
// What bounds it on an H100: 2*n^2*m flops (15.3 GFLOP at D=7, chi=147)
// over n^2 elements of M2 read once (415 MB in f64): about 37 flop per
// byte, so the f64 arithmetic rate bounds it, not memory.
//
// Design.  f64 runs on the FP64 tensor cores through mma.sync m16n8k4
// (DMMA; measured on the H100 faster than m8n8k4 and than m16n8k16 at this
// tile): a block of 4 warps computes a 64 x 64 tile of Y, each warp a
// 32 x 32 quadrant as 2 x 4 DMMA tiles held in registers; K is walked in
// 32-deep slabs staged in shared memory, padded so that the fragment loads
// of a warp touch every bank exactly twice (the minimum for 8-byte words).
// Slabs arrive by cp.async into two stages, so the copy of the next slab
// overlaps the DMMA work on the current one without holding it in registers
// (a register prefetch spilled).  The three column tiles
// of one row tile are neighbours in the grid, so M2 is read from device
// memory about once and served to the other two from L2.
// f32 keeps the first version: a shared-memory tiled GEMM on the CUDA cores,
// 256 threads each holding a 4 x 4 register tile.  Edges are masked: n and
// m are not multiples of the tile.  TMA, deeper pipelines and a tile
// matched to m = 147 (3 x 64 wastes 23% of the columns) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
            int M, int N, int K) {
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int col0 = blockIdx.x * BN;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / NT; ++l) {
      const int e = tid + l * NT;
      const int r = e / BK, c = e % BK;
      const int64_t gr = row0 + r;
      const int gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[gr * K + gc] : T(0);
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / NT; ++l) {
      const int e = tid + l * NT;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[static_cast<int64_t>(gr) * N + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[r * N + c] = acc[i][j];
    }
  }
}

// ---- f64: DMMA (mma.sync.aligned.m16n8k4.row.col.f64) ---------------------
// Fragments of m16n8k4 f64, with g = lane / 4 and t = lane % 4:
//   A (16 x 4, row): a0 = A[g][t], a1 = A[g + 8][t];  B (4 x 8, col): b0 = B[t][g];
//   C/D (16 x 8): c0, c1 = C[g][2t], C[g][2t + 1];  c2, c3 = C[g + 8][2t], C[g + 8][2t + 1].
constexpr int DBM = 64, DBN = 64, DBK = 32, DNT = 128;
constexpr int AS = DBK + 4;   // row stride of an A slab (doubles)
constexpr int BS = DBN + 4;   // row stride of a B slab (doubles)
constexpr int SLAB = DBM * AS + DBK * BS;  // doubles per pipeline stage
constexpr size_t DSMEM = 2 * SLAB * sizeof(double);

__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// 8-byte asynchronous copy global -> shared; zero-fills when !ok.
__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}

// Issue the copies of the slab at k0 into one pipeline stage.
__device__ __forceinline__ void issue_slab(const double* __restrict__ A,
                                           const double* __restrict__ B, double* stage,
                                           int M, int N, int K, int64_t row0, int col0,
                                           int k0, int tid) {
  double* As = stage;
  double* Bs = stage + DBM * AS;
#pragma unroll 4
  for (int e = tid; e < DBM * DBK; e += DNT) {
    const int r = e / DBK, c = e % DBK;
    const int64_t gr = row0 + r;
    const bool ok = gr < M && k0 + c < K;
    cp_async8(As + r * AS + c, ok ? A + gr * K + k0 + c : A, ok);
  }
#pragma unroll 4
  for (int e = tid; e < DBK * DBN; e += DNT) {
    const int r = e / DBN, c = e % DBN;
    const bool ok = k0 + r < K && col0 + c < N;
    cp_async8(Bs + r * BS + c, ok ? B + static_cast<int64_t>(k0 + r) * N + col0 + c : B, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(DNT)
dmma_gemm_kernel(const double* __restrict__ A, const double* __restrict__ B,
                 double* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) double dsm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * DBM;
  const int col0 = blockIdx.x * DBN;

  double acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;

  // two-stage pipeline: the copy of slab s+1 runs while slab s computes
  const int nslab = (K + DBK - 1) / DBK;
  issue_slab(A, B, dsm, M, N, K, row0, col0, 0, tid);
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) {
      issue_slab(A, B, dsm + ((s + 1) % 2) * SLAB, M, N, K, row0, col0, (s + 1) * DBK, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const double* As = dsm + (s % 2) * SLAB;
    const double* Bs = As + DBM * AS;
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 4) {
      double a[2][2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[i][0] = As[(wm + 16 * i + g) * AS + kk + t];
        a[i][1] = As[(wm + 16 * i + g + 8) * AS + kk + t];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(kk + t) * BS + wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[i][j], a[i][0], a[i][1], b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        if (c < N) C[r * N + c] = acc[i][j][2 * h];
        if (c + 1 < N) C[r * N + c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

int launch(const double* A, const double* B, double* C, int M, int N, int K,
           cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(dmma_gemm_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(DSMEM));
  if (e != cudaSuccess) return e;
  dim3 grid((N + DBN - 1) / DBN, (M + DBM - 1) / DBM);
  dmma_gemm_kernel<<<grid, DNT, DSMEM, stream>>>(A, B, C, M, N, K);
  return cudaGetLastError();
}

int launch(const float* A, const float* B, float* C, int M, int N, int K, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<float><<<grid, NT, 0, stream>>>(A, B, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpeps_corner_apply_f64(const double* M2, const double* P, double* Y, int n, int m,
                           void* stream) {
  return launch(M2, P, Y, n, m, n, static_cast<cudaStream_t>(stream));
}

int tpeps_corner_apply_f32(const float* M2, const float* P, float* Y, int n, int m,
                           void* stream) {
  return launch(M2, P, Y, n, m, n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
