// Corner apply: Y = M2 @ P for the enlarged corner M2 (n x n, row-major
// with a leading dimension lda >= n) and a tall basis P (n x m, row-major),
// n = chi*D^2, m = chi (or chi + 8).
//
// Replaces tpeps/ctm/c4v/move_tpu.py:_m_apply (:121-130), which applies the
// factored corner M6[f,g,e,r,j,i] to P and transposes the result from
// (f,e,j) to (j,e,f) rows.  Here the corner arrives already as the matrix
// M2[(j,e,f),(i,r,g)] (the fused double layer writes it in that order), so
// the product reads plain strides and no transpose follows.
//
// What bounds it on an H100: 2*n^2*m flops (15.3 GFLOP at D=7, chi=147,
// 0.228 ms at 67 TFLOP/s) over n^2 elements of M2 read once (415 MB in f64,
// 0.124 ms of HBM): the f64 arithmetic rate bounds it, not memory.
//
// Design (f64).  wgmma has no f64 form, so the FP64 tensor cores are
// reached through mma.sync (DMMA, m16n8k4; the shape is TPEPS_K2_MMA_K:
// k8 and k16, the same fragments in fewer instructions, measured 5-7%
// slower).  A block computes a 32 WM-row panel of Y
// across one column tile of BN = 32 NTW columns, NTW chosen per call so
// that one tile covers m (160 for m = 147-160, 192 up to 192; wider m takes
// several tiles), so M2 is streamed from device memory exactly once and P
// comes from L2, once per panel: the taller the panel, the less of P a
// flop reads.  8 warps of (16 WM) x (8 NTW), WM = 4: 128 x 160 block tiles,
// 20 DMMA tiles a warp (80 accumulators, 4 + 5 fragments of 2 and 1 values
// per k4 step), one block per SM (64-row tiles at two blocks per SM spilled
// at 128 registers; at one block they were 12% slower).  k is walked in
// 16-deep slabs through a 4-stage cp.async ring: M2's rows by 16-byte
// cp.async.cg when lda is even and M2 16-byte aligned (the move pads lda),
// else by 8 bytes; P's rows are 8-byte aligned only (m is odd).  The
// copies of a later slab are issued after the DMMAs of this one.  Slab
// pitches are 4 mod 32 (M2) and 8 mod 32 (P) doubles, so fragment loads
// touch every bank twice, the least for 8-byte words.  n = 7203 gives 57
// panels, too few for 132 SMs: the k range is split (split-K) into as many
// chunks (at most 8) as fill whole waves best (2 at n = 7203: 114 blocks);
// each block leaves its partial tile in scratch, and the last of a panel to
// arrive (an integer counter per panel, reset by that block) reads the
// chunks back in chunk order, sums them and writes Y: the same bits every
// call, no atomics on data, no host synchronisation, nothing allocated
// (the wrapper passes the scratch), so it captures into a CUDA graph.  What
// holds it at 0.62 ms on the H100 (chip_smoke.py --ablate): the slabs'
// copies (0.32 ms alone, P read from L2 57 times) and the DMMAs (0.38 ms
// alone) overlap little.  Edges are masked: n, m and lda need not be
// multiples of any tile.
// f32 keeps the first version: a shared-memory tiled GEMM on the CUDA cores,
// 256 threads each holding a 4 x 4 register tile (never TF32).
#include <cuda_runtime.h>
#include <stdint.h>

// parts left out for a timing breakdown, never in the library:
// chip_smoke.py --ablate builds copies with -DTPEPS_ABLATE=<bits>,
// 1 the async copies, 2 the DMMAs, 4 the split-K reduction
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif
#ifndef TPEPS_K2_MMA_K
#define TPEPS_K2_MMA_K 4
#endif
#ifndef TPEPS_K2_WM  // DMMA row tiles per warp: block tiles of 32 WM rows
#define TPEPS_K2_WM 4
#endif
#ifndef TPEPS_K2_STAGES
#define TPEPS_K2_STAGES 4
#endif

namespace {

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
gemm_kernel(const T* __restrict__ A, int64_t lda, const T* __restrict__ B, T* __restrict__ C,
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
      As[c][r] = (gr < M && gc < K) ? A[gr * lda + gc] : T(0);
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

// ---- f64: DMMA over a 64 x 32 NTW block tile, split-K ---------------------
// Fragments of m16n8kK f64 (K = 4, 8, 16), with g = lane / 4, t = lane % 4:
//   a[q] = A(g + 8 (q % 2), t + 4 (q / 2)), q < K / 2;  b[q] = B(t + 4 q, g), q < K / 4;
//   c[2h + e] = C(g + 8 h, 2 t + e).
constexpr int K2NT = 256, K2STAGES = TPEPS_K2_STAGES, AS = BK + 4;  // M2 slab pitch: 4 mod 32
constexpr int WM = TPEPS_K2_WM, KBM = 32 * WM;  // 2 x 4 warps of (16 WM) x (8 NTW)
constexpr int MK = TPEPS_K2_MMA_K;
constexpr int K2_MAX_NTW = 6;
constexpr int K2_MAX_SPLITS = 8;
static_assert(MK == 4 || MK == 8 || MK == 16, "TPEPS_K2_MMA_K is 4, 8 or 16");

template <int NTW>
struct K2 {
  static constexpr int BN = 32 * NTW;       // columns of a block tile
  static constexpr int BS = BN + 8;         // P slab pitch: 8 mod 32
  static constexpr int SLAB = KBM * AS + BK * BS;
  static constexpr size_t SMEM = K2STAGES * SLAB * sizeof(double);
};

__device__ __forceinline__ void mma(double (&c)[4], const double* a, const double* b) {
  if constexpr (MK == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
        "{%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (MK == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

__device__ __forceinline__ void cp8(double* dst, const double* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}

// 16-byte copy of `bytes` (0, 8 or 16) valid bytes, the rest zero-filled
__device__ __forceinline__ void cp16(double* dst, const double* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

template <int NTW, bool A16>
__global__ void __launch_bounds__(K2NT, 1)
corner_dmma_kernel(const double* __restrict__ A, int64_t lda, const double* __restrict__ B,
                   double* __restrict__ C, double* __restrict__ part, int* __restrict__ counters,
                   int M, int N, int K, int kps) {
  using S = K2<NTW>;
  extern __shared__ __align__(16) double dsm[];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 16 * WM, wn = (warp % 4) * 8 * NTW;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * KBM;
  const int col0 = blockIdx.x * S::BN;
  const int nslabs = (K + BK - 1) / BK;
  const int sb0 = blockIdx.z * kps;
  const int ns = max(min(sb0 + kps, nslabs) - sb0, 0);

  double acc[WM][NTW][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;

  auto issue = [&](int s) {
    if (s < ns && !(TPEPS_ABLATE & 1)) {
      double* As = dsm + (s % K2STAGES) * S::SLAB;
      double* Bs = As + KBM * AS;
      const int k0 = (sb0 + s) * BK;
      if constexpr (A16) {
#pragma unroll
        for (int e = tid; e < KBM * BK / 2; e += K2NT) {
          const int r = e / (BK / 2), c = 2 * (e % (BK / 2));
          const int64_t gr = row0 + r;
          const int nv = gr < M ? max(0, min(2, K - (k0 + c))) : 0;
          cp16(As + r * AS + c, nv ? A + gr * lda + k0 + c : A, 8 * nv);
        }
      } else {
#pragma unroll
        for (int e = tid; e < KBM * BK; e += K2NT) {
          const int r = e / BK, c = e % BK;
          const int64_t gr = row0 + r;
          const bool ok = gr < M && k0 + c < K;
          cp8(As + r * AS + c, ok ? A + gr * lda + k0 + c : A, ok);
        }
      }
#pragma unroll 2
      for (int e = tid; e < BK * S::BN; e += K2NT) {
        const int r = e / S::BN, c = e % S::BN;
        const bool ok = k0 + r < K && col0 + c < N;
        cp8(Bs + r * S::BS + c, ok ? B + static_cast<int64_t>(k0 + r) * N + col0 + c : B, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < K2STAGES - 1; ++s) issue(s);
  for (int s = 0; s < ns; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(K2STAGES - 2) : "memory");
    __syncthreads();  // slab s has landed; the stage of slab s - 1 is free
    if (TPEPS_ABLATE & 2) {
      issue(s + K2STAGES - 1);
      continue;
    }
    const double* As = dsm + (s % K2STAGES) * S::SLAB;
    const double* Bs = As + KBM * AS;
#pragma unroll
    for (int kb = 0; kb < BK; kb += MK) {
      double a[WM][MK / 2];
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int q = 0; q < MK / 2; ++q)
          a[i][q] = As[(wm + 16 * i + g + 8 * (q % 2)) * AS + kb + t + 4 * (q / 2)];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        double b[MK / 4];
#pragma unroll
        for (int q = 0; q < MK / 4; ++q) b[q] = Bs[(kb + t + 4 * q) * S::BS + wn + 8 * j + g];
#pragma unroll
        for (int i = 0; i < WM; ++i) mma(acc[i][j], a[i], b);
      }
    }
    // the copies of a later slab go out while this slab's DMMAs run (issued
    // before them: 1% slower)
    issue(s + K2STAGES - 1);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const int splits = gridDim.z;
  if (splits > 1 && !(TPEPS_ABLATE & 4)) {
    // leave the partial tile in scratch (lane-contiguous), count the arrival
    const size_t tile = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
                        blockIdx.x;
    const size_t tstride = static_cast<size_t>(gridDim.y) * gridDim.x * KBM * S::BN;
    double* mine = part + tile * KBM * S::BN + warp * (4 * WM * NTW * 32) + lane;
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) mine[((i * NTW + j) * 4 + q) * 32] = acc[i][j][q];
    __threadfence();
    __syncthreads();
    int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the last to arrive sums the chunks in chunk order, its own read back
    // like the others' (its registers stay free)
    const double* first = part + (tile - static_cast<size_t>(blockIdx.z) * gridDim.y * gridDim.x) *
                                     KBM * S::BN + warp * (4 * WM * NTW * 32) + lane;
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int idx = ((i * NTW + j) * 4 + q) * 32;
          double v = 0.0;
          for (int z = 0; z < splits; ++z) v += __ldcg(first + z * tstride + idx);
          acc[i][j][q] = v;
        }
    if (tid == 0) *counter = 0;
  }
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int c = col0 + wn + 8 * j + 2 * t;
        if (c < N) C[r * N + c] = acc[i][j][2 * h];
        if (c + 1 < N) C[r * N + c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

int num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

struct K2Plan {
  int ntw, ct, rp, splits, kps;
  int64_t scratch;  // doubles of partial tiles (0 without split-K)
  int err;
};

template <int NTW, bool A16>
cudaError_t prepare(int* per_sm) {
  auto kern = corner_dmma_kernel<NTW, A16>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(K2<NTW>::SMEM));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, K2NT, K2<NTW>::SMEM);
}

// blocks per SM of both instances, queried once per process (one card type)
template <int NTW>
cudaError_t blocks_per_sm(int* per_sm) {
  static int cached = 0;
  if (cached > 0) {
    *per_sm = cached;
    return cudaSuccess;
  }
  int a = 0, b = 0;
  cudaError_t e = prepare<NTW, true>(&a);
  if (e == cudaSuccess) e = prepare<NTW, false>(&b);
  *per_sm = a < b ? a : b;
  if (e == cudaSuccess) cached = *per_sm;
  return e;
}

// One column tile as wide as m needs (up to 192), the k range split into as
// many chunks (at most 8) as fill whole waves of the card's block slots.
K2Plan plan(int n, int m) {
  K2Plan p{};
  p.ntw = (m + 31) / 32;
  if (p.ntw > K2_MAX_NTW) p.ntw = K2_MAX_NTW;
  if (p.ntw < 1) p.ntw = 1;
  p.ct = (m + 32 * p.ntw - 1) / (32 * p.ntw);
  p.rp = (n + KBM - 1) / KBM;
  int per_sm = 0;
  cudaError_t e = cudaSuccess;
  switch (p.ntw) {
    case 1: e = blocks_per_sm<1>(&per_sm); break;
    case 2: e = blocks_per_sm<2>(&per_sm); break;
    case 3: e = blocks_per_sm<3>(&per_sm); break;
    case 4: e = blocks_per_sm<4>(&per_sm); break;
    case 5: e = blocks_per_sm<5>(&per_sm); break;
    default: e = blocks_per_sm<6>(&per_sm); break;
  }
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  p.err = static_cast<int>(e);
  if (e != cudaSuccess) return p;
  const int64_t slots = static_cast<int64_t>(per_sm) * num_sms();
  const int nslabs = (n + BK - 1) / BK;
  const int64_t base = static_cast<int64_t>(p.rp) * p.ct;
  double best = -1.0;
  p.splits = 1;
  for (int s = 1; s <= K2_MAX_SPLITS && s <= nslabs; ++s) {
    const int64_t blocks = base * s;
    const int64_t waves = (blocks + slots - 1) / slots;
    const double eff = static_cast<double>(blocks) / static_cast<double>(waves * slots);
    if (eff > best + 0.03) {  // a split must pay for its reduction
      best = eff;
      p.splits = s;
    }
  }
  p.kps = (nslabs + p.splits - 1) / p.splits;
  p.splits = (nslabs + p.kps - 1) / p.kps;  // no empty chunk
  p.scratch = p.splits > 1 ? static_cast<int64_t>(p.splits) * base * KBM * 32 * p.ntw : 0;
  return p;
}

template <int NTW>
cudaError_t launch_ntw(const K2Plan& p, const double* A, int64_t lda, const double* B, double* C,
                       double* part, int* counters, int n, int m, cudaStream_t stream) {
  const dim3 grid(p.ct, p.rp, p.splits);
  const bool a16 = lda % 2 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  if (a16)
    corner_dmma_kernel<NTW, true><<<grid, K2NT, K2<NTW>::SMEM, stream>>>(
        A, lda, B, C, part, counters, n, m, n, p.kps);
  else
    corner_dmma_kernel<NTW, false><<<grid, K2NT, K2<NTW>::SMEM, stream>>>(
        A, lda, B, C, part, counters, n, m, n, p.kps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// doubles of scratch that tpeps_corner_apply_f64 needs for (n, m); a CUDA
// error is returned negated
int64_t tpeps_corner_apply_scratch_f64(int n, int m) {
  if (n <= 0 || m <= 0) return 0;
  const K2Plan p = plan(n, m);
  return p.err ? -static_cast<int64_t>(p.err) : p.scratch;
}

int tpeps_corner_apply_f64(const double* M2, int64_t lda, const double* P, double* Y,
                           double* part, int64_t part_len, int* counters, int ncounters, int n,
                           int m, void* stream) {
  if (n <= 0 || m <= 0) return cudaSuccess;
  const K2Plan p = plan(n, m);
  if (p.err) return p.err;
  if (p.scratch > part_len || static_cast<int64_t>(p.rp) * p.ct > ncounters || lda < n)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.ntw) {
    case 1: return launch_ntw<1>(p, M2, lda, P, Y, part, counters, n, m, s);
    case 2: return launch_ntw<2>(p, M2, lda, P, Y, part, counters, n, m, s);
    case 3: return launch_ntw<3>(p, M2, lda, P, Y, part, counters, n, m, s);
    case 4: return launch_ntw<4>(p, M2, lda, P, Y, part, counters, n, m, s);
    case 5: return launch_ntw<5>(p, M2, lda, P, Y, part, counters, n, m, s);
    default: return launch_ntw<6>(p, M2, lda, P, Y, part, counters, n, m, s);
  }
}

int tpeps_corner_apply_f32(const float* M2, int64_t lda, const float* P, float* Y, int n, int m,
                           void* stream) {
  if (n <= 0 || m <= 0) return cudaSuccess;
  if (lda < n) return cudaErrorInvalidValue;
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  gemm_kernel<float><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(M2, lda, P, Y, n, m, n);
  return cudaGetLastError();
}

}  // extern "C"
