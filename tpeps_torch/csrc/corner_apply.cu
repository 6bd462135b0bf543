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
//
// Design (f32): 3xTF32 on the tensor cores.  Y has to keep float32's
// accuracy whatever PyTorch's TF32 settings say, and the card's FP32 CUDA
// cores (67 TFLOP/s, 0.228 ms for the 15.3 GFLOP at D=7, chi=147) are far
// below its TF32 tensor cores (495 TFLOP/s).  Each operand is split, hi =
// tf32(x) and lo = tf32(x - hi) (round to nearest, ties away, as
// cvt.rna.tf32.f32, here in two integer operations), and Y = A_hi B_hi +
// A_hi B_lo + A_lo B_hi (float32 sums); the dropped A_lo B_lo is ~2^-22
// relative.  The bound is then 3 x 15.3 GFLOP at 495 TFLOP/s, 0.093 ms (M2
// read once, 207 MB, 0.062 ms).  Only wgmma reaches that rate (mma.sync
// m16n8k8 tf32 in the same frame ran at 0.51-0.55 ms on the H100), and
// wgmma takes a tf32 B only K-major from shared memory: a first launch
// splits P (4.2 MB) into the hi and lo planes of P^T, laid out as the
// product's stages hold them (a stage's planes one contiguous run: one bulk
// copy, cp.async.bulk on an mbarrier; P's planes came by 16-byte cp.async
// at first, 0.10 ms more), and the product takes A, M2, from registers,
// split where its fragment is loaded.  A block of two warpgroups computes a
// 128-row panel across one column tile as wide as m (32 NTW columns, up to
// 192; wider m takes several), so M2 is streamed once; a 3-stage ring of
// 32-deep slabs (M2's rows by 16-byte cp.async when lda is a multiple of 4
// and M2 16-byte aligned, by 8 bytes when even, else by 4); per k8 step
// and 32-column chunk three wgmma m64n32k8, one k8 step's wgmmas in flight
// while the next step's A is split.  The tensor core adds products into
// its accumulator with truncation, so a long k run in one accumulator
// drifts toward zero (2.6e-5 relative at n = 7203): each slab is summed
// from zero (wgmma's scale-d) and then added to the running sum by a
// rounded FADD (1e-6).  Split-K and the ordered last-arriver sum as in the
// f64 path.  Where a block's sum comes out inf or NaN (an inf or NaN in its
// inputs makes a lo part NaN), its warp recomputes those outputs over its
// k range in plain FP32 FMAs from device memory: inf and NaN come out where
// the twin's do.  0.225 ms at D=7, chi=147 in CUDA graphs on the H100
// (torch.matmul in float32, TF32 off: 0.446); the slabs' copies alone take
// 0.125 ms, the splits and wgmmas alone 0.172.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// parts left out for a timing breakdown, never in the library:
// chip_smoke.py --ablate builds copies with -DTPEPS_ABLATE=<bits>,
// 1 the async copies, 2 the DMMAs (f32: the wgmmas and the splits), 4 the
// split-K reduction; f32 only: 8 one TF32 product (A_hi B_hi, no lo
// parts), 16 no slab sums (every product into one running sum), 32 no split
// of P (the planes left as they are)
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

constexpr int BK = 16;

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

// ---- f32: 3xTF32 on wgmma m64n32k8 --------------------------------------
// A block of two warpgroups computes a 128-row panel of Y across a column
// tile of BN = 32 NTW columns; warpgroup h takes rows 64 h .. 64 h + 63.
// M2's slab (128 rows x 32 k) comes by cp.async into a padded tile (pitch
// 4 mod 32 floats), each warp loads its 16 rows of a k8 step with
// ldmatrix and splits them in registers (the wgmma A fragment is mma.sync
// m16n8k8's: a[q] = A(g + 8 (q % 2), t + 4 (q / 2)), g = lane / 4, t = lane
// % 4).  The slab's P^T planes come in one bulk copy: per plane and k8 step
// BN rows x 32 bytes in the 32-byte swizzle, the B of wgmma m64n32k8 (one
// per 32-column chunk).  D: d[4 i + 2 h + e] = D(g + 8 h, 8 i + 2 t + e) of
// the warp's 16 rows.
constexpr int FBK = 32, KB8 = FBK / 8, F_STAGES = 3, FAS = FBK + 4, F_BM = 128;

template <int NTW>
struct F2 {
  static constexpr int BN = 32 * NTW;                     // columns of a block tile
  static constexpr int SUB = BN * 32;                     // bytes of a k8 step of a plane
  static constexpr int PLANE = KB8 * SUB;                 // bytes of a slab of a plane
  static constexpr int STAGE = 2 * PLANE + F_BM * FAS * 4;  // hi, lo, M2's slab
  static constexpr size_t SMEM = F_STAGES * STAGE + 1024;  // + the 1024-byte alignment
};

// x rounded to tf32, to nearest with ties away: half the dropped 13 bits'
// unit added to the magnitude, then dropped (cvt.rna.tf32.f32's result for
// every finite x, in two integer operations)
__device__ __forceinline__ uint32_t tf32_rna(uint32_t x) { return (x + 0x1000u) & 0xffffe000u; }

// x as tf32 hi + lo, each rounded to nearest with ties away
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)));  // x - hi exact
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// a copy of AV floats (4, 2 or 1) of which `valid` are read, the rest zero-filled
template <int AV>
__device__ __forceinline__ void cp_f32(float* dst, const float* src, int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (AV == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(4 * valid));
  else if constexpr (AV == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(4 * valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(4 * valid));
}

// M2's slab (F_BM rows from row0, FBK from k0) into As by copies of AV
// floats, zero past M and K
template <int AV>
__device__ __forceinline__ void copy_m2(float* As, const float* __restrict__ A, int64_t lda,
                                        int64_t row0, int M, int K, int k0, int tid) {
#pragma unroll
  for (int e = tid; e < F_BM * FBK / AV; e += K2NT) {
    const int r = e / (FBK / AV), c = AV * (e % (FBK / AV));
    const int64_t gr = row0 + r;
    const int nv = gr < M ? max(0, min(AV, K - (k0 + c))) : 0;
    cp_f32<AV>(As + r * FAS + c, nv ? A + gr * lda + k0 + c : A, nv);
  }
}

// wgmma descriptor of a K-major tile of 32-byte rows in the 32-byte swizzle
// (layout type 3): 8-row groups 256 bytes apart
__device__ __forceinline__ uint64_t desc32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 32) = a (64 x 8, registers) b (8 x 32, K-major in shared memory)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// keeps the compiler from reading the sums before the wait
template <int NTW>
__device__ __forceinline__ void fence_regs(float (&d)[NTW][16]) {
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// keeps A fragments in their registers until the wgmmas reading them are
// waited for (the compiler does not know they are read asynchronously)
__device__ __forceinline__ void fence_regs(uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(h[q]), "+r"(l[q])::"memory");
}

// P (k x m, row-major) into P^T's hi and lo planes, hi = tf32_rna(P[k][c]),
// lo = tf32_rna(P[k][c] - hi), laid out as the product's stages hold them:
// for column tile ct and slab sl, [plane][k8 step][row r of the tile][the
// step's 8 k in 32 bytes, the 16-byte halves swizzled by (r / 4) % 2], so a
// stage's planes are one contiguous run; zero past k and m.  32 x 32 tiles
// through shared memory, 32 x 8 threads.
__global__ void __launch_bounds__(256)
split_p_kernel(const float* __restrict__ P, float* __restrict__ planes, int K, int N, int bn,
               int nsl) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 8 * i, c = c0 + tx;
    tile[ty + 8 * i][tx] = k < K && c < N ? P[static_cast<int64_t>(k) * N + c] : 0.0f;
  }
  __syncthreads();
  const int k = k0 + tx, sl = k / FBK, kb = (k % FBK) / 8, w = k % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i, ct = c / bn, r = c % bn;
    uint32_t hi, lo;
    split_tf32(__float_as_uint(tile[tx][ty + 8 * i]), hi, lo);
    const int64_t at = ((static_cast<int64_t>(ct) * nsl + sl) * 2 * KB8 + kb) * bn * 8 + r * 8 +
                       (((w / 4) ^ ((r >> 2) & 1)) << 2) + w % 4;
    planes[at] = __uint_as_float(hi);
    planes[at + static_cast<int64_t>(KB8) * bn * 8] = __uint_as_float(lo);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// the copy of `bytes` contiguous bytes into shared memory, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// waits for the phase of the given parity; a lost arrival traps (a launch
// error) after ~2^35 cycles instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 35)) __trap();
  }
}

// one k8 step of a slab in stage st: this warp's 16 rows of A (rows wr ..)
// split in registers, then the three products into every 32-column chunk
// (the slab's first product from zero), committed as one group
template <int NTW>
__device__ __forceinline__ void tf32_step(const unsigned char* st, int kb, int wr, int lane,
                                          float (&dsl)[NTW][16], uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  using S = F2<NTW>;
  const float* As = reinterpret_cast<const float*>(st + 2 * S::PLANE);
  uint32_t raw[4];
  ldmatrix_x4(raw, As + (wr + lane % 8 + 8 * ((lane / 8) % 2)) * FAS + 8 * kb + 4 * (lane / 16));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (TPEPS_ABLATE & 8) {
      ah[q] = tf32_rna(raw[q]);
      al[q] = 0u;
    } else {
      split_tf32(raw[q], ah[q], al[q]);
    }
  }
  const uint32_t sb = static_cast<uint32_t>(__cvta_generic_to_shared(st)) + kb * S::SUB;
  const int first = kb > 0 || (TPEPS_ABLATE & 16) ? 1 : 0;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const uint64_t dh = desc32(sb + j * 1024), dl = desc32(sb + S::PLANE + j * 1024);
    if (TPEPS_ABLATE & 8) {
      wgmma_tf32(dsl[j], ah, dh, first);
    } else {
      wgmma_tf32(dsl[j], al, dh, first);
      wgmma_tf32(dsl[j], ah, dl, 1);
      wgmma_tf32(dsl[j], ah, dh, 1);
    }
  }
  wgmma_commit();
}

// lg_av: log2 of the floats of an M2 copy (2: 16 bytes, 1: 8, 0: 4), by
// M2's alignment and pitch (one instance for all three, branching once a
// slab: three instances made corner_apply.cu the library's longest compile,
// 45 s)
template <int NTW>
__global__ void __launch_bounds__(K2NT, 1)
corner_tf32_kernel(const float* __restrict__ A, int64_t lda, int lg_av,
                   const float* __restrict__ P, const float* __restrict__ planes, int nsl,
                   float* __restrict__ C, float* __restrict__ part, int* __restrict__ counters,
                   int M, int N, int K, int kps) {
  using S = F2<NTW>;
  extern __shared__ unsigned char fraw[];
  __shared__ int is_last;
  __shared__ __align__(8) uint64_t full[F_STAGES];  // a stage's planes have landed
  // the stages on a 1024-byte boundary (the swizzle's pattern lies on
  // absolute shared addresses)
  const uint32_t raw_s = static_cast<uint32_t>(__cvta_generic_to_shared(fraw));
  unsigned char* fsm = fraw + ((1024u - raw_s % 1024u) % 1024u);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;  // the warp's 16 rows of the panel (warpgroup warp / 4)
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * F_BM;
  const int col0 = blockIdx.x * S::BN;
  const int nslabs = (K + FBK - 1) / FBK;
  const int sb0 = blockIdx.z * kps;
  const int ns = max(min(sb0 + kps, nslabs) - sb0, 0);

  constexpr bool kPlanes = !(TPEPS_ABLATE & 65);  // the planes are copied
  const uint32_t full0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < F_STAGES; ++i) mbar_init(full0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NTW][16], dsl[NTW][16];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[j][i] = dsl[j][i] = 0.0f;

  auto issue = [&](int s) {
    if (s < ns && !(TPEPS_ABLATE & 1)) {
      unsigned char* st = fsm + (s % F_STAGES) * S::STAGE;
      float* As = reinterpret_cast<float*>(st + 2 * S::PLANE);
      const int k0 = (sb0 + s) * FBK;
      // the slab's planes, one contiguous run (split_p_kernel's layout)
      if (kPlanes && tid == 0)
        bulk_load(static_cast<uint32_t>(__cvta_generic_to_shared(st)),
                  planes + (static_cast<int64_t>(blockIdx.x) * nsl + k0 / FBK) * (2 * S::PLANE / 4),
                  2 * S::PLANE, full0 + 8 * (s % F_STAGES));
      if (!(TPEPS_ABLATE & 128)) {
        if (lg_av == 2) copy_m2<4>(As, A, lda, row0, M, K, k0, tid);
        else if (lg_av == 1) copy_m2<2>(As, A, lda, row0, M, K, k0, tid);
        else copy_m2<1>(As, A, lda, row0, M, K, k0, tid);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) issue(s);
  for (int s = 0; s < ns; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(F_STAGES - 2) : "memory");
    if (kPlanes) mbar_wait(full0 + 8 * (s % F_STAGES), (s / F_STAGES) & 1);
    __syncthreads();  // slab s has landed; every product of slab s - 1 is done
    // the copies of a later slab go out now, into the stage of slab s - 1
    issue(s + F_STAGES - 1);
    if (TPEPS_ABLATE & 2) continue;
    const unsigned char* st = fsm + (s % F_STAGES) * S::STAGE;
    // A's fragments in two sets, one k8 step's products in flight while
    // the next step's fragments are split
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kb = 0; kb < KB8; ++kb) {
      if (kb >= 2) {
        wgmma_wait<1>();  // step kb - 2's products are done: its set is free
        fence_regs(ah[kb % 2], al[kb % 2]);
      }
      tf32_step<NTW>(st, kb, wr, lane, dsl, ah[kb % 2], al[kb % 2]);
    }
    wgmma_wait<0>();
    fence_regs(ah[0], al[0]);
    fence_regs(ah[1], al[1]);
    fence_regs<NTW>(dsl);
    // the slab's sum (its products truncated against its own magnitude),
    // added to the running sum rounded
    if (!(TPEPS_ABLATE & 16)) {
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[j][i] += dsl[j][i];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (TPEPS_ABLATE & 16) {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[j][i] = dsl[j][i];
  }

  // the output of acc[j][i]: row wr + g + 8 ((i / 2) % 2), column 32 j + 8 (i / 4) + 2 t + i % 2
  auto out_row = [&](int i) { return row0 + wr + g + 8 * ((i / 2) % 2); };
  auto out_col = [&](int j, int i) { return col0 + 32 * j + 8 * (i / 4) + 2 * t + i % 2; };
  // an inf or NaN in the sums (an inf or NaN in the inputs makes a lo part
  // NaN): the warp's outputs that are not finite, once stored, again over
  // this chunk's k in plain FP32 FMAs from device memory (IEEE inf and NaN,
  // as the twin), in a rolled loop over what was stored
  bool bad = false;
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) bad |= !isfinite(acc[j][i]);
  bad = __any_sync(0xffffffffu, bad) && !(TPEPS_ABLATE & 35);
  auto refine = [&](float* out, int64_t ld, int64_t base, int step) {
    const int k0 = sb0 * FBK, k1 = min((sb0 + ns) * FBK, K);
    for (int x = 0; x < NTW * 16; ++x) {
      const int j = x / 16, i = x % 16;
      const int64_t r = out_row(i);
      const int c = out_col(j, i);
      float* o = out + (ld ? r * ld + c : base + static_cast<int64_t>(x) * step);
      if (r >= M || c >= N || isfinite(*o)) continue;
      float v = 0.0f;
      for (int k = k0; k < k1; ++k) v = fmaf(A[r * lda + k], P[static_cast<int64_t>(k) * N + c], v);
      *o = v;
    }
  };

  const int splits = gridDim.z;
  if (splits > 1 && !(TPEPS_ABLATE & 4)) {
    // leave the partial tile in scratch (lane-contiguous), count the arrival
    constexpr int TILE = F_BM * S::BN;
    const size_t tile = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
                        blockIdx.x;
    const size_t tstride = static_cast<size_t>(gridDim.y) * gridDim.x * TILE;
    float* mine = part + tile * TILE + warp * (16 * NTW * 32) + lane;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[(j * 16 + i) * 32] = acc[j][i];
    if (bad) refine(mine, 0, 0, 32);
    __threadfence();
    __syncthreads();
    int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) is_last = atomicAdd(counter, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the last to arrive sums the chunks in chunk order, a chunk's loads
    // issued together
    const float* first = part + (tile - static_cast<size_t>(blockIdx.z) * gridDim.y * gridDim.x) *
                                    TILE + warp * (16 * NTW * 32) + lane;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[j][i] = 0.0f;
    for (int z = 0; z < splits; ++z) {
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[j][i] += __ldcg(first + z * tstride + (j * 16 + i) * 32);
    }
    if (tid == 0) *counter = 0;
    bad = false;  // the chunks' sums came out of refined partials
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int64_t r = out_row(i);
      const int c = out_col(j, i);
      if (r < M && c < N) C[r * N + c] = acc[j][i];
    }
  if (bad) refine(C, N, 0, 0);
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
  int64_t scratch;  // elements of partial tiles (0 without split-K)
  int err;
};

template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, K2NT, smem);
}

// blocks per SM of every instance of a width (the f64 kernel's two M2
// copy widths, or the f32 kernel), queried once per process (one card
// type)
template <int NTW, bool F32>
cudaError_t blocks_per_sm(int* per_sm) {
  static int cached = 0;
  if (cached > 0) {
    *per_sm = cached;
    return cudaSuccess;
  }
  int a = 0, b = 0, c = 1 << 30;
  cudaError_t e;
  if constexpr (F32) {
    e = prepare(corner_tf32_kernel<NTW>, F2<NTW>::SMEM, &a);
    b = a;
  } else {
    e = prepare(corner_dmma_kernel<NTW, true>, K2<NTW>::SMEM, &a);
    if (e == cudaSuccess) e = prepare(corner_dmma_kernel<NTW, false>, K2<NTW>::SMEM, &b);
  }
  *per_sm = a < b ? (a < c ? a : c) : (b < c ? b : c);
  if (e == cudaSuccess) cached = *per_sm;
  return e;
}

template <bool F32>
cudaError_t blocks_per_sm(int ntw, int* per_sm) {
  switch (ntw) {
    case 1: return blocks_per_sm<1, F32>(per_sm);
    case 2: return blocks_per_sm<2, F32>(per_sm);
    case 3: return blocks_per_sm<3, F32>(per_sm);
    case 4: return blocks_per_sm<4, F32>(per_sm);
    case 5: return blocks_per_sm<5, F32>(per_sm);
    default: return blocks_per_sm<6, F32>(per_sm);
  }
}

// rows of a block tile
int block_rows(bool f32) { return f32 ? F_BM : KBM; }

// the f32 kernel's P^T planes: columns (m padded to the column tiles) and
// slabs, and their floats (both planes)
struct Planes {
  int np, nsl;
  int64_t floats;
};
Planes planes(const K2Plan& p, int n) {
  Planes q;
  q.np = p.ct * 32 * p.ntw;
  q.nsl = (n + FBK - 1) / FBK;
  q.floats = 2 * static_cast<int64_t>(q.np) * q.nsl * FBK;
  return q;
}

// One column tile as wide as m needs (up to 192), the k range split into as
// many chunks (at most 8) as fill whole waves of the card's block slots.
template <bool F32>
K2Plan plan(int n, int m) {
  K2Plan p{};
  p.ntw = (m + 31) / 32;
  if (p.ntw > K2_MAX_NTW) p.ntw = K2_MAX_NTW;
  if (p.ntw < 1) p.ntw = 1;
  p.ct = (m + 32 * p.ntw - 1) / (32 * p.ntw);
  const int bm = block_rows(F32);
  p.rp = (n + bm - 1) / bm;
  int per_sm = 0;
  cudaError_t e = blocks_per_sm<F32>(p.ntw, &per_sm);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  p.err = static_cast<int>(e);
  if (e != cudaSuccess) return p;
  const int64_t slots = static_cast<int64_t>(per_sm) * num_sms();
  const int bk = F32 ? FBK : BK;
  const int nslabs = (n + bk - 1) / bk;
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
  p.scratch = p.splits > 1 ? static_cast<int64_t>(p.splits) * base * bm * 32 * p.ntw : 0;
  if (F32) p.scratch += planes(p, n).floats;  // the planes first, then the partial tiles
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

template <int NTW>
cudaError_t launch_ntw(const K2Plan& p, const float* A, int64_t lda, const float* B, float* C,
                       float* scratch, int* counters, int n, int m, cudaStream_t stream) {
  const Planes q = planes(p, n);
  float* part = scratch + q.floats;
  if (!(TPEPS_ABLATE & 32)) {
    split_p_kernel<<<dim3(q.nsl * FBK / 32, q.np / 32), 256, 0, stream>>>(B, scratch, n, m,
                                                                           32 * p.ntw, q.nsl);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.ct, p.rp, p.splits);
  const uintptr_t at = reinterpret_cast<uintptr_t>(A);
  const int lg_av = lda % 4 == 0 && at % 16 == 0 ? 2 : lda % 2 == 0 && at % 8 == 0 ? 1 : 0;
  corner_tf32_kernel<NTW><<<grid, K2NT, F2<NTW>::SMEM, stream>>>(
      A, lda, lg_av, B, scratch, q.nsl, C, part, counters, n, m, n, p.kps);
  return cudaGetLastError();
}

template <typename T>
int corner_apply(const T* M2, int64_t lda, const T* P, T* Y, T* part, int64_t part_len,
                 int* counters, int ncounters, int n, int m, void* stream) {
  if (n <= 0 || m <= 0) return cudaSuccess;
  const K2Plan p = plan<sizeof(T) == 4>(n, m);
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

template <bool F32>
int64_t scratch(int n, int m) {
  if (n <= 0 || m <= 0) return 0;
  const K2Plan p = plan<F32>(n, m);
  return p.err ? -static_cast<int64_t>(p.err) : p.scratch;
}

}  // namespace

extern "C" {

// elements of scratch that tpeps_corner_apply_f64 / _f32 need for (n, m); a
// CUDA error is returned negated
int64_t tpeps_corner_apply_scratch_f64(int n, int m) { return scratch<false>(n, m); }

int64_t tpeps_corner_apply_scratch_f32(int n, int m) { return scratch<true>(n, m); }

int tpeps_corner_apply_f64(const double* M2, int64_t lda, const double* P, double* Y,
                           double* part, int64_t part_len, int* counters, int ncounters, int n,
                           int m, void* stream) {
  return corner_apply(M2, lda, P, Y, part, part_len, counters, ncounters, n, m, stream);
}

int tpeps_corner_apply_f32(const float* M2, int64_t lda, const float* P, float* Y, float* part,
                           int64_t part_len, int* counters, int ncounters, int n, int m,
                           void* stream) {
  return corner_apply(M2, lda, P, Y, part, part_len, counters, ncounters, n, m, stream);
}

}  // extern "C"
