// K8: the block-sparse tensordot of charge-conserving (abelian) tensors.
//
// Replaces tpeps/sym/tensor.py:AbelianTensor.tensordot (:342-488), whose
// batched branch (:435-478) groups the charge-matched block pairs by
// (shape_a, shape_b), runs one vmapped dot_general per group, applies the
// fermionic signs and segment-sums the products of each output charge.  Here
// a tensordot is two kinds of launch over tables that the host builds once
// per block structure (tpeps_torch/sym/tensor.py) and keeps on the card:
//
// block_permute: copies every block of a tensor through a table of
//   (src offset, dst offset, shape, src strides, dst strides, scale), one
//   element per thread, rank <= MAXR.  It puts a tensordot's operands in
//   (kept legs, contracted legs) order, transposes tensors, gathers a tensor
//   into per-charge-sector matrices and scatters isometry columns back into
//   blocks.  The scale is +-1 (fermionic signs), so the copy is bit-exact.
//
// block_gemm: for each output block o (m x n, row-major at its offset), the
//   sum over its pairs p of sign_p * A_p (m x k_p) @ B_p (k_p x n), written
//   once.  A thread block owns one tile of one output block and walks that
//   block's pair list in order, so the segment-sum is a longer K reduction
//   kept in registers: no atomics, the result does not depend on the order in
//   which blocks run.  Two tile kinds, chosen per output block by the host:
//   kind 1, a 64 x 64 tile for blocks of at least 16 x 16 (f64 on the FP64
//   tensor cores through mma.sync m16n8k4, 4 warps of 32 x 32; f32 on the
//   CUDA cores), K walked in 16-deep slabs staged in shared memory; kind 0,
//   128 consecutive elements of a small block, one per thread, each a dot
//   product read straight from memory (a 1 x 2 block is not padded to a
//   64 x 64 tile).
//   A launch may read either operand transposed (trans_a: each A_p stored
//   k x m; trans_b: each B_p stored n x k): only the slab loads' indexing
//   changes.  The backward of a tensordot is two such launches on tables the
//   host derives from the forward one (tpeps_torch/kernels/blocksparse.py):
//   dA = sum_p s_p G_o B_p^T grouped by A block, dB = sum_p s_p A_p^T G_o
//   grouped by B block, each output block again written once.
//
// What bounds it on an H100: at D=8, chi=160 one CTMRG move's ten
// tensordots do ~4.7 GFLOP over ~1.6 GB of operands and results, so memory
// (0.46 ms) rather than FP64 (0.07 ms) bounds the function.  This first
// version reads each operand block once per output tile, stages slabs
// without a pipeline and keeps tiny-k problems in 16-deep slabs: right and
// simple first; PERF.md has its times against the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAXR = 12;   // largest block rank block_permute takes
constexpr int PNT = 256;   // block_permute threads per block
constexpr int PGRID_MAX = 132 * 16;

template <typename T>
__global__ void __launch_bounds__(PNT)
block_permute_kernel(const T* __restrict__ src, T* __restrict__ dst,
                     const int64_t* __restrict__ ecum, const int64_t* __restrict__ soff,
                     const int64_t* __restrict__ doff, const int32_t* __restrict__ shape,
                     const int64_t* __restrict__ sstr, const int64_t* __restrict__ dstr,
                     const double* __restrict__ scale, int nblk, int rank) {
  const int64_t total = ecum[nblk];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * PNT;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * PNT + threadIdx.x; e < total;
       e += stride) {
    // the table entry holding element e: the last b with ecum[b] <= e
    int lo = 0, hi = nblk - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (ecum[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const int b = lo;
    int64_t loc = e - ecum[b];
    int64_t s = soff[b], d = doff[b];
    const int64_t base = static_cast<int64_t>(b) * rank;
    for (int r = rank - 1; r >= 0; --r) {
      const int64_t n = shape[base + r];
      const int64_t i = loc % n;
      loc /= n;
      s += i * sstr[base + r];
      d += i * dstr[base + r];
    }
    T v = src[s];
    if (scale != nullptr) v = static_cast<T>(scale[b]) * v;
    dst[d] = v;
  }
}

template <typename T>
int permute_launch(const T* src, T* dst, const int64_t* ecum, const int64_t* soff,
                   const int64_t* doff, const int32_t* shape, const int64_t* sstr,
                   const int64_t* dstr, const double* scale, int nblk, int rank,
                   int64_t total, cudaStream_t stream) {
  if (nblk <= 0 || total <= 0) return cudaSuccess;
  if (rank < 1 || rank > MAXR) return cudaErrorInvalidValue;
  int64_t g = (total + PNT - 1) / PNT;
  const int grid = static_cast<int>(g < PGRID_MAX ? g : PGRID_MAX);
  block_permute_kernel<T><<<grid, PNT, 0, stream>>>(src, dst, ecum, soff, doff, shape, sstr,
                                                     dstr, scale, nblk, rank);
  return cudaGetLastError();
}

// ---- block_gemm ------------------------------------------------------------
constexpr int GNT = 128;            // threads per tile, both kinds
constexpr int TBM = 64, TBN = 64, TBK = 16;
constexpr int AS = TBK + 4;         // row stride of the A slab (elements)
constexpr int BS = TBN + 4;         // row stride of the B slab

// Fragments of m16n8k4 f64, g = lane / 4, t = lane % 4:
//   A (16 x 4, row): a0 = A[g][t], a1 = A[g + 8][t];  B (4 x 8, col): b0 = B[t][g];
//   C (16 x 8): c0, c1 = C[g][2t], C[g][2t + 1];  c2, c3 = C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

struct GemmTables {
  const int64_t* ob_off;  // output block offsets
  const int32_t* ob_m;
  const int32_t* ob_n;
  const int32_t* ob_ptr;  // CSR: pairs of output block o are [ob_ptr[o], ob_ptr[o + 1])
  const int64_t* pr_a;    // A block offset of each pair
  const int64_t* pr_b;    // B block offset
  const int32_t* pr_k;    // contracted extent
  const int32_t* pr_s;    // sign, +1 or -1
  const int32_t* tiles;   // (o, kind, r0, c0) per tile
  int ta;                 // A_p stored k x m (transposed)
  int tb;                 // B_p stored n x k (transposed)
};

// Stage the slab k0..k0+TBK of one pair's A rows row0.. and B columns col0..
// A transposed operand is walked along its stored rows, so that neighbouring
// threads read neighbouring addresses in both layouts.
template <typename T>
__device__ __forceinline__ void stage_slab(T* As, T* Bs, const T* __restrict__ A,
                                           const T* __restrict__ B, T sgn, int m, int n, int k,
                                           int row0, int col0, int k0, int tid, int ta, int tb) {
  if (!ta) {
#pragma unroll 4
    for (int e = tid; e < TBM * TBK; e += GNT) {
      const int r = e / TBK, c = e % TBK;
      const int gr = row0 + r, gc = k0 + c;
      As[r * AS + c] = (gr < m && gc < k) ? sgn * A[static_cast<int64_t>(gr) * k + gc] : T(0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < TBM * TBK; e += GNT) {
      const int r = e % TBM, c = e / TBM;
      const int gr = row0 + r, gc = k0 + c;
      As[r * AS + c] = (gr < m && gc < k) ? sgn * A[static_cast<int64_t>(gc) * m + gr] : T(0);
    }
  }
  if (!tb) {
#pragma unroll 4
    for (int e = tid; e < TBK * TBN; e += GNT) {
      const int r = e / TBN, c = e % TBN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r * BS + c] = (gr < k && gc < n) ? B[static_cast<int64_t>(gr) * n + gc] : T(0);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < TBK * TBN; e += GNT) {
      const int r = e % TBK, c = e / TBK;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r * BS + c] = (gr < k && gc < n) ? B[static_cast<int64_t>(gc) * k + gr] : T(0);
    }
  }
}

template <typename T>
__device__ void big_tile(const T* __restrict__ Abuf, const T* __restrict__ Bbuf,
                         T* __restrict__ Cbuf, const GemmTables& tb, int o, int row0, int col0,
                         T* As, T* Bs) {
  const int tid = threadIdx.x;
  const int m = tb.ob_m[o], n = tb.ob_n[o];
  const int p0 = tb.ob_ptr[o], p1 = tb.ob_ptr[o + 1];
  T* C = Cbuf + tb.ob_off[o];
  if constexpr (std::is_same<T, double>::value) {
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    double acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
    for (int p = p0; p < p1; ++p) {
      const double* A = Abuf + tb.pr_a[p];
      const double* B = Bbuf + tb.pr_b[p];
      const int k = tb.pr_k[p];
      const double sgn = static_cast<double>(tb.pr_s[p]);
      for (int k0 = 0; k0 < k; k0 += TBK) {
        stage_slab<double>(As, Bs, A, B, sgn, m, n, k, row0, col0, k0, tid, tb.ta, tb.tb);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TBK; kk += 4) {
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
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + 16 * i + g + 8 * h;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col0 + wn + 8 * j + 2 * t;
          if (c < n) C[static_cast<int64_t>(r) * n + c] = acc[i][j][2 * h];
          if (c + 1 < n) C[static_cast<int64_t>(r) * n + c + 1] = acc[i][j][2 * h + 1];
        }
      }
  } else {
    // f32: each thread a 4 x 8 register tile, rows 4*ty.., columns tx + 8*j
    const int tx = tid % 8, ty = tid / 8;
    T acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
    for (int p = p0; p < p1; ++p) {
      const T* A = Abuf + tb.pr_a[p];
      const T* B = Bbuf + tb.pr_b[p];
      const int k = tb.pr_k[p];
      const T sgn = static_cast<T>(tb.pr_s[p]);
      for (int k0 = 0; k0 < k; k0 += TBK) {
        stage_slab<T>(As, Bs, A, B, sgn, m, n, k, row0, col0, k0, tid, tb.ta, tb.tb);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TBK; ++kk) {
          T a[4], b[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[(4 * ty + i) * AS + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = Bs[kk * BS + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * ty + i;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + tx + 8 * j;
        if (c < n) C[static_cast<int64_t>(r) * n + c] = acc[i][j];
      }
    }
  }
}

template <typename T>
__device__ void small_tile(const T* __restrict__ Abuf, const T* __restrict__ Bbuf,
                           T* __restrict__ Cbuf, const GemmTables& tb, int o, int e0) {
  const int m = tb.ob_m[o], n = tb.ob_n[o];
  const int64_t e = static_cast<int64_t>(e0) + threadIdx.x;
  if (e >= static_cast<int64_t>(m) * n) return;
  const int i = static_cast<int>(e / n), j = static_cast<int>(e % n);
  T acc = T(0);
  for (int p = tb.ob_ptr[o]; p < tb.ob_ptr[o + 1]; ++p) {
    const int k = tb.pr_k[p];
    // element (i, kk) of A_p and (kk, j) of B_p: a stride of 1 or m along kk
    // in A, of n or 1 in B
    const int64_t sa = tb.ta ? m : 1, sb = tb.tb ? 1 : n;
    const T* A = Abuf + tb.pr_a[p] + static_cast<int64_t>(i) * (tb.ta ? 1 : k);
    const T* B = Bbuf + tb.pr_b[p] + static_cast<int64_t>(j) * (tb.tb ? k : 1);
    const T sgn = static_cast<T>(tb.pr_s[p]);
    for (int kk = 0; kk < k; ++kk) acc += (sgn * A[kk * sa]) * B[kk * sb];
  }
  Cbuf[tb.ob_off[o] + e] = acc;
}

template <typename T>
__global__ void __launch_bounds__(GNT)
block_gemm_kernel(const T* __restrict__ Abuf, const T* __restrict__ Bbuf, T* __restrict__ Cbuf,
                  GemmTables tb) {
  __shared__ T As[TBM * AS];
  __shared__ T Bs[TBK * BS];
  const int4 tile = reinterpret_cast<const int4*>(tb.tiles)[blockIdx.x];
  if (tile.y == 1) {
    big_tile<T>(Abuf, Bbuf, Cbuf, tb, tile.x, tile.z, tile.w, As, Bs);
  } else {
    small_tile<T>(Abuf, Bbuf, Cbuf, tb, tile.x, tile.z);
  }
}

template <typename T>
int gemm_launch(const T* A, const T* B, T* C, const GemmTables& tb, int ntiles,
                cudaStream_t stream) {
  if (ntiles <= 0) return cudaSuccess;
  block_gemm_kernel<T><<<ntiles, GNT, 0, stream>>>(A, B, C, tb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpeps_block_permute_max_rank(void) { return MAXR; }

int tpeps_block_permute_f64(const double* src, double* dst, const int64_t* ecum,
                            const int64_t* soff, const int64_t* doff, const int32_t* shape,
                            const int64_t* sstr, const int64_t* dstr, const double* scale,
                            int nblk, int rank, int64_t total, void* stream) {
  return permute_launch<double>(src, dst, ecum, soff, doff, shape, sstr, dstr, scale, nblk,
                                rank, total, static_cast<cudaStream_t>(stream));
}

int tpeps_block_permute_f32(const float* src, float* dst, const int64_t* ecum,
                            const int64_t* soff, const int64_t* doff, const int32_t* shape,
                            const int64_t* sstr, const int64_t* dstr, const double* scale,
                            int nblk, int rank, int64_t total, void* stream) {
  return permute_launch<float>(src, dst, ecum, soff, doff, shape, sstr, dstr, scale, nblk, rank,
                               total, static_cast<cudaStream_t>(stream));
}

int tpeps_block_gemm_f64(const double* A, const double* B, double* C, const int64_t* ob_off,
                         const int32_t* ob_m, const int32_t* ob_n, const int32_t* ob_ptr,
                         const int64_t* pr_a, const int64_t* pr_b, const int32_t* pr_k,
                         const int32_t* pr_s, const int32_t* tiles, int ntiles, int trans_a,
                         int trans_b, void* stream) {
  const GemmTables tb{ob_off, ob_m, ob_n, ob_ptr, pr_a, pr_b, pr_k, pr_s, tiles, trans_a, trans_b};
  return gemm_launch<double>(A, B, C, tb, ntiles, static_cast<cudaStream_t>(stream));
}

int tpeps_block_gemm_f32(const float* A, const float* B, float* C, const int64_t* ob_off,
                         const int32_t* ob_m, const int32_t* ob_n, const int32_t* ob_ptr,
                         const int64_t* pr_a, const int64_t* pr_b, const int32_t* pr_k,
                         const int32_t* pr_s, const int32_t* tiles, int ntiles, int trans_a,
                         int trans_b, void* stream) {
  const GemmTables tb{ob_off, ob_m, ob_n, ob_ptr, pr_a, pr_b, pr_k, pr_s, tiles, trans_a, trans_b};
  return gemm_launch<float>(A, B, C, tb, ntiles, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
