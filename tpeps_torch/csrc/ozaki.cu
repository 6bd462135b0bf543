// K7: the Ozaki-scheme float64 matrix product on the int8 tensor cores.
//
// Replaces tpeps/linalg/ozaki.py: _split_int8 (:39-81) and _accumulate
// (:92-131), the pieces of ozaki_matmul / ozaki_presplit /
// ozaki_dot_general that backs dot_impl="ozaki[:s]" of the factored C4v
// move (tpeps/ctm/c4v/move_tpu.py:36-72, :205-224).
//
//   ozaki_split: for each row of the "row view" of an f64 matrix (the rows
//     of a left operand A (m, k), the columns of a right operand B (k, n)),
//     mx = max |x| (1 where 0), ex = floor(log2(mx)) + 1, e = 2^ex, and the
//     w-bit digits of |x| 2^-ex, most significant first, read in fixed point
//     28 // w digits (one int32 word) at a time, each times sign(x).  It
//     writes s int8 planes of (rows, kp), kp = k rounded up to 32 with zero
//     digits (exact: a zero digit adds nothing to any product), and e.  A's
//     planes are A's own rows, row-major (m, kp); B's are its columns,
//     (n, kp), which is the "col" operand layout of the IMMA below.
//   ozaki_gemm: for each total t = p + q in [2, s + 1], the group sum
//     sum_{p} A_p B_{t-p}^T as int8 x int8 -> int32 products on the tensor
//     cores (mma.sync m16n8k32 .s8.s8.s32, no .satfinite: int32 wraps as
//     XLA's int32 dot does); then, per element, the recombination in
//     _accumulate's order and precision: groups with t w >= 42 chained in
//     float32 (tail = tail 2^((t - t_prev) w) + float(acc_t)), the others
//     added to a float64 sum as acc_t 2^(-t w) from t = s + 1 down, the f32
//     tail added last, and the sum times e_A[row] e_B[col].  Every rounding
//     step is an explicit _rn intrinsic, so nvcc's FMA contraction cannot
//     change it.  The int32 group sums live in registers only.
//
// What bounds it on an H100.  ozaki_gemm does s(s+1)/2 int8 products:
// 36 x 2mnk operations at s = 8 (the corner apply, 7203 x 7232 by 7232 x 147:
// 548 G int8 operations, 0.28 ms at 1979 TOP/s, against 15.3 GFLOP, 0.23 ms,
// of the same product in FP64 on the DMMA tensor cores), reading s kp-byte
// digit rows per row and column.  The layer products (m = 49, n ~ 1.06M,
// k = 49 -> 64) read and write more bytes than they compute: memory-bound.
// ozaki_split is memory-bound: 8 bytes read, s bytes written per element.
//
// Design (simple first).  ozaki_split fuses the reduction with the digit
// pass: a warp owns a row of A (two passes over the row, the second from
// L1/L2), a block of 32 x 8 threads owns 32 columns of B and transposes its
// digits through shared memory so that each plane row is written as whole
// 32-byte runs.  ozaki_gemm: a 64 x 64 output tile per block of 8 warps
// (warp tile 32 x 16: 2 x 2 mma tiles), all s digit planes of the A and B
// tiles of one 32-deep k step staged in shared memory by cp.async (two
// stages, rows padded to 48 bytes so the fragment loads hit 32 banks).  Each
// warp holds B's fragments of all planes, walks A's planes once, and
// accumulates each pair into its group's int32 registers (s groups of 16).
// No wgmma/TMA yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_S = 8;
constexpr int SNT = 256;        // threads of a split block
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GNT = 256;        // threads of a gemm block: 8 warps, 2 (m) x 4 (n)
constexpr int ROWB = 48;        // shared bytes per staged tile row (32 + 16 pad)
constexpr int TAIL_BITS = 42;   // groups with t w >= 42 recombine in float32

// max that propagates NaN (as jnp.max does)
__device__ __forceinline__ double nanmax(double a, double b) { return (a > b || a != a) ? a : b; }

// the s signed w-bit digits of x 2^-ex (inv = 2^-ex), as _split_int8 forms
// them; digits beyond s are not written
__device__ __forceinline__ void digits(double x, double inv, int s, int w, int8_t* d) {
  const double r = x * inv;
  const int sgn = r < 0.0 ? -1 : 1;
  double rem = fabs(r);
  const int dpw = 28 / w > 1 ? 28 / w : 1;  // digits per int32 word
  const int wb = dpw * w;
  const double word_scale = ldexp(1.0, wb);
  const int mask = (1 << w) - 1;
  int u = 0;
#pragma unroll
  for (int c = 0; c < MAX_S; ++c) {
    if (c < s) {
      const int j = c % dpw;
      if (j == 0) {
        const double y = rem * word_scale;  // exact: a power-of-two shift
        u = __double2int_rz(y);             // y in [0, 2^wb)
        rem = __dsub_rn(y, static_cast<double>(u));
      }
      d[c] = static_cast<int8_t>(((u >> (wb - (j + 1) * w)) & mask) * sgn);
    }
  }
}

// the power-of-two exponent of a row's max |x|, as floor(log2(mx)) + 1
__device__ __forceinline__ double row_exponent(double mx) {
  if (mx == 0.0) mx = 1.0;
  return floor(log2(mx)) + 1.0;
}

// rows of a row-major (m, k) matrix: one warp per row
__global__ void __launch_bounds__(SNT)
split_rows(const double* __restrict__ X, int8_t* __restrict__ planes, double* __restrict__ e,
           int64_t m, int k, int kp, int s, int w) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (SNT / 32) + threadIdx.x / 32;
  if (row >= m) return;
  const double* x = X + row * k;
  double mx = 0.0;
  for (int c = lane; c < k; c += 32) mx = nanmax(mx, fabs(x[c]));
  for (int o = 16; o > 0; o >>= 1) mx = nanmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const double ex = row_exponent(mx);
  if (lane == 0) e[row] = exp2(ex);
  const double inv = exp2(-ex);
  const int64_t plane = m * kp;
  int8_t* out = planes + row * kp;
  for (int c0 = 4 * lane; c0 < kp; c0 += 128) {
    uint32_t word[MAX_S];
#pragma unroll
    for (int p = 0; p < MAX_S; ++p) word[p] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < k) {
        int8_t d[MAX_S];
        digits(x[c0 + j], inv, s, w, d);
#pragma unroll
        for (int p = 0; p < MAX_S; ++p)
          if (p < s) word[p] |= static_cast<uint32_t>(static_cast<uint8_t>(d[p])) << (8 * j);
      }
    }
#pragma unroll
    for (int p = 0; p < MAX_S; ++p)
      if (p < s) *reinterpret_cast<uint32_t*>(out + p * plane + c0) = word[p];
  }
}

// columns of a row-major (k, n) matrix: 32 columns per block, planes (n, kp)
__global__ void __launch_bounds__(SNT)
split_cols(const double* __restrict__ X, int8_t* __restrict__ planes, double* __restrict__ e,
           int k, int64_t n, int kp, int s, int w) {
  __shared__ double red[SNT / 32][32];
  __shared__ uint32_t tile[MAX_S][32][9];  // [plane][column][word of 4 digits], padded
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * 32 + tx;
  const bool in = col < n;
  double mx = 0.0;
  if (in)
    for (int r = ty; r < k; r += SNT / 32) mx = nanmax(mx, fabs(X[static_cast<int64_t>(r) * n + col]));
  red[ty][tx] = mx;
  __syncthreads();
  mx = red[0][tx];
  for (int j = 1; j < SNT / 32; ++j) mx = nanmax(mx, red[j][tx]);
  const double ex = row_exponent(mx);
  if (in && ty == 0) e[col] = exp2(ex);
  const double inv = exp2(-ex);
  const int64_t plane = n * kp;
  const int oc = threadIdx.x / 8, wd = threadIdx.x % 8;  // the word this thread writes
  const int64_t ocol = static_cast<int64_t>(blockIdx.x) * 32 + oc;
  for (int k0 = 0; k0 < kp; k0 += BK) {
    uint32_t word[MAX_S];
#pragma unroll
    for (int p = 0; p < MAX_S; ++p) word[p] = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = k0 + 4 * ty + j;
      if (in && r < k) {
        int8_t d[MAX_S];
        digits(X[static_cast<int64_t>(r) * n + col], inv, s, w, d);
#pragma unroll
        for (int p = 0; p < MAX_S; ++p)
          if (p < s) word[p] |= static_cast<uint32_t>(static_cast<uint8_t>(d[p])) << (8 * j);
      }
    }
#pragma unroll
    for (int p = 0; p < MAX_S; ++p)
      if (p < s) tile[p][tx][ty] = word[p];
    __syncthreads();
    if (ocol < n)
      for (int p = 0; p < s; ++p)
        *reinterpret_cast<uint32_t*>(planes + p * plane + ocol * kp + k0 + 4 * wd) = tile[p][oc][wd];
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int S>
constexpr int gemm_smem() { return 2 * S * (BM + BN) * ROWB; }

// stage the s planes of the A rows [m0, m0 + BM) and B rows [n0, n0 + BN)
// for the k step [k0, k0 + 32); rows past the edge are zero-filled
template <int S>
__device__ __forceinline__ void load_stage(unsigned char* sa, const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ B, int64_t m0, int64_t n0,
                                           int64_t m, int64_t n, int kp, int k0) {
  unsigned char* sb = sa + S * BM * ROWB;
  for (int i = threadIdx.x; i < S * BM * 2; i += GNT) {
    const int p = i / (2 * BM), r = (i / 2) % BM, h = i % 2;
    const int64_t row = m0 + r;
    const bool in = row < m;
    const int8_t* src = A + (p * m + (in ? row : 0)) * kp + k0 + 16 * h;
    cp_async16(sa + (p * BM + r) * ROWB + 16 * h, src, in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < S * BN * 2; i += GNT) {
    const int p = i / (2 * BN), r = (i / 2) % BN, h = i % 2;
    const int64_t row = n0 + r;
    const bool in = row < n;
    const int8_t* src = B + (p * n + (in ? row : 0)) * kp + k0 + 16 * h;
    cp_async16(sb + (p * BN + r) * ROWB + 16 * h, src, in ? 16 : 0);
  }
  cp_async_commit();
}

template <int S>
__global__ void __launch_bounds__(GNT)
ozaki_gemm_kernel(const int8_t* __restrict__ A, const double* __restrict__ ea,
                  const int8_t* __restrict__ B, const double* __restrict__ eb,
                  double* __restrict__ C, int64_t m, int64_t n, int kp, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGE = S * (BM + BN) * ROWB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows 32 wm, columns 16 wn
  const int g = lane / 4, t = lane % 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  int acc[S][2][2][4];  // [group t - 2][m tile][n tile][fragment]
#pragma unroll
  for (int q = 0; q < S; ++q)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[q][i / 8][(i / 4) % 2][i % 4] = 0;

  const int nk = kp / BK;
  load_stage<S>(smem, A, B, m0, n0, m, n, kp, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage<S>(smem + ((kt + 1) % 2) * STAGE, A, B, m0, n0, m, n, kp, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* sa = smem + (kt % 2) * STAGE;
    const unsigned char* sb = sa + S * BM * ROWB;
    uint32_t bf[S][2][2];  // B fragments of every plane: [plane][n tile][reg]
#pragma unroll
    for (int q = 0; q < S; ++q)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const unsigned char* b = sb + (q * BN + 16 * wn + 8 * nt + g) * ROWB + 4 * t;
        bf[q][nt][0] = lds32(b);
        bf[q][nt][1] = lds32(b + 16);
      }
#pragma unroll
    for (int p = 0; p < S; ++p) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned char* a = sa + (p * BM + 32 * wm + 16 * mt + g) * ROWB + 4 * t;
        af[mt][0] = lds32(a);
        af[mt][1] = lds32(a + 8 * ROWB);
        af[mt][2] = lds32(a + 16);
        af[mt][3] = lds32(a + 8 * ROWB + 16);
      }
      // pairs (p + 1, q + 1) with total p + q + 2 <= s + 1
#pragma unroll
      for (int q = 0; q < S - p; ++q)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_s8(acc[p + q][mt][nt], af[mt], bf[q][nt]);
    }
    __syncthreads();
  }

  // recombination in _accumulate's order (tpeps/linalg/ozaki.py:107-131)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = m0 + 32 * wm + 16 * mt + g + (i >= 2 ? 8 : 0);
        const int64_t col = n0 + 16 * wn + 8 * nt + 2 * t + (i % 2);
        double out = 0.0;
        float tail = 0.0f;
        int t_prev = 0;
#pragma unroll
        for (int tot = S + 1; tot >= 2; --tot) {
          const int a32 = acc[tot - 2][mt][nt][i];
          if (tot * w >= TAIL_BITS) {
            const float f = __int2float_rn(a32);
            tail = t_prev == 0 ? f : __fadd_rn(__fmul_rn(tail, ldexpf(1.0f, (tot - t_prev) * w)), f);
            t_prev = tot;
          } else {
            out = __dadd_rn(out, __dmul_rn(static_cast<double>(a32), ldexp(1.0, -tot * w)));
          }
        }
        if (t_prev != 0)
          out = __dadd_rn(out, __dmul_rn(static_cast<double>(tail), ldexp(1.0, -t_prev * w)));
        if (row < m && col < n) C[row * n + col] = __dmul_rn(__dmul_rn(out, ea[row]), eb[col]);
      }
}

template <int S>
int launch_gemm(const int8_t* A, const double* ea, const int8_t* B, const double* eb, double* C,
                int64_t m, int64_t n, int kp, int w, cudaStream_t stream) {
  constexpr int smem = gemm_smem<S>();
  static bool attr_set = false;  // set once, outside any later stream capture
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ozaki_gemm_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN), static_cast<unsigned>((m + BM - 1) / BM));
  ozaki_gemm_kernel<S><<<grid, GNT, smem, stream>>>(A, ea, B, eb, C, m, n, kp, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpeps_ozaki_max_slices(void) { return MAX_S; }

// axis 1: X (rows, k) row-major, one exponent per row; axis 0: X (k, rows)
// row-major, one exponent per column.  planes: (s, rows, kp) int8.
int tpeps_ozaki_split(const double* X, int8_t* planes, double* e, int64_t rows, int k, int kp,
                      int s, int w, int axis, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (s < 1 || s > MAX_S || w < 1 || w > 7 || kp % BK != 0 || kp < k) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    const int64_t blocks = (rows + SNT / 32 - 1) / (SNT / 32);
    split_rows<<<static_cast<unsigned>(blocks), SNT, 0, st>>>(X, planes, e, rows, k, kp, s, w);
  } else {
    const int64_t blocks = (rows + 31) / 32;
    split_cols<<<static_cast<unsigned>(blocks), SNT, 0, st>>>(X, planes, e, k, rows, kp, s, w);
  }
  return cudaGetLastError();
}

// C (m, n) f64 row-major from A's planes (s, m, kp) and B's (s, n, kp)
int tpeps_ozaki_gemm(const int8_t* A, const double* ea, const int8_t* B, const double* eb,
                     double* C, int64_t m, int64_t n, int kp, int s, int w, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (kp % BK != 0 || w < 1 || w > 7 || (n + BN - 1) / BN > 0x7fffffff || (m + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 1: return launch_gemm<1>(A, ea, B, eb, C, m, n, kp, w, st);
    case 2: return launch_gemm<2>(A, ea, B, eb, C, m, n, kp, w, st);
    case 3: return launch_gemm<3>(A, ea, B, eb, C, m, n, kp, w, st);
    case 4: return launch_gemm<4>(A, ea, B, eb, C, m, n, kp, w, st);
    case 5: return launch_gemm<5>(A, ea, B, eb, C, m, n, kp, w, st);
    case 6: return launch_gemm<6>(A, ea, B, eb, C, m, n, kp, w, st);
    case 7: return launch_gemm<7>(A, ea, B, eb, C, m, n, kp, w, st);
    case 8: return launch_gemm<8>(A, ea, B, eb, C, m, n, kp, w, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
