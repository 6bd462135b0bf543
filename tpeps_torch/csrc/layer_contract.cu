// Layer contraction: Y[p, n] (+)= sum_k W[p, k] * X[k, n] with X and Y
// addressed through arbitrary strides.
//
// Replaces the ket- and bra-layer contractions of the factored C4v move in
// tpeps/ctm/c4v/move_tpu.py: _c2x2_factored (:87-118, the enlarged corner)
// and _absorb_T_int (:154-182, the edge absorption).  There the on-site
// tensor a (or conj(a)) is contracted with a large environment tensor whose
// contracted indices are spread over 2-3 axes, and the result is written in
// the axis order the next step wants.
//
// What bounds it on an H100: W is small (at most d*D^2 x D^2 = 98 x 49 at
// D=7, 38 KB in f64) and X is large (chi^2 D^4 elements, 415-830 MB in f64).
// Each X element is read once and used for all P rows of W, so a block does
// 2*P*K flops per K+P elements moved: about 6-12 flop per byte in f64,
// below the balance point of the FP64 tensor cores (about 20 flop per
// byte), so device-memory traffic bounds it.  The cost to avoid is an extra
// pass over X or Y to materialise a transpose.
//
// Design.  Both paths stage W in shared memory (zero-padded), gather a tile
// of X through the caller's strides (consecutive threads take consecutive
// n, so the loads coalesce where n's innermost axis has unit stride in X),
// and write straight into the caller's output layout, so no transpose pass
// follows.  f64, the slice's dtype, runs on the FP64 tensor cores: mma.sync
// m16n8k4 on a persistent grid that stages W once per block (see
// layer_dmma_kernel).  f32 runs on the CUDA cores: each warp owns PB rows of
// W and each lane NPT columns n (lane + 32 j), so one broadcast read of W
// feeds NPT FMAs and one read of X feeds PB.  `accumulate` adds into Y
// instead of overwriting it (the loop over the physical index when the move
// slices it).
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by tpeps_torch/kernels/layer.py (_LayerGeom).  Unused axes have
// size 1 and stride 0.  Index multi-indices are row-major over their axes.
struct LayerGeom {
  int64_t K, P, N;
  int64_t kd[3], xk[3];         // k axes: sizes, strides in X
  int64_t pd[3], yp[3];         // p axes: sizes, strides in Y
  int64_t nd[4], xn[4], yn[4];  // n axes: sizes, strides in X and in Y
};

namespace {

constexpr int NT = 256;                 // threads per block (8 warps)
constexpr int PB = 8;                   // W rows per warp and chunk
constexpr int NPT = 4;                  // n columns per lane: lane + 32 j
constexpr int TN = 32 * NPT;            // n columns per block
constexpr size_t SMEM_TWO_BLOCKS = 110 * 1024;  // two blocks fit on one SM
constexpr size_t SMEM_MAX = 232448;

template <typename T>
__global__ void __launch_bounds__(NT)
layer_kernel(const T* __restrict__ W, const T* __restrict__ X, T* __restrict__ Y,
             LayerGeom g, int Ppad, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = static_cast<int>(g.K);
  const int P = static_cast<int>(g.P);
  int64_t* koff = reinterpret_cast<int64_t*>(smem);  // K offsets into X
  T* Ws = reinterpret_cast<T*>(koff + K);            // Ppad x K
  T* Xs = Ws + static_cast<size_t>(Ppad) * K;        // K x TN

  const int tid = threadIdx.x;
  const int64_t nbase = static_cast<int64_t>(blockIdx.x) * TN;
  for (int i = tid; i < Ppad * K; i += NT) {
    const int p = i / K;
    Ws[i] = p < P ? W[i] : T(0);
  }
  for (int k = tid; k < K; k += NT) {
    int64_t r = k, off = 0;
    for (int a = 2; a >= 0; --a) {
      off += (r % g.kd[a]) * g.xk[a];
      r /= g.kd[a];
    }
    koff[k] = off;
  }
  // gather: this thread loads column n = nbase + tid % TN of every k it owns
  {
    const int64_t n = nbase + tid % TN;
    int64_t xoff = 0, r = n;
    for (int a = 3; a >= 0; --a) {
      xoff += (r % g.nd[a]) * g.xn[a];
      r /= g.nd[a];
    }
    __syncthreads();
    for (int k = tid / TN; k < K; k += NT / TN)
      Xs[k * TN + tid % TN] = n < g.N ? X[koff[k] + xoff] : T(0);
  }
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32;
  int64_t yoff[NPT];
  bool valid[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int64_t n = nbase + lane + 32 * j;
    valid[j] = n < g.N;
    int64_t r = valid[j] ? n : 0, off = 0;
    for (int a = 3; a >= 0; --a) {
      off += (r % g.nd[a]) * g.yn[a];
      r /= g.nd[a];
    }
    yoff[j] = off;
  }
  for (int p0 = warp * PB; p0 < P; p0 += (NT / 32) * PB) {
    T acc[PB][NPT];
#pragma unroll
    for (int i = 0; i < PB; ++i)
#pragma unroll
      for (int j = 0; j < NPT; ++j) acc[i][j] = T(0);
    const T* w = Ws + static_cast<size_t>(p0) * K;
    for (int k = 0; k < K; ++k) {
      T x[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) x[j] = Xs[k * TN + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < PB; ++i) {
        const T wv = w[i * K + k];
#pragma unroll
        for (int j = 0; j < NPT; ++j) acc[i][j] = fma(wv, x[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < PB; ++i) {
      const int p = p0 + i;
      if (p >= P) break;
      int64_t r = p, poff = 0;
      for (int a = 2; a >= 0; --a) {
        poff += (r % g.pd[a]) * g.yp[a];
        r /= g.pd[a];
      }
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        if (!valid[j]) continue;
        T* y = Y + poff + yoff[j];
        *y = accumulate ? *y + acc[i][j] : acc[i][j];
      }
    }
  }
}

template <typename T>
size_t smem_bytes(const LayerGeom* g) {
  const int64_t Ppad = (g->P + PB - 1) / PB * PB;
  return g->K * sizeof(int64_t) + (Ppad * g->K + g->K * TN) * sizeof(T);
}

template <typename T>
int launch(const T* W, const T* X, T* Y, const LayerGeom* g, int accumulate,
           cudaStream_t stream) {
  if (g->N == 0) return cudaSuccess;
  const int Ppad = static_cast<int>((g->P + PB - 1) / PB * PB);
  const size_t smem = smem_bytes<T>(g);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int64_t blocks = (g->N + TN - 1) / TN;
  layer_kernel<T><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(W, X, Y, *g, Ppad,
                                                                        accumulate);
  return cudaGetLastError();
}

// ---- f64: DMMA (mma.sync m16n8k4) over a persistent grid ------------------
// W is the A operand (P x K, zero-padded to Ppad x Kpad, multiples of 16 and
// 4) and the gathered X tile the B operand (Kpad x DTN).  W and the output
// row offsets are staged once per block; the block then walks n tiles.
// Each warp item is one 16-row tile of W times 32 columns of the X tile
// (4 DMMA tiles of 16 x 8).  Row strides of the two slabs are 8 words mod
// 32, so a warp's fragment loads touch every bank exactly twice.
constexpr int DTN = 64;         // n columns per tile
constexpr int DXS = DTN + 4;    // row stride of the X tile (doubles)

__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

struct DmmaShape {
  int Ppad, Kpad, KS;
  size_t smem;
};

DmmaShape dmma_shape(const LayerGeom* g) {
  DmmaShape d;
  d.Ppad = static_cast<int>((g->P + 15) / 16 * 16);
  d.Kpad = static_cast<int>((g->K + 3) / 4 * 4);
  d.KS = d.Kpad + ((4 - d.Kpad % 16) + 16) % 16;  // KS = 4 (mod 16)
  d.smem = (static_cast<size_t>(d.Kpad) + d.Ppad + DTN) * sizeof(int64_t) +
           (static_cast<size_t>(d.Ppad) * d.KS + static_cast<size_t>(d.Kpad) * DXS) *
               sizeof(double);
  return d;
}

__global__ void __launch_bounds__(NT)
layer_dmma_kernel(const double* __restrict__ W, const double* __restrict__ X,
                  double* __restrict__ Y, LayerGeom g, DmmaShape d, int accumulate) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = static_cast<int>(g.K), P = static_cast<int>(g.P);
  int64_t* koff = reinterpret_cast<int64_t*>(smem);  // Kpad offsets into X
  int64_t* poff = koff + d.Kpad;                     // Ppad row offsets into Y
  int64_t* yoff = poff + d.Ppad;                     // DTN column offsets into Y
  double* Ws = reinterpret_cast<double*>(yoff + DTN);  // Ppad x KS
  double* Xs = Ws + static_cast<size_t>(d.Ppad) * d.KS;  // Kpad x DXS

  const int tid = threadIdx.x;
  for (int i = tid; i < d.Ppad * d.KS; i += NT) {
    const int p = i / d.KS, k = i % d.KS;
    Ws[i] = (p < P && k < K) ? W[static_cast<int64_t>(p) * K + k] : 0.0;
  }
  for (int k = tid; k < d.Kpad; k += NT) {
    int64_t r = k, off = 0;
    for (int a = 2; a >= 0; --a) {
      off += (r % g.kd[a]) * g.xk[a];
      r /= g.kd[a];
    }
    koff[k] = k < K ? off : 0;
  }
  for (int p = tid; p < d.Ppad; p += NT) {
    int64_t r = p, off = 0;
    for (int a = 2; a >= 0; --a) {
      off += (r % g.pd[a]) * g.yp[a];
      r /= g.pd[a];
    }
    poff[p] = off;
  }

  const int lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int items = (d.Ppad / 16) * (DTN / 32);
  const int nl = tid % DTN;
  const int64_t ntiles = (g.N + DTN - 1) / DTN;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t nbase = tile * DTN;
    const int64_t n = nbase + nl;
    int64_t xo = 0, yo = 0;
    {
      int64_t r = n < g.N ? n : 0;
      for (int a = 3; a >= 0; --a) {
        const int64_t idx = r % g.nd[a];
        r /= g.nd[a];
        xo += idx * g.xn[a];
        yo += idx * g.yn[a];
      }
    }
    __syncthreads();  // staging above, or the previous tile's readers, are done
    if (tid < DTN) yoff[tid] = yo;
    for (int k = tid / DTN; k < d.Kpad; k += NT / DTN)
      Xs[k * DXS + nl] = (k < K && n < g.N) ? X[koff[k] + xo] : 0.0;
    __syncthreads();
    for (int item = warp; item < items; item += NT / 32) {
      const int mt = item / (DTN / 32), n0 = (item % (DTN / 32)) * 32;
      double acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.0;
      const double* wa = Ws + (mt * 16 + gq) * d.KS + t;
      const double* xb = Xs + t * DXS + n0 + gq;
      for (int k0 = 0; k0 < d.Kpad; k0 += 4) {
        const double a0 = wa[k0], a1 = wa[8 * d.KS + k0];
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc[j], a0, a1, xb[k0 * DXS + 8 * j]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + gq + 8 * h;
        if (p >= P) continue;
        const int64_t po = poff[p];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 8 * j + 2 * t + e;
            if (nbase + c >= g.N) continue;
            double* y = Y + po + yoff[c];
            *y = accumulate ? *y + acc[j][2 * h + e] : acc[j][2 * h + e];
          }
      }
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

int launch_dmma(const double* W, const double* X, double* Y, const LayerGeom* g,
                int accumulate, cudaStream_t stream) {
  if (g->N == 0) return cudaSuccess;
  const DmmaShape d = dmma_shape(g);
  if (d.smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      layer_dmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(d.smem));
  if (e != cudaSuccess) return e;
  const int per_sm = d.smem <= SMEM_TWO_BLOCKS ? 2 : 1;
  const int64_t ntiles = (g->N + DTN - 1) / DTN;
  int64_t blocks = static_cast<int64_t>(per_sm) * num_sms();
  if (blocks > ntiles) blocks = ntiles;
  layer_dmma_kernel<<<static_cast<unsigned>(blocks), NT, d.smem, stream>>>(W, X, Y, *g, d,
                                                                          accumulate);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tpeps_layer_contract_f64(const double* W, const double* X, double* Y, const LayerGeom* g,
                             int accumulate, void* stream) {
  return launch_dmma(W, X, Y, g, accumulate, static_cast<cudaStream_t>(stream));
}

int tpeps_layer_contract_f32(const float* W, const float* X, float* Y, const LayerGeom* g,
                             int accumulate, void* stream) {
  return launch<float>(W, X, Y, g, accumulate, static_cast<cudaStream_t>(stream));
}

const char* tpeps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
