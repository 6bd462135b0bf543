// Fused double layer: both layers of the on-site tensor in one launch,
//   out[f,g,e,r,j,i] = sum_{s,v,m} conj(a)[s,v,m,f,g]
//                        sum_{u,l} a[s,u,l,e,r] X6[l,m,j,u,v,i]
// with X6 and out addressed through the caller's strides (real dtypes, so
// conj(a) is a).
//
// Replaces the ket and bra layers of the factored C4v move in
// tpeps/ctm/c4v/move_tpu.py: _c2x2_factored (:87-118, the enlarged corner,
// out = M2 in (j,e,f),(i,r,g) order) and _absorb_T_int (:154-182, the edge
// absorption, out = Z in (d,e,f),(r,g,p) order).
//
// What bounds it on an H100.  Per (j, i) column the function is two small
// products, a ket (d D^2 x D^2 by D^2 x D^2) and a bra (D^2 x d D^2 by
// d D^2 x D^2): 4 d D^6 flops, 20.3 GFLOP at D=7, chi=147, d=2 (0.30 ms on the
// FP64 tensor cores), over X in and out out (415 MB each in f64, 0.25 ms
// of HBM): bound by the FP64 operations, if the intermediate of the ket
// never reaches device memory.  Written as two launches (the design this
// replaces), the intermediate q[s,e,r,m,j,v,i] is twice X: 2.49 GB moved
// per pair, a floor of 0.74 ms.
//
// Design.  A block owns a tile of one j and TI = 4 consecutive i (the
// unit-stride axis of X at both call sites), all of (e,r) and (f,g).  It
// walks the tile's (m,v) index in slabs of 4: a slab of X, D^2 (u,l) x 4
// (m,v) x 4 i, arrives by cp.async in a ring of up to 8 slabs (its rows
// swizzled, not padded, so the ring is deeper), by 16 bytes where X's rows
// start 16-byte aligned (the move pads X's i axis to a multiple of 4: 8-byte
// copies of the same rows took 11% longer), else by 8; the ket product of
// the slab, Q^T[(mv,i), (s,e,r)] = X^T Wk^T (16 rows, one DMMA row tile),
// goes to shared memory as Q[s][mv][(e,r), i]; the bra product
// out^T[((e,r),i), (f,g)] += Q^T WbT then adds the slab's d x 4 (s,mv)
// terms to accumulators that stay in registers for the whole tile.  A warp
// owns MTW ket column tiles and MTW bra row tiles (4 (e,r) x 4 i each, by
// all (f,g)): at D=7, 13 tiles of each over 7 warps, two a warp, so one X
// fragment feeds two ket DMMAs and one Q fragment seven bra DMMAs twice
// over, and with two warps on each of the SM's four register files a
// thread may hold 255 registers (13 warps of one tile each are held to 128
// and spill).  The ket of slab k+1 and the bra of slab k run in the same
// step between two barriers.  A finished tile goes from the accumulators to
// a staging buffer in shared memory.  Where out's (i, r, g) runs are
// contiguous and 16-byte aligned (M2 and Z, their rows padded to an even
// pitch), the staging buffer holds those runs and the bulk-copy engine
// stores them, D^2 copies a tile, while the next tile computes; else the
// warps store it element by element during the next tile's steps, in the
// order of out's strides (30% slower; 8-byte stores straight from the
// fragments took twice as long).  X is read once, out written once, q
// never leaves the SM.  The grid is persistent (one block per SM walks the
// tiles, the ring runs on across tiles), so the weights are staged once
// per block.  f64 runs on the FP64 tensor cores, mma.sync m16n8k4 (49 pads
// to 52 in the ket's k; m16n8k8 pads to 56 and measured 3% slower); every
// other row pitch in shared memory is 8 mod 16 doubles, so a warp's
// fragment loads touch each bank twice, the least for 8-byte words.  f32
// runs the same tiling on FFMA: each lane computes the outputs a DMMA
// fragment would hold (never TF32).  What holds it at 1.04 ms on the H100
// (chip_smoke.py --ablate): the products alone take 0.81 (47% of the FP64
// peak on the padded work), and the loads add to them, since every warp
// copies its share of X between the same barriers.  The template is
// instantiated for D = 1..7 and takes d <= 2 (the ket's d D^2 columns fit
// the warps' column tiles).  Deterministic: every sum has a fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// parts left out for a timing breakdown, never in the library:
// chip_smoke.py --ablate builds copies with -DTPEPS_ABLATE=<bits>,
// 1 the loads of X, 2 the ket product, 4 the bra product, 8 the stores
#ifndef TPEPS_ABLATE
#define TPEPS_ABLATE 0
#endif

// Mirrored by tpeps_torch/kernels/layer.py (_DLGeom).
struct DLGeom {
  int64_t nj, ni;    // the free axes j and i
  int64_t xs[6];     // strides of X6 (l, m, j, u, v, i)
  int64_t os[6];     // strides of out (f, g, e, r, j, i)
  int32_t order[5];  // out's tile axes (0 f, 1 g, 2 e, 3 r, 4 i) by ascending stride
  int32_t d, D;      // physical and bond dimension
  int32_t vec;       // X's rows of i start 16-byte aligned: 16-byte copies
  int32_t bulk;      // out's (i, r, g) runs are contiguous and 16-byte aligned: bulk stores
};

#ifndef TPEPS_DL_MMA_K  // the f64 DMMA shape: m16n8k4 or m16n8k8
#define TPEPS_DL_MMA_K 4
#endif

namespace {

constexpr int TI = 4;  // consecutive i per tile
constexpr int MK = TPEPS_DL_MMA_K;
constexpr int MAX_D_PHYS = 2;  // Q and WbT always hold two physical slices (zero past d)
static_assert(MK == 4 || MK == 8, "TPEPS_DL_MMA_K is 4 or 8");
constexpr size_t SMEM_LIMIT = 232448 - 1024;  // dynamic shared memory; the rest: static tables

template <typename T, int D>
struct Plan {
  static constexpr int D2 = D * D;
  static constexpr int NMT = (D2 + 3) / 4;       // bra row tiles = ket column tiles at d=2
  // row and column tiles per warp: two above 8 tiles (at most 255
  // registers a thread with two warps on each of the SM's four register files)
  static constexpr int MTW = NMT > 8 ? 2 : 1;
  static constexpr int NW = (NMT + MTW - 1) / MTW;  // warps
  static constexpr int NT = 32 * NW;
  static constexpr int NSLAB = (D2 + 3) / 4;     // (m,v) slabs of 4
  // ket k steps over (u,l): of the DMMA's depth in f64, of 4 on FFMA
  static constexpr int KD = std::is_same<T, double>::value ? MK : 4;
  static constexpr int KSTEP = (D2 + KD - 1) / KD;
  static constexpr int KP = KD * KSTEP;          // (u,l) padded
  static constexpr int MVP = 4 * NSLAB;          // (m,v) padded
  static constexpr int NFG = (D2 + 7) / 8;       // bra column tiles over (f,g)
  static constexpr int WS = 8 * NFG + ((8 * NFG) % 16 == 0 ? 8 : 0);  // WbT pitch
  static constexpr int QS = 16 * NW * MTW + 8;   // Q pitch: rows ((e,r), i)
  static constexpr int XS = 16;                  // X slab pitch: rows ((m,v), i), swizzled
  static constexpr int KNS = 8 * NW * MTW + ((8 * NW * MTW) % 16 == 0 ? 8 : 0);  // Wk^T pitch
  // staging pitch of the element-by-element stores, 5 mod 16: the fragment
  // writes and the stores' reads, in either order of out, touch a bank at
  // most four times (twice the least)
  static constexpr int OSP = TI * D2 + ((5 - (TI * D2) % 16) + 16) % 16;
  static constexpr int OSZ = (D2 * OSP + 3) / 4 * 4;  // staging buffer (16-byte multiple)
  static constexpr int NOUT = D2 * D2 * TI;      // outputs of a tile
  static constexpr int CHUNKS = NSLAB > 1 ? NSLAB - 1 : 1;  // steps that drain a tile
};

// the X ring's depth: as deep as shared memory allows, at most 8 slabs
template <typename T, int D>
__host__ __device__ constexpr size_t fixed_words(int d) {
  using P = Plan<T, D>;
  return 2ull * P::MVP * P::WS + 2ull * 2 * 4 * P::QS +
         static_cast<size_t>(P::OSZ) +
         static_cast<size_t>(P::KP) * P::KNS;
}

template <typename T, int D>
__host__ __device__ constexpr int stages() {
  using P = Plan<T, D>;
  const size_t fixed = fixed_words<T, D>(MAX_D_PHYS) * sizeof(T);
  const size_t slab = static_cast<size_t>(P::KP) * P::XS * sizeof(T);
  const size_t fit = fixed + 2 * slab > SMEM_LIMIT ? 0 : (SMEM_LIMIT - fixed) / slab;
  return fit > 8 ? 8 : static_cast<int>(fit);
}

template <typename T, int D>
size_t smem_bytes(int d, int stages) {
  using P = Plan<T, D>;
  return (fixed_words<T, D>(MAX_D_PHYS) + static_cast<size_t>(stages) * P::KP * P::XS) *
         sizeof(T);
}

// c (16 x 8) += a (16 x K) b (K x 8), K = 4 or 8 (the size of a / 2); lane
// (g, t) holds a[q] = A(g + 8 (q % 2), t + 4 (q / 2)), b[q] = B(t + 4 q, g),
// c[2h + e] = C(g + 8 h, 2 t + e)
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[2], const double (&b)[1]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(ok ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(ok ? 4 : 0));
}

// 16-byte copy of `bytes` (0 to 16) valid bytes, the rest zero-filled
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// the staged tile's contiguous runs go to out by the bulk-copy engine
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(s),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the sources may be overwritten
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// order this thread's earlier shared-memory writes before the bulk copies' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// C-fragment coordinates shared by both dtypes: lane (g, t) holds
// c[2h + e] = C(g + 8h, 2t + e) of a 16 x 8 tile.
template <typename T, int D>
__global__ void __launch_bounds__(Plan<T, D>::NT, 1)
double_layer_kernel(const T* __restrict__ Wk, const T* __restrict__ WbT,
                    const T* __restrict__ X, T* __restrict__ out, DLGeom geo) {
  using P = Plan<T, D>;
  constexpr int STAGES = stages<T, D>();
  static_assert(STAGES >= 2, "the X ring needs two slabs of shared memory");
  constexpr int D2 = P::D2, NMT = P::NMT, MTW = P::MTW, NW = P::NW, NT = P::NT;
  constexpr int NSLAB = P::NSLAB, KSTEP = P::KSTEP;
  constexpr int KP = P::KP, MVP = P::MVP, NFG = P::NFG, WS = P::WS, QS = P::QS, XS = P::XS;
  constexpr int KNS = P::KNS, OSP = P::OSP, NOUT = P::NOUT, CHUNKS = P::CHUNKS;
  constexpr bool F64 = std::is_same<T, double>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = geo.d;
  constexpr int QB = MAX_D_PHYS * 4 * QS;              // one Q buffer
  T* Wbs = reinterpret_cast<T*>(smem);                // (s, mv) x (f,g), pitch WS, s < 2
  T* Qs = Wbs + MAX_D_PHYS * MVP * WS;                 // 2 x (s, mv) x ((e,r), i), pitch QS
  T* Os = Qs + 2 * QB;                                 // (f,g) x ((e,r), i), pitch OSP
  T* Wks = Os + P::OSZ;                                // (u,l) x (s,e,r), pitch KNS
  T* Xs = Wks + KP * KNS;                              // STAGES x (u,l) x ((m,v), i), pitch XS

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int64_t nq = (geo.ni + TI - 1) / TI;
  const int64_t ntiles = geo.nj * nq;
  const int64_t my_tiles = blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t nsteps = my_tiles * NSLAB;
  const int nker = d * D2;  // ket columns (s,e,r)
  // tile -> (j, first i): the blocks at work at one time hold neighbouring i
  // ranges of a few j (j first measured no faster)
  auto tile_coords = [&](int64_t tile, int64_t& j, int64_t& i0) {
    j = tile / nq;
    i0 = tile % nq * TI;
  };

  // stage the bra weights; zero Q (its padding is read)
  for (int i = tid; i < MAX_D_PHYS * MVP * WS; i += NT) {
    const int s = i / (MVP * WS), mv = (i / WS) % MVP, fg = i % WS;
    Wbs[i] = (s < d && mv < D2 && fg < D2)
                 ? WbT[(static_cast<int64_t>(s) * D2 + mv) * D2 + fg] : T(0);
  }
  for (int i = tid; i < 2 * QB; i += NT) Qs[i] = T(0);
  for (int i = tid; i < KP * KNS; i += NT) {
    const int k = i / KNS, n = i % KNS;
    Wks[i] = (n < nker && k < D2) ? Wk[static_cast<int64_t>(n) * D2 + k] : T(0);
  }

  // offsets into X of each (u,l) and (m,v); out's and the staging buffer's
  // strides of the tile axes in out's stride order (geo.order), and where i
  // is in it
  __shared__ int64_t xul[KP], xmv[MVP], gst[5];
  __shared__ int sst[5], ipos, sax[5];
  for (int i = tid; i < KP; i += NT) xul[i] = i < D2 ? (i % D) * geo.xs[0] + (i / D) * geo.xs[3] : 0;
  for (int i = tid; i < MVP; i += NT) xmv[i] = i < D2 ? (i / D) * geo.xs[1] + (i % D) * geo.xs[4] : 0;
  // the staging buffer's strides of (f, g, e, r, i): rows (f,g) of ((e,r),
  // i), or, for bulk stores, out's own (i, r, g) runs for each (e, f)
  if (tid < 5) {
    const int RP = TI * D2;
    sax[tid] = geo.bulk ? (tid == 0 ? RP : tid == 1 ? 1 : tid == 2 ? D * RP : tid == 3 ? D : D2)
                        : (tid == 0 ? D * OSP : tid == 1 ? OSP : tid == 2 ? D * TI : tid == 3 ? TI : 1);
  }
  __syncthreads();
  if (tid < 5) {
    const int ax = geo.order[tid];
    gst[tid] = geo.os[ax < 4 ? ax : 5];
    sst[tid] = sax[ax];
    if (ax == 4) ipos = tid;
  }
  __syncthreads();
  // the X entries this thread copies in every slab: e = tid + NT r over
  // (u,l) x (mv_l, i): ul = e / 16, mv_l = e / 4 % 4, ti = e % 4
  constexpr int PER = (KP * 16 + NT - 1) / NT;
  constexpr int VEC = 16 / sizeof(T), PERV = (KP * 16 / VEC + NT - 1) / NT;
  // the slab stream, one step a call: step -> (tile, slab) and its X slot
  int64_t iss_step = 0, iss_tile = blockIdx.x;
  int64_t iss_j, iss_i0;
  tile_coords(iss_tile, iss_j, iss_i0);
  int iss_slab = 0, iss_slot = 0;
  auto issue = [&]() {
    if (iss_step < nsteps && !(TPEPS_ABLATE & 1)) {
      const int64_t base = iss_j * geo.xs[2] + iss_i0 * geo.xs[5];
      T* dst = Xs + iss_slot * KP * XS;
      if (geo.vec) {  // a 16-byte copy of VEC consecutive i, zero past ni
#pragma unroll
        for (int r = 0; r < PERV; ++r) {
          const int e = tid + NT * r;
          if (e < KP * 16 / VEC) {
            const int ul = e / (16 / VEC), row = e % (16 / VEC) * VEC;
            const int mv = 4 * iss_slab + row / 4;
            const int64_t n = geo.ni - iss_i0 - row % 4;
            const int bytes = ul < D2 && mv < D2 ? (n >= VEC ? 16 : n > 0 ? int(n) * sizeof(T) : 0) : 0;
            const int64_t off = bytes ? base + xul[ul] + xmv[mv] + row % 4 : 0;
            cp_async16(dst + ul * XS + (row ^ (4 * (ul & 3))), X + off, bytes);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < PER; ++r) {
          const int e = tid + NT * r;
          if (e < KP * 16) {
            const int ul = e / 16, row = e % 16;
            const int mv = 4 * iss_slab + row / 4;
            const bool ok = ul < D2 && mv < D2 && iss_i0 + row % 4 < geo.ni;
            const int64_t off = ok ? base + xul[ul] + xmv[mv] + (row % 4) * geo.xs[5] : 0;
            cp_async(dst + ul * XS + (row ^ (4 * (ul & 3))), X + off, ok);
          }
        }
      }
    }
    cp_commit();
    ++iss_step;
    if (++iss_slot == STAGES) iss_slot = 0;
    if (++iss_slab == NSLAB) {
      iss_slab = 0;
      iss_tile += gridDim.x;
      tile_coords(iss_tile, iss_j, iss_i0);
    }
  };

  // store chunk c of the staged tile to out, element k in the order of
  // out's strides (smallest first), so consecutive threads write
  // neighbouring addresses
  auto drain = [&](int64_t j, int64_t i0, int c, int t0, int tn) {
    if (TPEPS_ABLATE & 8) return;
    T* o = out + j * geo.os[4] + i0 * geo.os[5];
    constexpr int PERC = (NOUT + CHUNKS - 1) / CHUNKS;
    const int k1 = min(NOUT, (c + 1) * PERC), ip = ipos;
    for (int k0 = c * PERC + t0; k0 < k1; k0 += 4 * tn) {
      T v[4];
      int64_t go[4];
      bool ok[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {  // four independent reads, then four stores
        const int k = k0 + x * tn;
        int r = k, so = 0, ii = 0;
        go[x] = 0;
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          int idx;
          if (q == ip) {
            idx = r % TI;
            r /= TI;
            ii = idx;
          } else {
            idx = r % D;
            r /= D;
          }
          so += idx * sst[q];
          go[x] += idx * gst[q];
        }
        ok[x] = k < k1 && i0 + ii < geo.ni;
        v[x] = ok[x] ? Os[so] : T(0);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (ok[x]) o[go[x]] = v[x];
    }
  };

  // the staged tile's D^2 runs (e, f), each TI D^2 contiguous values of
  // out along (i, r, g), one bulk copy a thread
  auto store_bulk = [&](int64_t j, int64_t i0) {
    if ((TPEPS_ABLATE & 8) || tid >= D2) return;
    const int e = tid / D, f = tid % D;
    bulk_store(out + f * geo.os[0] + e * geo.os[2] + j * geo.os[4] + i0 * geo.os[5],
               Os + (e * D + f) * TI * D2, TI * D2 * sizeof(T));
    bulk_commit();
  };

  T acc[MTW][NFG][4];
#pragma unroll
  for (int u = 0; u < MTW; ++u)
#pragma unroll
    for (int f = 0; f < NFG; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[u][f][q] = T(0);

  for (int s = 0; s < STAGES - 1; ++s) issue();

  int ket_slot = 0;                 // X slot of step it
  int bra_slab = 0;                 // slab of step it - 1
  int64_t bra_tile = blockIdx.x;    // tile of step it - 1
  int64_t st_j = -1, st_i0 = 0;     // the tile waiting in Os (st_j < 0: none)
  bool st_bulk = false;             // ... and whether it goes by bulk copies
  for (int64_t it = 0; it <= nsteps; ++it) {
    if (it < nsteps) cp_wait<STAGES - 2>();
    if (st_bulk && bra_slab == NSLAB - 1 && tid < D2) bulk_wait_read();  // Os is staged next
    __syncthreads();  // slab it has landed; Q[(it + 1) % 2], X slot (it - 1) and Os are free
    const int slab = bra_slab;
    issue();
    // ket of slab it: Q^T[(mv_l, i), (s,e,r)] for column tiles w + NW u
    const bool ket = it < nsteps && !(TPEPS_ABLATE & 2) && 8 * w < nker;
    T c[MTW][4];
#pragma unroll
    for (int u = 0; u < MTW; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[u][q] = T(0);
    if (ket) {
      const T* xs = Xs + ket_slot * KP * XS;
      if constexpr (F64) {
#pragma unroll
        for (int kk = 0; kk < KSTEP; ++kk) {
          // row (u,l) = MK kk + t4 + 4 p is t4 mod 4: its swizzle is 4 t4
          double a[MK / 2], b[MTW][MK / 4];
#pragma unroll
          for (int q = 0; q < MK / 2; ++q)
            a[q] = xs[(MK * kk + t4 + 4 * (q / 2)) * XS + ((gq + 8 * (q % 2)) ^ (4 * t4))];
#pragma unroll
          for (int u = 0; u < MTW; ++u)
#pragma unroll
            for (int q = 0; q < MK / 4; ++q)
              b[u][q] = Wks[(MK * kk + t4 + 4 * q) * KNS + 8 * (w + NW * u) + gq];
#pragma unroll
          for (int u = 0; u < MTW; ++u)
            if (8 * (w + NW * u) < nker) dmma(c[u], a, b[u]);
        }
      } else {
        const T* wk = Wks + 8 * w + 2 * t4;
        for (int k = 0; k < KP; ++k) {
          const float a0 = xs[k * XS + (gq ^ (4 * (k & 3)))];
          const float a1 = xs[k * XS + ((gq + 8) ^ (4 * (k & 3)))];
#pragma unroll
          for (int u = 0; u < MTW; ++u) {
            const float2 b = *reinterpret_cast<const float2*>(wk + k * KNS + 8 * NW * u);
            c[u][0] = fmaf(a0, b.x, c[u][0]);
            c[u][1] = fmaf(a0, b.y, c[u][1]);
            c[u][2] = fmaf(a1, b.x, c[u][2]);
            c[u][3] = fmaf(a1, b.y, c[u][3]);
          }
        }
      }
    }
    if (ket) {
      T* q = Qs + (it & 1) * QB;
#pragma unroll
      for (int u = 0; u < MTW; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * (w + NW * u) + 2 * t4 + e, row = gq + 8 * h;
            if (n < nker) {
              const int s = n / D2, er = n % D2;
              q[(s * 4 + row / 4) * QS + er * TI + row % 4] = c[u][2 * h + e];
            }
          }
    }
    // the previous tile's outputs, a share a step
    if (it >= 1 && st_j >= 0 && slab < CHUNKS) {
      if (!st_bulk) drain(st_j, st_i0, slab, tid, NT);
      else if (slab == 0) store_bulk(st_j, st_i0);
    }
    if (it >= 1) {
      // bra of slab it - 1: out^T[((e,r), i), (f,g)] += Q^T WbT, row tiles w + NW u
      if (!(TPEPS_ABLATE & 4)) {
        const T* q = Qs + ((it - 1) & 1) * QB + 16 * w;
        for (int s = 0; s < (F64 && MK == 8 ? 1 : d); ++s) {
          const T* wb = Wbs + (s * MVP + 4 * slab) * WS;
          if constexpr (F64 && MK == 8) {
            // one k8 step: k = (s, mv_l) = t4 + 4 p, p the physical slice
            double a[MTW][4];
#pragma unroll
            for (int u = 0; u < MTW; ++u)
#pragma unroll
              for (int qq = 0; qq < 4; ++qq)
                a[u][qq] = q[((qq / 2) * 4 + t4) * QS + 16 * NW * u + gq + 8 * (qq % 2)];
#pragma unroll
            for (int f = 0; f < NFG; ++f) {
              const double b[2] = {wb[t4 * WS + 8 * f + gq], wb[(MVP + t4) * WS + 8 * f + gq]};
#pragma unroll
              for (int u = 0; u < MTW; ++u)
                if (w + NW * u < NMT) dmma(acc[u][f], a[u], b);
            }
          } else if constexpr (F64) {
            double a[MTW][2];
#pragma unroll
            for (int u = 0; u < MTW; ++u) {
              a[u][0] = q[(s * 4 + t4) * QS + 16 * NW * u + gq];
              a[u][1] = q[(s * 4 + t4) * QS + 16 * NW * u + gq + 8];
            }
#pragma unroll
            for (int f = 0; f < NFG; ++f) {
              const double b[1] = {wb[t4 * WS + 8 * f + gq]};
#pragma unroll
              for (int u = 0; u < MTW; ++u)
                if (w + NW * u < NMT) dmma(acc[u][f], a[u], b);
            }
          } else {
            float a0[MTW][4], a1[MTW][4];
#pragma unroll
            for (int u = 0; u < MTW; ++u)
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                a0[u][k] = q[(s * 4 + k) * QS + 16 * NW * u + gq];
                a1[u][k] = q[(s * 4 + k) * QS + 16 * NW * u + gq + 8];
              }
#pragma unroll
            for (int f = 0; f < NFG; ++f)
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 b = *reinterpret_cast<const float2*>(wb + k * WS + 8 * f + 2 * t4);
#pragma unroll
                for (int u = 0; u < MTW; ++u) {
                  acc[u][f][0] = fmaf(a0[u][k], b.x, acc[u][f][0]);
                  acc[u][f][1] = fmaf(a0[u][k], b.y, acc[u][f][1]);
                  acc[u][f][2] = fmaf(a1[u][k], b.x, acc[u][f][2]);
                  acc[u][f][3] = fmaf(a1[u][k], b.y, acc[u][f][3]);
                }
              }
          }
        }
      }
    }
    if (it >= 1) {
      if (slab == NSLAB - 1) {  // the tile is complete: stage it and restart the sums
        if constexpr (NSLAB == 1) {  // this step also drained Os
          if (st_bulk && tid < D2) bulk_wait_read();
          __syncthreads();
        }
#pragma unroll
        for (int u = 0; u < MTW; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * (w + NW * u) + gq + 8 * h;  // ((e,r), i)
            if (row >= TI * D2) continue;
#pragma unroll
            for (int f = 0; f < NFG; ++f)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int fg = 8 * f + 2 * t4 + e, er = row / TI;
                if (fg < D2)
                  Os[(fg / D) * sax[0] + (fg % D) * sax[1] + (er / D) * sax[2] +
                     (er % D) * sax[3] + (row % TI) * sax[4]] = acc[u][f][2 * h + e];
              }
          }
#pragma unroll
        for (int u = 0; u < MTW; ++u)
#pragma unroll
          for (int f = 0; f < NFG; ++f)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[u][f][q] = T(0);
        tile_coords(bra_tile, st_j, st_i0);
        st_bulk = geo.bulk && st_i0 + TI <= geo.ni;
        if (geo.bulk) fence_async_shared();  // the staged tile, before the bulk copies read it
        bra_tile += gridDim.x;
      }
      if (++bra_slab == NSLAB) bra_slab = 0;
    }
    if (++ket_slot == STAGES) ket_slot = 0;
  }
  cp_wait<0>();
  __syncthreads();
  if (st_bulk) store_bulk(st_j, st_i0);
  else if (st_j >= 0)  // the last tile, by every warp
    for (int c = 0; c < CHUNKS; ++c) drain(st_j, st_i0, c, tid, NT);
  if (geo.bulk && tid < D2) bulk_wait();
}

int num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <typename T, int D>
int launch_d(const T* Wk, const T* WbT, const T* X, T* out, const DLGeom* g,
             cudaStream_t stream) {
  using P = Plan<T, D>;
  const size_t smem = smem_bytes<T, D>(g->d, stages<T, D>());
  auto kern = double_layer_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, P::NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t ntiles = g->nj * ((g->ni + TI - 1) / TI);
  int64_t blocks = static_cast<int64_t>(per_sm) * num_sms();
  if (blocks > ntiles) blocks = ntiles;
  kern<<<static_cast<unsigned>(blocks), P::NT, smem, stream>>>(Wk, WbT, X, out, *g);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* Wk, const T* WbT, const T* X, T* out, const DLGeom* g, cudaStream_t stream) {
  if (g->nj <= 0 || g->ni <= 0) return cudaSuccess;
  if (g->d < 1 || g->d > 2) return cudaErrorInvalidValue;
  switch (g->D) {
    case 1: return launch_d<T, 1>(Wk, WbT, X, out, g, stream);
    case 2: return launch_d<T, 2>(Wk, WbT, X, out, g, stream);
    case 3: return launch_d<T, 3>(Wk, WbT, X, out, g, stream);
    case 4: return launch_d<T, 4>(Wk, WbT, X, out, g, stream);
    case 5: return launch_d<T, 5>(Wk, WbT, X, out, g, stream);
    case 6: return launch_d<T, 6>(Wk, WbT, X, out, g, stream);
    case 7: return launch_d<T, 7>(Wk, WbT, X, out, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int tpeps_double_layer_f64(const double* Wk, const double* WbT, const double* X, double* out,
                           const DLGeom* g, void* stream) {
  return launch<double>(Wk, WbT, X, out, g, static_cast<cudaStream_t>(stream));
}

int tpeps_double_layer_f32(const float* Wk, const float* WbT, const float* X, float* out,
                           const DLGeom* g, void* stream) {
  return launch<float>(Wk, WbT, X, out, g, static_cast<cudaStream_t>(stream));
}

const char* tpeps_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
