// K8: the block-sparse tensordot of charge-conserving (abelian) tensors.
//
// Replaces tpeps/sym/tensor.py:AbelianTensor.tensordot (:342-488), whose
// batched branch (:435-478) groups the charge-matched block pairs by
// (shape_a, shape_b), runs one vmapped dot_general per group, applies the
// fermionic signs and segment-sums the products of each output charge.  Here
// a tensordot is two kinds of launch over tables that the host builds once
// per block structure (tpeps_torch/kernels/blocksparse.py) and keeps on the
// card.
//
// block_permute copies every entry of a table, dst[doff + sum_r i_r dstr_r] =
//   scale * src[soff + sum_r i_r sstr_r] over the entry's shape (destination
//   order, rank <= MAXR).  It puts a tensordot's operands in (kept legs,
//   contracted legs) order, transposes tensors, gathers a tensor into
//   per-charge-sector matrices and scatters isometry columns back into
//   blocks; the backward of a copy is the copy through the inverse table.
//   The scale is +-1 (fermionic signs), so the copy is bit-exact.
//   The host cuts every entry larger than CHUNK elements along its outer
//   destination legs into boxes of at most CHUNK (sub-entries of the same
//   rank, the fixed legs of extent 1) and groups consecutive entries into
//   tiles, one block each.  A block copies an entry of its tile in two
//   passes through shared memory: it reads the source in source order (the
//   legs sorted by source stride, so neighbouring threads read neighbouring
//   addresses; a strided source such as a sector matrix is read by its
//   rows) into a row-major copy, then writes the destination in
//   destination order (by destination stride: one contiguous run where the
//   entry is contiguous).  Each pass splits an element's index into (outer,
//   middle, inner) over the pass's leg order, the outer and inner parts at
//   most sqrt(CHUNK) each, whose offsets are tables the block builds in
//   shared memory; a thread steps through its elements by carries, so there
//   is no division, no search and no 64-bit arithmetic per element.  An
//   entry of at most SMALL_ENTRY elements is copied by one warp directly,
//   each element's index split by 32-bit divisions.
//
// block_gemm: for each output block o (m x n, row-major at its offset), the
//   sum over its pairs p of sign_p * A_p (m x k_p) @ B_p (k_p x n), written
//   once; elements outside the table's output blocks are left as they are.
//   A launch may read either operand transposed (trans_a: each A_p stored
//   k x m; trans_b: each B_p stored n x k).  The backward of a tensordot is
//   two launches on tables the host derives from the forward one: dA = sum_p
//   s_p G_o B_p^T grouped by A block, dB = sum_p s_p A_p^T G_o grouped by B
//   block.  The host puts each output block in one of five classes
//   (tpeps_torch/kernels/blocksparse.py:gemm_schedule) and lists the tiles
//   of all of them in one launch (one block a tile):
//   - ROWS (n <= SK_S < m, every k_p <= SK_K) and COLS (m and n swapped),
//     the env against the site tensor: a thread computes SK_R rows (columns)
//     of up to SK_S values.  The pairs' offsets and short operands (sign
//     folded in) go to shared memory first, so the long operand's loads,
//     SK_PB pairs' at once, wait on nothing; neighbouring threads take
//     neighbouring rows.  The host lists the tiles by row panel, so the
//     tiles that read the same rows of an operand block shared by several
//     pairs run together and find them in L2.  Bound by memory.
//   - SPLIT (m, n <= SPLIT_S, the pairs' k summing to 256 or more: the dB
//     tables, grouped by a site block): a unit is one SPLIT_DEPTH range of a
//     pair's k, a piece (one block) the units of one range index of all the
//     block's pairs, listed by range index; a thread takes a k of each unit,
//     the block's partial is summed by a fixed shuffle tree into a scratch
//     slot, and the last piece to arrive (an integer counter per output
//     block, reset by that piece) sums the slots in order.
//   - DMMA (the rest but the smallest): 64 x 64 tiles on the FP64 tensor
//     cores (mma.sync m16n8k4, 4 warps of 32 x 32; f32 on the CUDA cores).
//     The pairs' products are one product over their concatenated k, walked
//     in 16-deep slabs staged by cp.async in a ring (every copying thread
//     keeps a cursor (pair, k) of its slab column or row, so short pairs
//     fill a slab); the sign of each slab column sits beside it.  An output
//     block's pairs are split into ranges of about 512 k (more where the
//     class has too few tiles for the card), each tile of a range leaves its
//     partial tile in a scratch slot, and the last to arrive sums them in
//     range order, as SPLIT does.
//   - SMALL (m n < 256 and a total k < 32): 128 consecutive elements of a
//     block, one a thread, each a dot product read straight from memory.
//   Every output block's sum runs in a fixed order, nothing on data is
//   atomic, so two calls agree bit for bit; the counters are left at zero,
//   so a launch captures into a CUDA graph and replays.  Launches that
//   share counters and scratch must run one after another: the host gives
//   each stream its own (blocksparse.py:workspace).  A launch without
//   DMMA tiles takes an instance of the kernel without the DMMA code, whose
//   registers leave room for twice the blocks an SM.
//
// What bounds it on an H100: at D=8, chi=160 one CTMRG move's ten
// tensordots do ~4.7 GFLOP over ~1.6 GB of operands and results, so memory
// (0.47 ms) rather than FP64 (0.07 ms) bounds the function.  Operand blocks
// shared by several pairs are read once per pair (from L2 where the tile
// order keeps them); the skinny products and the dB tables carry most of
// the bytes.  PERF.md has the classes' times against the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- block_permute ---------------------------------------------------------
constexpr int MAXR = 12;         // largest block rank block_permute takes
constexpr int PNT = 256;         // threads of a permute block
constexpr int CHUNK = 2048;      // largest (sub)entry a block stages
constexpr int PTAB = 64;         // outer and inner tables: at most sqrt(CHUNK) entries
constexpr int SMALL_ENTRY = 128; // entries up to this size: one warp, no staging
constexpr int PBATCH = 2;       // source loads in flight a thread
constexpr int PMINB = 8;        // blocks an SM (launch bounds)

struct PermArgs {
  const int64_t* soff;     // per (sub)entry
  const int64_t* doff;
  const int32_t* meta;     // 3 rank + 1 ints per entry: shape (the table's leg order),
                           // source strides, destination strides, size
  const double* scale;     // per entry, or null
  const int32_t* tile_ptr; // the entries of tile t: [tile_ptr[t], tile_ptr[t + 1])
  int rank;
};
template <typename T>
__device__ __forceinline__ T scaled(T v, const double* scale, int e) {
  return scale != nullptr ? static_cast<T>(scale[e]) * v : v;
}

template <typename T>
__device__ void copy_direct(const T* __restrict__ src, T* __restrict__ dst, const PermArgs& a,
                            int e, int lane) {
  const int R = a.rank;
  const int32_t* mt = a.meta + static_cast<int64_t>(e) * (3 * R + 1);
  const int size = mt[3 * R];
  const T* s0 = src + a.soff[e];
  T* d0 = dst + a.doff[e];
  for (int x = lane; x < size; x += 32) {
    int loc = x, s = 0, d = 0;
    for (int l = R - 1; l >= 0; --l) {
      const int n = mt[l];
      const int i = loc % n;
      loc /= n;
      s += i * mt[R + l];
      d += i * mt[2 * R + l];
    }
    d0[d] = scaled(s0[s], a.scale, e);
  }
}

// Offsets of the outer (legs ord[0..q)) or inner (legs ord(q..R)) part of an
// element index, a table of n entries: (global, staged) offset pairs.
__device__ void build_table(int2* tab, int n, const int* ord, int l0, int l1, const int* shape,
                            const int* str, const int* loc_str) {
  for (int x = threadIdx.x; x < n; x += PNT) {
    int r = x, s = 0, d = 0;
    for (int j = l1 - 1; j >= l0; --j) {
      const int l = ord[j];
      const int i = r % shape[l];
      r /= shape[l];
      s += i * str[l];
      d += i * loc_str[l];
    }
    tab[x] = make_int2(s, d);
  }
}

// A thread's position (outer o, middle m, inner i) of element x and its step
// by PNT elements.
struct Walk {
  int o, m, i, di, dm, dq, I, E;
  __device__ Walk(int x, int I_, int E_) : I(I_), E(E_) {
    i = x % I;
    const int r = x / I;
    m = r % E;
    o = r / E;
    di = PNT % I;
    const int q = PNT / I;
    dm = q % E;
    dq = q / E;
  }
  __device__ __forceinline__ void step() {
    i += di;
    int c = i >= I;
    i -= c ? I : 0;
    m += dm + c;
    c = m >= E;
    m -= c ? E : 0;
    o += dq + c;
  }
};

template <typename T>
__device__ void copy_staged(const T* __restrict__ src, T* __restrict__ dst, const PermArgs& a,
                            int e, T* buf, int2* tin, int2* tout, int2* win, int2* wout, int* sh) {
  const int R = a.rank, MS = 3 * R + 1;
  __syncthreads();  // the previous entry is done with shared memory
  if (threadIdx.x < MS) sh[threadIdx.x] = a.meta[static_cast<int64_t>(e) * MS + threadIdx.x];
  __syncthreads();
  const int* shape = sh;
  const int* sstr = sh + R;
  const int* dstr = sh + 2 * R;
  const int size = sh[3 * R];
  int* aord = sh + MS;          // the legs in source order (by stride, extent 1 first)
  int* bord = aord + R;         // in destination order
  int* loc = bord + R;          // row-major strides of the staged entry
  // each leg's place in the two orders, and its row-major stride: one
  // thread a leg and order
  if (threadIdx.x < 2 * R) {
    const int l = threadIdx.x % R;
    const int* str = threadIdx.x < R ? sstr : dstr;
    const auto key = [&](int j) { return shape[j] == 1 ? INT32_MAX : str[j]; };
    int rank = 0;
    for (int j = 0; j < R; ++j) rank += key(j) > key(l) || (key(j) == key(l) && j < l);
    (threadIdx.x < R ? aord : bord)[rank] = l;
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + R) {
    const int l = threadIdx.x - 32;
    int st = 1;
    for (int j = l + 1; j < R; ++j) st *= shape[j];
    loc[l] = st;
  }
  __syncthreads();
  // every thread: the leg where each order's prefix product crosses
  // sqrt(size), and whether the destination is the staged copy's layout
  int aq = R - 1, bq = R - 1, flags = 1;
  for (int j = 0, pa = 1, pb = 1; j < R; ++j) {
    pa *= shape[aord[j]];
    pb *= shape[bord[j]];
    if (pa * pa > size && aq == R - 1 && j < R - 1) aq = j;
    if (pb * pb > size && bq == R - 1 && j < R - 1) bq = j;
    flags &= shape[j] == 1 || dstr[j] == loc[j];
  }
  // the read pass's tables (source order) and the write pass's (destination order)
  int OA = 1, IA = 1, OB = 1, IB = 1;
  for (int j = 0; j < aq; ++j) OA *= shape[aord[j]];
  for (int j = aq + 1; j < R; ++j) IA *= shape[aord[j]];
  for (int j = 0; j < bq; ++j) OB *= shape[bord[j]];
  for (int j = bq + 1; j < R; ++j) IB *= shape[bord[j]];
  build_table(tin, IA, aord, aq + 1, R, shape, sstr, loc);
  build_table(tout, OA, aord, 0, aq, shape, sstr, loc);
  if (!(flags & 1)) {
    build_table(win, IB, bord, bq + 1, R, shape, dstr, loc);
    build_table(wout, OB, bord, 0, bq, shape, dstr, loc);
  }
  __syncthreads();
  // read pass, in source order: staged[loc] = src[s]
  {
    const int lm = aord[aq];
    const T* s0 = src + a.soff[e];
    const int ms = sstr[lm], md = loc[lm];
    Walk w(threadIdx.x, IA, shape[lm]);
    // PBATCH loads in flight a thread, then their stores
    for (int x0 = threadIdx.x; x0 < size; x0 += PBATCH * PNT) {
      T v[PBATCH];
      int d[PBATCH];
#pragma unroll
      for (int u = 0; u < PBATCH; ++u) {
        if (x0 + u * PNT < size) {
          const int2 p = tout[w.o], q = tin[w.i];
          d[u] = p.y + w.m * md + q.y;
          v[u] = s0[p.x + w.m * ms + q.x];
        }
        w.step();
      }
#pragma unroll
      for (int u = 0; u < PBATCH; ++u)
        if (x0 + u * PNT < size) buf[d[u]] = v[u];
    }
  }
  __syncthreads();
  // write pass, in destination order: dst[d] = staged[loc]
  T* d0 = dst + a.doff[e];
  if (flags & 1) {
    for (int x = threadIdx.x; x < size; x += PNT) d0[x] = scaled(buf[x], a.scale, e);
  } else {
    const int lm = bord[bq];
    const int md = dstr[lm], ml = loc[lm];
    Walk w(threadIdx.x, IB, shape[lm]);
    for (int x = threadIdx.x; x < size; x += PNT) {
      const int2 p = wout[w.o], q = win[w.i];
      d0[p.x + w.m * md + q.x] = scaled(buf[p.y + w.m * ml + q.y], a.scale, e);
      w.step();
    }
  }
}

// PMINB blocks an SM (32 registers a thread at 8, a few spilled):
// more copies in flight beat more loads a thread (PERF.md, §6)
template <typename T>
__global__ void __launch_bounds__(PNT, PMINB)
block_permute_kernel(const T* __restrict__ src, T* __restrict__ dst, PermArgs a) {
  __shared__ T buf[CHUNK];
  __shared__ int2 tin[PTAB], tout[PTAB], win[PTAB], wout[PTAB];
  __shared__ int sh[6 * MAXR + 4];
  const int e0 = a.tile_ptr[blockIdx.x], e1 = a.tile_ptr[blockIdx.x + 1];
  const int MS = 3 * a.rank + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = e0 + warp; e < e1; e += PNT / 32)
    if (a.meta[static_cast<int64_t>(e) * MS + MS - 1] <= SMALL_ENTRY)
      copy_direct<T>(src, dst, a, e, lane);
  for (int e = e0; e < e1; ++e)
    if (a.meta[static_cast<int64_t>(e) * MS + MS - 1] > SMALL_ENTRY)
      copy_staged<T>(src, dst, a, e, buf, tin, tout, win, wout, sh);
}

template <typename T>
int permute_launch(const T* src, T* dst, const PermArgs& a, int ntiles, cudaStream_t stream) {
  if (ntiles <= 0) return cudaSuccess;
  if (a.rank < 1 || a.rank > MAXR) return cudaErrorInvalidValue;
  block_permute_kernel<T><<<ntiles, PNT, 0, stream>>>(src, dst, a);
  return cudaGetLastError();
}

// ---- block_gemm ------------------------------------------------------------
constexpr int GNT = 128;            // threads per tile, every class
constexpr int TBM = 64, TBN = 64, TBK = 16;
constexpr int AS = TBK + 4;         // row stride of the A slab (elements)
constexpr int BS = TBN + 4;         // row stride of the B slab
constexpr int NSTAGE = 2;          // DMMA: stages of the cp.async ring
constexpr int GMINB = 8;           // blocks an SM of a launch without DMMA tiles
constexpr int SK_S = 4;             // ROWS / COLS: the short side
constexpr int SK_K = 16;            // ROWS / COLS: the largest k of a pair
constexpr int SK_P = 16;            // ROWS / COLS: pairs staged at once
constexpr int SK_R = 2;             // ROWS / COLS: rows (columns) of a thread
constexpr int SK_PB = 2;            // ROWS / COLS: pairs whose loads are in flight together
constexpr int SPLIT_S = 4;          // SPLIT: the largest m and n
constexpr int SPLIT_DEPTH = 128;    // SPLIT: the k range of a unit (a multiple of GNT)
constexpr int SPLIT_UNITS = 256;    // SPLIT: the most units of a piece
constexpr int TILE_SLOT = TBM * TBN;  // a DMMA partial tile in scratch
constexpr int SPLIT_SLOT = 16;        // a SPLIT partial in scratch

enum Kind { SMALL = 0, DMMA = 1, ROWS = 2, COLS = 3, SPLIT = 4 };

template <typename T>
constexpr int dmma_smem() {
  return NSTAGE * ((TBM * AS + TBK * BS) * static_cast<int>(sizeof(T)) + TBK * 8);
}
template <typename T>
constexpr int skinny_smem() {
  return SK_P * SK_K * SK_S * static_cast<int>(sizeof(T)) + SK_P * 12;
}
template <typename T>
constexpr int split_smem() {
  return (GNT / 32) * SPLIT_SLOT * static_cast<int>(sizeof(T)) + SPLIT_UNITS * 28;
}

template <typename T>
struct GemmArgs {
  const T* A;
  const T* B;
  T* C;
  const int64_t* ob_off;  // output block offsets
  const int32_t* ob_m;
  const int32_t* ob_n;
  const int32_t* ob_ptr;  // CSR: pairs of output block o are [ob_ptr[o], ob_ptr[o + 1])
  const int64_t* pr_a;    // A block offset of each pair
  const int64_t* pr_b;    // B block offset
  const int32_t* pr_k;    // contracted extent
  const int32_t* pr_s;    // sign, +1 or -1
  const int4* tiles;      // two int4 a tile: (o, kind, r0, c0), (p0, p1, slot, group)
  const int32_t* units;   // SPLIT: (pair, k0, k1) per unit
  const int64_t* grp_base;  // scratch offset of each group's first slot
  const int32_t* grp_n;     // slots of each group
  int* counters;            // one a group, zero between launches
  T* scratch;
  int ta;                 // A_p stored k x m (transposed)
  int tb;                 // B_p stored n x k (transposed)
};

// element (i, kk) of A_p (m x k) and (kk, j) of B_p (k x n), in either layout
template <typename T>
__device__ __forceinline__ int a_idx(const GemmArgs<T>& g, int m, int k, int i, int kk) {
  return g.ta ? kk * m + i : i * k + kk;
}
template <typename T>
__device__ __forceinline__ int b_idx(const GemmArgs<T>& g, int k, int n, int kk, int j) {
  return g.tb ? j * k + kk : kk * n + j;
}

// Whether this block arrived last at group grp of n slots (every thread of
// the block gets the answer); its partial is in scratch before it asks.
__device__ __forceinline__ bool arrived_last(int* counters, int grp, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counters + grp, 1) == n - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 8 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A copying thread's place in the concatenated k of pairs [.., p1): pair p,
// element kl of it.
struct KCursor {
  int p, kl;
  __device__ __forceinline__ void settle(const int32_t* pr_k, int p1) {
    while (p < p1 && kl >= pr_k[p]) {
      kl -= pr_k[p];
      ++p;
    }
  }
};

// DMMA class: the 64 x 64 tile at (row0, col0) of output block o over pairs
// [p0, p1); slot < 0 writes C, else the partial goes to slot `slot` of group
// `grp` and the last to arrive writes C.
template <typename T>
__device__ void dmma_tile(const GemmArgs<T>& g, int o, int row0, int col0, int p0, int p1,
                          int slot, int grp, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int m = g.ob_m[o], n = g.ob_n[o];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + NSTAGE * TBM * AS;
  double* Sg = reinterpret_cast<double*>(Bs + NSTAGE * TBK * BS);  // sign of each slab column
  int ktot = 0;
  for (int p = p0; p < p1; ++p) ktot += g.pr_k[p];
  const int nslab = (ktot + TBK - 1) / TBK;
  // copy assignment: a fixed slab column of A and a fixed slab row of B per
  // thread, eight elements of each a slab
  // (neighbouring threads on neighbouring addresses in both layouts)
  const int ac = g.ta ? tid / 8 : tid % 16;  // A: slab column ac, rows ar0 + 8 j
  const int ar0 = g.ta ? tid % 8 : tid / 16;
  const int br = g.tb ? tid % 16 : tid / 8;  // B: slab row br, columns bc0 + 8 j
  const int bc0 = g.tb ? tid / 16 : tid % 8;
  KCursor ca{p0, ac}, cb{p0, br};
  ca.settle(g.pr_k, p1);
  cb.settle(g.pr_k, p1);
  auto issue = [&](int stage) {
    T* as = As + stage * TBM * AS;
    T* bs = Bs + stage * TBK * BS;
    {
      const bool kv = ca.p < p1;
      const int k = kv ? g.pr_k[ca.p] : 1;
      const T* A = g.A + (kv ? g.pr_a[ca.p] : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = ar0 + 8 * j;
        const int gr = row0 + r;
        const bool ok = kv && gr < m;
        cp_async(as + r * AS + ac, ok ? A + a_idx(g, m, k, gr, ca.kl) : g.A, ok);
      }
      if (ar0 == 0)
        Sg[stage * TBK + ac] = kv ? static_cast<double>(g.pr_s[ca.p]) : 0.0;
      ca.kl += TBK;
      ca.settle(g.pr_k, p1);
    }
    {
      const bool kv = cb.p < p1;
      const int k = kv ? g.pr_k[cb.p] : 1;
      const T* B = g.B + (kv ? g.pr_b[cb.p] : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = bc0 + 8 * j;
        const int gc = col0 + c;
        const bool ok = kv && gc < n;
        cp_async(bs + br * BS + c, ok ? B + b_idx(g, k, n, cb.kl, gc) : g.B, ok);
      }
      cb.kl += TBK;
      cb.settle(g.pr_k, p1);
    }
  };
  T* C = g.C + g.ob_off[o];
  if constexpr (std::is_same<T, double>::value) {
    const int lane = tid % 32, warp = tid / 32;
    const int gq = lane / 4, t = lane % 4;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    double acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nslab) issue(s);
      cp_commit();
    }
    for (int s = 0; s < nslab; ++s) {
      if (s + NSTAGE - 1 < nslab) issue((s + NSTAGE - 1) % NSTAGE);
      cp_commit();
      cp_wait<NSTAGE - 1>();
      __syncthreads();
      const double* as = As + (s % NSTAGE) * TBM * AS;
      const double* bs = Bs + (s % NSTAGE) * TBK * BS;
      const double* sg = Sg + (s % NSTAGE) * TBK;
#pragma unroll
      for (int kk = 0; kk < TBK; kk += 4) {
        const double sgn = sg[kk + t];
        double a[2][2], b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = sgn * as[(wm + 16 * i + gq) * AS + kk + t];
          a[i][1] = sgn * as[(wm + 16 * i + gq + 8) * AS + kk + t];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[(kk + t) * BS + wn + 8 * j + gq];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dmma(acc[i][j], a[i][0], a[i][1], b[j]);
      }
      __syncthreads();
    }
    cp_wait<0>();
    if (slot >= 0) {
      double* mine = g.scratch + g.grp_base[grp] + static_cast<int64_t>(slot) * TILE_SLOT + tid;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) mine[((i * 4 + j) * 4 + q) * GNT] = acc[i][j][q];
      const int ns = g.grp_n[grp];
      if (!arrived_last(g.counters, grp, ns)) return;
      const double* first = g.scratch + g.grp_base[grp] + tid;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int idx = ((i * 4 + j) * 4 + q) * GNT;
            double v = 0.0;
            for (int z = 0; z < ns; ++z) v += __ldcg(first + static_cast<int64_t>(z) * TILE_SLOT + idx);
            acc[i][j][q] = v;
          }
      if (tid == 0) g.counters[grp] = 0;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + 16 * i + gq + 8 * h;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col0 + wn + 8 * j + 2 * t;
          if (c < n) C[r * n + c] = acc[i][j][2 * h];
          if (c + 1 < n) C[r * n + c + 1] = acc[i][j][2 * h + 1];
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
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nslab) issue(s);
      cp_commit();
    }
    for (int s = 0; s < nslab; ++s) {
      if (s + NSTAGE - 1 < nslab) issue((s + NSTAGE - 1) % NSTAGE);
      cp_commit();
      cp_wait<NSTAGE - 1>();
      __syncthreads();
      const T* as = As + (s % NSTAGE) * TBM * AS;
      const T* bs = Bs + (s % NSTAGE) * TBK * BS;
      const double* sg = Sg + (s % NSTAGE) * TBK;
#pragma unroll
      for (int kk = 0; kk < TBK; ++kk) {
        const T sgn = static_cast<T>(sg[kk]);
        T a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sgn * as[(4 * ty + i) * AS + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = bs[kk * BS + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    cp_wait<0>();
    if (slot >= 0) {
      T* mine = g.scratch + g.grp_base[grp] + static_cast<int64_t>(slot) * TILE_SLOT + tid;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mine[(i * 8 + j) * GNT] = acc[i][j];
      const int ns = g.grp_n[grp];
      if (!arrived_last(g.counters, grp, ns)) return;
      const T* first = g.scratch + g.grp_base[grp] + tid;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          T v = T(0);
          for (int z = 0; z < ns; ++z)
            v += __ldcg(first + static_cast<int64_t>(z) * TILE_SLOT + (i * 8 + j) * GNT);
          acc[i][j] = v;
        }
      if (tid == 0) g.counters[grp] = 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * ty + i;
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + tx + 8 * j;
        if (c < n) C[r * n + c] = acc[i][j];
      }
    }
  }
}

// ROWS (COLS = false): rows l0 .. l0 + SK_R GNT - 1 of output block o,
// n <= SK_S; COLS: its columns, m <= SK_S.  Every pair's k <= SK_K.  A thread
// takes SK_R rows GNT apart.  The pairs' long-operand offsets and k, then
// their short operands (sign folded in), up to SK_P pairs at a time, go to
// shared memory first, so the long operand's loads depend on nothing in
// flight: SK_PB pairs' rows (4 k's each) are loaded together.
template <typename T, bool COLS>
__device__ void skinny_tile(const GemmArgs<T>& g, int o, int l0, unsigned char* smem) {
  T* w = reinterpret_cast<T*>(smem);
  int64_t* xoff = reinterpret_cast<int64_t*>(w + SK_P * SK_K * SK_S);
  int* xk = reinterpret_cast<int*>(xoff + SK_P);
  const int m = g.ob_m[o], n = g.ob_n[o];
  const int L = COLS ? n : m, S = COLS ? m : n;
  const int p0 = g.ob_ptr[o], p1 = g.ob_ptr[o + 1];
  T acc[SK_R][SK_S];
#pragma unroll
  for (int r = 0; r < SK_R; ++r)
#pragma unroll
    for (int s = 0; s < SK_S; ++s) acc[r][s] = T(0);
  // element (row l, kk) of the long operand: X[l * ls + kk * ks]
  const bool lt = COLS ? !g.tb : g.ta;  // the long side's index has stride 1
  for (int q0 = p0; q0 < p1; q0 += SK_P) {
    const int np = min(SK_P, p1 - q0);
    __syncthreads();  // the previous batch is read
    if (threadIdx.x < np) {
      const int p = q0 + threadIdx.x;
      xoff[threadIdx.x] = COLS ? g.pr_b[p] : g.pr_a[p];
      xk[threadIdx.x] = g.pr_s[p] * g.pr_k[p];  // the sign rides on k
    }
    __syncthreads();
    for (int e = threadIdx.x; e < np * SK_K * SK_S; e += GNT) {
      const int pl = e / (SK_K * SK_S), r = e % (SK_K * SK_S);
      const int kk = r / SK_S, s = r % SK_S;
      const int ks = xk[pl], k = ks < 0 ? -ks : ks;
      T v = T(0);
      if (kk < k && s < S) {
        const int p = q0 + pl;
        v = COLS ? g.A[g.pr_a[p] + a_idx(g, m, k, s, kk)] : g.B[g.pr_b[p] + b_idx(g, k, n, kk, s)];
        if (ks < 0) v = -v;
      }
      w[e] = v;
    }
    __syncthreads();
    for (int b0 = 0; b0 < np; b0 += SK_PB) {
      int kmax = 0;
#pragma unroll
      for (int u = 0; u < SK_PB; ++u)
        if (b0 + u < np) kmax = max(kmax, abs(xk[b0 + u]));
      for (int k0 = 0; k0 < kmax; k0 += 4) {
        T x[SK_PB][SK_R][4];
#pragma unroll
        for (int u = 0; u < SK_PB; ++u) {
          const int k = b0 + u < np ? abs(xk[b0 + u]) : 0;
          const T* X = (COLS ? g.B : g.A) + (b0 + u < np ? xoff[b0 + u] : 0);
          const int ls = lt ? 1 : k, ks = lt ? L : 1;
#pragma unroll
          for (int r = 0; r < SK_R; ++r) {
            const int l = l0 + threadIdx.x + r * GNT;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              x[u][r][c] = (l < L && k0 + c < k) ? X[l * ls + (k0 + c) * ks] : T(0);
          }
        }
#pragma unroll
        for (int u = 0; u < SK_PB; ++u) {
          if (b0 + u >= np || k0 >= abs(xk[b0 + u])) continue;
          const T* ws = w + (b0 + u) * SK_K * SK_S + k0 * SK_S;
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < SK_R; ++r)
#pragma unroll
              for (int s = 0; s < SK_S; ++s) acc[r][s] += x[u][r][c] * ws[c * SK_S + s];
        }
      }
    }
  }
  T* C = g.C + g.ob_off[o];
#pragma unroll
  for (int r = 0; r < SK_R; ++r) {
    const int l = l0 + threadIdx.x + r * GNT;
    if (l >= L) continue;
#pragma unroll
    for (int s = 0; s < SK_S; ++s)
      if (s < S) C[COLS ? s * n + l : l * n + s] = acc[r][s];
  }
}

// SPLIT: units [u0, u1) of output block o (m, n <= SPLIT_S; a unit is a k
// range of at most SPLIT_DEPTH of one pair); slot < 0 writes C, else as in
// the DMMA class.  The units' offsets sit in shared memory; a thread takes
// SPLIT_DEPTH / GNT k's of each unit.
template <typename T>
__device__ void split_tile(const GemmArgs<T>& g, int o, int u0, int u1, int slot, int grp,
                           unsigned char* smem) {
  T* red = reinterpret_cast<T*>(smem);
  int64_t* ua = reinterpret_cast<int64_t*>(red + (GNT / 32) * SPLIT_SLOT);
  int64_t* ub = ua + SPLIT_UNITS;
  int* uk = reinterpret_cast<int*>(ub + SPLIT_UNITS);
  int* uk0 = uk + SPLIT_UNITS;
  int* uk1 = uk0 + SPLIT_UNITS;
  const int m = g.ob_m[o], n = g.ob_n[o];
  const int nu = u1 - u0;
  for (int x = threadIdx.x; x < nu; x += GNT) {
    const int p = g.units[3 * (u0 + x)];
    ua[x] = g.pr_a[p];
    ub[x] = g.pr_b[p];
    uk[x] = g.pr_s[p] * g.pr_k[p];  // the sign rides on k
    uk0[x] = g.units[3 * (u0 + x) + 1];
    uk1[x] = g.units[3 * (u0 + x) + 2];
  }
  __syncthreads();
  T acc[SPLIT_S][SPLIT_S];
#pragma unroll
  for (int i = 0; i < SPLIT_S; ++i)
#pragma unroll
    for (int j = 0; j < SPLIT_S; ++j) acc[i][j] = T(0);
  constexpr int RPT = SPLIT_DEPTH / GNT;
  for (int x = 0; x < nu; ++x) {
    const int ks = uk[x], k = ks < 0 ? -ks : ks;
    const T sgn = ks < 0 ? T(-1) : T(1);
    const T* A = g.A + ua[x];
    const T* B = g.B + ub[x];
    T a[RPT][SPLIT_S], b[RPT][SPLIT_S];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int kk = uk0[x] + threadIdx.x + r * GNT;
      const bool ok = kk < uk1[x];
#pragma unroll
      for (int i = 0; i < SPLIT_S; ++i) a[r][i] = ok && i < m ? sgn * A[a_idx(g, m, k, i, kk)] : T(0);
#pragma unroll
      for (int j = 0; j < SPLIT_S; ++j) b[r][j] = ok && j < n ? B[b_idx(g, k, n, kk, j)] : T(0);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int i = 0; i < SPLIT_S; ++i)
#pragma unroll
        for (int j = 0; j < SPLIT_S; ++j) acc[i][j] += a[r][i] * b[r][j];
  }
  // the block's sum: a fixed shuffle tree in each warp, then the warps in order
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < SPLIT_S; ++i)
#pragma unroll
    for (int j = 0; j < SPLIT_S; ++j) {
      T v = acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp * SPLIT_SLOT + i * SPLIT_S + j] = v;
    }
  __syncthreads();
  const int e = threadIdx.x;  // (i, j) = (e / SPLIT_S, e % SPLIT_S)
  T v = T(0);
  if (e < SPLIT_SLOT)
    for (int x = 0; x < GNT / 32; ++x) v += red[x * SPLIT_SLOT + e];
  const int i = e / SPLIT_S, j = e % SPLIT_S;
  const bool mine = e < SPLIT_SLOT && i < m && j < n;
  T* C = g.C + g.ob_off[o];
  if (slot < 0) {
    if (mine) C[i * n + j] = v;
    return;
  }
  if (e < SPLIT_SLOT) g.scratch[g.grp_base[grp] + static_cast<int64_t>(slot) * SPLIT_SLOT + e] = v;
  const int ns = g.grp_n[grp];
  if (!arrived_last(g.counters, grp, ns)) return;
  if (mine) {
    T s = T(0);
    for (int z = 0; z < ns; ++z)
      s += __ldcg(g.scratch + g.grp_base[grp] + static_cast<int64_t>(z) * SPLIT_SLOT + e);
    C[i * n + j] = s;
  }
  if (threadIdx.x == 0) g.counters[grp] = 0;
}

// SMALL: elements e0.. of output block o, one a thread
template <typename T>
__device__ void small_tile(const GemmArgs<T>& g, int o, int e0) {
  const int m = g.ob_m[o], n = g.ob_n[o];
  const int e = e0 + threadIdx.x;
  if (e >= m * n) return;
  const int i = e / n, j = e - i * n;
  T acc = T(0);
  for (int p = g.ob_ptr[o]; p < g.ob_ptr[o + 1]; ++p) {
    const int k = g.pr_k[p];
    const T* A = g.A + g.pr_a[p];
    const T* B = g.B + g.pr_b[p];
    const T sgn = static_cast<T>(g.pr_s[p]);
    for (int kk = 0; kk < k; ++kk) acc += (sgn * A[a_idx(g, m, k, i, kk)]) * B[b_idx(g, k, n, kk, j)];
  }
  g.C[g.ob_off[o] + e] = acc;
}

// DM: the instance with the DMMA class (its registers hold 4 blocks an SM);
// a launch whose tiles hold none takes the other, whose registers hold
// GMINB: the memory-bound classes want many blocks in flight
template <typename T, bool DM>
__global__ void __launch_bounds__(GNT, DM ? 4 : GMINB)
block_gemm_kernel(GemmArgs<T> g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int4 t0 = g.tiles[2 * blockIdx.x], t1 = g.tiles[2 * blockIdx.x + 1];
  switch (t0.y) {
    case DMMA:
      if constexpr (DM) dmma_tile<T>(g, t0.x, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w, smem);
      break;
    case ROWS:
      skinny_tile<T, false>(g, t0.x, t0.z, smem);
      break;
    case COLS:
      skinny_tile<T, true>(g, t0.x, t0.z, smem);
      break;
    case SPLIT:
      split_tile<T>(g, t0.x, t1.x, t1.y, t1.z, t1.w, smem);
      break;
    default:
      small_tile<T>(g, t0.x, t0.z);
  }
}

// kinds: bit c set when the tile list holds class c (sizes shared memory)
template <typename T>
int gemm_launch(const GemmArgs<T>& g, int ntiles, int kinds, cudaStream_t stream) {
  if (ntiles <= 0) return cudaSuccess;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_gemm_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, dmma_smem<T>());
    if (e != cudaSuccess) return e;
    attr = true;
  }
  int smem = 0;
  if (kinds & (1 << DMMA)) smem = dmma_smem<T>();
  if ((kinds & ((1 << ROWS) | (1 << COLS))) && smem < skinny_smem<T>()) smem = skinny_smem<T>();
  if ((kinds & (1 << SPLIT)) && smem < split_smem<T>()) smem = split_smem<T>();
  if (kinds & (1 << DMMA))
    block_gemm_kernel<T, true><<<ntiles, GNT, smem, stream>>>(g);
  else
    block_gemm_kernel<T, false><<<ntiles, GNT, smem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the limits the host's tables must keep (tpeps_torch/kernels/blocksparse.py
// checks them against its own once per library): 0 the largest rank, 1 the
// largest permute box, 2 the rows of a ROWS / COLS tile, 3 its short side,
// 4 its largest k, 5 a SPLIT block's largest side, 6 a SPLIT unit's k range,
// 7 a SPLIT piece's units
int tpeps_block_sparse_limit(int which) {
  const int limits[] = {MAXR, CHUNK, SK_R * GNT, SK_S, SK_K, SPLIT_S, SPLIT_DEPTH, SPLIT_UNITS};
  return which >= 0 && which < 8 ? limits[which] : -1;
}

int tpeps_block_permute_f64(const double* src, double* dst, const int64_t* soff,
                            const int64_t* doff, const int32_t* meta, const double* scale,
                            const int32_t* tile_ptr, int ntiles, int rank, void* stream) {
  const PermArgs a{soff, doff, meta, scale, tile_ptr, rank};
  return permute_launch<double>(src, dst, a, ntiles, static_cast<cudaStream_t>(stream));
}

int tpeps_block_permute_f32(const float* src, float* dst, const int64_t* soff,
                            const int64_t* doff, const int32_t* meta, const double* scale,
                            const int32_t* tile_ptr, int ntiles, int rank, void* stream) {
  const PermArgs a{soff, doff, meta, scale, tile_ptr, rank};
  return permute_launch<float>(src, dst, a, ntiles, static_cast<cudaStream_t>(stream));
}

#define TPEPS_GEMM_ENTRY(SUF, T)                                                                \
  int tpeps_block_gemm_##SUF(const T* A, const T* B, T* C, const int64_t* ob_off,                \
                             const int32_t* ob_m, const int32_t* ob_n, const int32_t* ob_ptr,    \
                             const int64_t* pr_a, const int64_t* pr_b, const int32_t* pr_k,      \
                             const int32_t* pr_s, const int32_t* tiles, const int32_t* units,    \
                             const int64_t* grp_base, const int32_t* grp_n, int* counters,       \
                             T* scratch, int ntiles, int kinds, int trans_a, int trans_b,        \
                             void* stream) {                                                    \
    const GemmArgs<T> g{A,     B,     C,     ob_off, ob_m,  ob_n,     ob_ptr,   pr_a,           \
                        pr_b,  pr_k,  pr_s,  reinterpret_cast<const int4*>(tiles), units,        \
                        grp_base, grp_n, counters, scratch, trans_a, trans_b};                   \
    return gemm_launch<T>(g, ntiles, kinds, static_cast<cudaStream_t>(stream));                 \
  }

TPEPS_GEMM_ENTRY(f64, double)
TPEPS_GEMM_ENTRY(f32, float)

}  // extern "C"
