"""K8 block-sparse kernels (``csrc/block_sparse.cu``) and their twins.

Both kernels read tables that :mod:`tpeps_torch.sym.tensor` builds once per
block structure (numpy on the host) and that are uploaded once per device:

* :class:`PermuteTable` — one entry per block: source and destination
  offsets, the block's shape in destination order, source and destination
  strides, and an optional per-block scale (+-1, the fermionic signs).
  ``block_permute`` copies every entry; its twin is the same copy as one
  gather and one scatter through the table written out element by element.
  The copy's backward is the copy through :meth:`PermuteTable.inverse`
  (source and destination swapped, the same scale).  The launch's own
  table (:func:`permute_chunks`): every entry larger than
  :data:`PERMUTE_CHUNK` cut along its outer destination legs into boxes,
  and the boxes grouped into tiles.
* :class:`GemmTable` — per output block its offset and ``(m, n)``, and in
  CSR form the list of its pairs ``(A offset, B offset, k, sign)`` in the
  order the JAX code accumulates them, plus the launch's schedule
  (:func:`gemm_schedule`): each output block's class and the tiles of all
  classes in one list.
  ``block_gemm`` writes each output block once, ``sum_p sign_p A_p @ B_p``;
  its twin is the JAX package's batched design: the pairs grouped by
  ``(m, k, n)``, one ``torch.bmm`` per group, the signs, and ``index_add_``
  into the output blocks (one gather of each operand's blocks and one
  ``index_add_`` of all products, in group order).  A table may read either operand transposed
  (``trans_a``, ``trans_b``); :meth:`GemmTable.grad_tables` derives from a
  table the two tables of its backward, ``dA = sum_p s_p G_o B_p^T`` grouped
  by A block and ``dB = sum_p s_p A_p^T G_o`` grouped by B block.

Operands are flat 1-D buffers (a tensor's blocks in sorted key order).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library

MAX_RANK = 12          # csrc/block_sparse.cu MAXR
PERMUTE_CHUNK = 2048   # CHUNK: the largest box a permute block stages
PERMUTE_TABLE = 64     # PTAB: outer and inner index tables, at least sqrt(PERMUTE_CHUNK)
PERMUTE_TILE_ENTRIES = 64  # entries a permute tile holds at most

# block_gemm's classes (csrc/block_sparse.cu enum Kind) and their limits
SMALL, DMMA, ROWS, COLS, SPLIT = range(5)
CLASS_NAMES = ("small", "dmma", "rows", "cols", "split")
BIG_TILE, SMALL_TILE, SKINNY_TILE = 64, 128, 256
SKINNY_SIDE, SKINNY_K = 4, 16  # ROWS / COLS: n (m) at most SKINNY_SIDE, every k at most SKINNY_K
SPLIT_SIDE, SPLIT_MIN_K = 4, 256  # SPLIT: m, n <= SPLIT_SIDE, the pairs' k summing to SPLIT_MIN_K+
SPLIT_DEPTH, SPLIT_UNITS = 128, 256  # SPLIT: k range of a unit, units of a piece (at most)
SMALL_MAX_MN, SMALL_MAX_K = 256, 32  # SMALL: m n below this and the pairs' k summing below that
DMMA_FILL = 2 * 132 * 4  # DMMA tiles that fill two waves (132 SMs, 4 blocks each)
DMMA_KPIECE = 512        # DMMA: the k a tile reduces before its pairs are split
TILE_SLOT, SPLIT_SLOT = BIG_TILE * BIG_TILE, 16  # scratch elements of a partial


def _cdiv(a, b):
    return (a + b - 1) // b


def contiguous_strides(dims: np.ndarray) -> np.ndarray:
    """Row-major strides of each row of ``dims`` (nb, r)."""
    nb, r = dims.shape
    st = np.ones((nb, r), dtype=np.int64)
    for i in range(r - 2, -1, -1):
        st[:, i] = st[:, i + 1] * dims[:, i + 1]
    return st


def expand_entries(soff, doff, shape, sstr, dstr) -> tuple:
    """``(entry, source index, destination index)`` of every element of a
    permute table's entries (destination order within each entry)."""
    shape = np.asarray(shape, dtype=np.int64)
    nb, r = shape.shape
    sizes = shape.prod(axis=1)
    blk = np.repeat(np.arange(nb), sizes)
    loc = np.arange(int(sizes.sum())) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    sidx, didx = np.asarray(soff, np.int64)[blk], np.asarray(doff, np.int64)[blk]
    for l in range(r - 1, -1, -1):
        n = shape[blk, l]
        i = loc % n
        loc //= n
        sidx = sidx + i * np.asarray(sstr)[blk, l]
        didx = didx + i * np.asarray(dstr)[blk, l]
    return blk, sidx, didx


def permute_chunks(soff, doff, shape, sstr, dstr, scale) -> dict:
    """The launch table of ``block_permute``: every entry larger than
    :data:`PERMUTE_CHUNK` cut into boxes along its outer destination legs
    (legs before the cut leg fixed, extent 1; a range of the cut leg; the
    rest whole), then per box its offsets, ``meta`` (shape, source strides,
    destination strides, size) and scale, and the tiles (consecutive boxes,
    at most :data:`PERMUTE_TILE_ENTRIES`, a new tile where the running size
    crosses a multiple of :data:`PERMUTE_CHUNK`)."""
    shape = np.asarray(shape, dtype=np.int64)
    sstr, dstr = np.asarray(sstr, np.int64), np.asarray(dstr, np.int64)
    nb, r = shape.shape
    cs, cd = np.asarray(soff, np.int64), np.asarray(doff, np.int64)
    size = shape.prod(axis=1)
    big = np.nonzero(size > PERMUTE_CHUNK)[0]
    ent, csh, es, ed = np.arange(nb), shape, sstr, dstr
    if len(big):
        sh = shape[big]
        suf = np.ones((len(big), r + 1), dtype=np.int64)
        for l in range(r - 1, -1, -1):
            suf[:, l] = suf[:, l + 1] * sh[:, l]
        rows = np.arange(len(big))
        q = np.argmax(suf[:, 1:] <= PERMUTE_CHUNK, axis=1)  # the cut leg: all after it fit
        run = np.maximum(PERMUTE_CHUNK // suf[rows, q + 1], 1)  # the cut leg's range per box
        nq = _cdiv(sh[rows, q], run)
        nbox = np.ones(nb, np.int64)
        nbox[big] = suf[:, 0] // suf[rows, q] * nq
        ent = np.repeat(ent, nbox)
        cs, cd, csh, es, ed = cs[ent], cd[ent], shape[ent], sstr[ent], dstr[ent]
        # the boxes of the cut entries: which piece of the cut leg, which
        # index of the legs before it
        first = np.cumsum(nbox) - nbox
        box = np.repeat(first[big], nbox[big]) + np.arange(int(nbox[big].sum())) \
            - np.repeat(np.cumsum(nbox[big]) - nbox[big], nbox[big])
        which = np.repeat(rows, nbox[big])
        local = box - first[big][which]
        qe, run_e, nq_e = q[which], run[which], nq[which]
        piece, outer = local % nq_e, local // nq_e
        bsh, bs_, bd = csh[box], es[box], ed[box]
        ds_, dd_ = np.zeros(len(box), np.int64), np.zeros(len(box), np.int64)
        for l in range(r - 1, -1, -1):
            act = l < qe
            n = bsh[:, l]
            i = np.where(act, outer % n, 0)
            outer = np.where(act, outer // n, outer)
            ds_ += i * bs_[:, l]
            dd_ += i * bd[:, l]
            bsh[:, l] = np.where(act, 1, n)
        sel = np.arange(len(box))
        a0 = piece * run_e
        cs[box] += ds_ + a0 * bs_[sel, qe]
        cd[box] += dd_ + a0 * bd[sel, qe]
        bsh[sel, qe] = np.minimum(run_e, bsh[sel, qe] - a0)
        csh[box] = bsh
        size = csh.prod(axis=1)
    span = np.maximum((es * (csh - 1)).sum(axis=1), (ed * (csh - 1)).sum(axis=1))
    if (span >= 2**31).any() or (es < 0).any() or (ed < 0).any():
        raise ValueError("block_permute: an entry spans 2^31 elements or more, or has a "
                         "negative stride")
    meta = np.concatenate([csh, es, ed, size[:, None]], axis=1).astype(np.int32)
    start = np.cumsum(size) - size
    new = np.arange(len(ent)) % PERMUTE_TILE_ENTRIES == 0
    new[1:] |= start[1:] // PERMUTE_CHUNK != start[:-1] // PERMUTE_CHUNK
    tile_ptr = np.concatenate([np.nonzero(new)[0], [len(ent)]]).astype(np.int32)
    return {"entry": ent, "soff": cs, "doff": cd, "meta": meta,
            "scale": None if scale is None else np.asarray(scale, np.float64)[ent],
            "tile_ptr": tile_ptr}


class _DeviceCache:
    """Uploads a table's numpy arrays once per device."""

    _fields: tuple = ()

    def on(self, device: torch.device) -> dict:
        cache = self.__dict__.setdefault("_dev", {})
        key = str(device)
        if key not in cache:
            cache[key] = {f: torch.from_numpy(np.ascontiguousarray(getattr(self, f))).to(device)
                          for f in self._fields if getattr(self, f) is not None}
        return cache[key]


class PermuteTable(_DeviceCache):
    """Entries ``dst[doff + sum_r i_r dstr_r] = scale * src[soff + sum_r i_r sstr_r]``
    over every index ``i`` of ``shape`` (destination order)."""

    _fields = ("c_soff", "c_doff", "c_meta", "c_scale", "tile_ptr")

    def __init__(self, soff, doff, shape, sstr, dstr, scale=None):
        shape = np.asarray(shape, dtype=np.int64)
        if shape.ndim != 2 or not 1 <= shape.shape[1] <= MAX_RANK:
            raise ValueError(f"block_permute takes ranks 1..{MAX_RANK}, got shape table "
                             f"{shape.shape}")
        self.rank = shape.shape[1]
        self.nblk = shape.shape[0]
        self.soff = np.asarray(soff, dtype=np.int64)
        self.doff = np.asarray(doff, dtype=np.int64)
        self.shape = shape.astype(np.int32)
        self.sstr = np.asarray(sstr, dtype=np.int64).reshape(self.nblk, self.rank)
        self.dstr = np.asarray(dstr, dtype=np.int64).reshape(self.nblk, self.rank)
        self.scale = None if scale is None else np.asarray(scale, dtype=np.float64)
        self.total = int(shape.prod(axis=1).sum())
        self.grad = False  # the inverse of a forward table (a backward's copy)
        ch = permute_chunks(self.soff, self.doff, shape, self.sstr, self.dstr, self.scale)
        self.c_entry, self.c_soff, self.c_doff = ch["entry"], ch["soff"], ch["doff"]
        self.c_meta, self.c_scale, self.tile_ptr = ch["meta"], ch["scale"], ch["tile_ptr"]
        self.ntiles = len(self.tile_ptr) - 1

    def inverse(self) -> "PermuteTable":
        """The table of the copy's backward, built once: every entry read from
        its destination and written to its source, with the same scale (+-1).
        The backward of a copy that reads each source element at most once."""
        inv = self.__dict__.get("_inverse")
        if inv is None:
            inv = PermuteTable(self.doff, self.soff, self.shape, self.dstr, self.sstr, self.scale)
            inv.grad = True
            self.__dict__["_inverse"] = inv
        return inv

    def element_index(self, device) -> tuple:
        """``(src index, dst index, scale or None)`` per element, cached per
        device: the table written out element by element."""
        cache = self.__dict__.setdefault("_elem", {})
        key = str(device)
        if key not in cache:
            blk, sidx, didx = expand_entries(self.soff, self.doff, self.shape, self.sstr,
                                             self.dstr)
            sc = None if self.scale is None else torch.from_numpy(self.scale[blk]).to(device)
            cache[key] = (torch.from_numpy(sidx).to(device), torch.from_numpy(didx).to(device), sc)
        return cache[key]


def block_permute_twin(src, dst, table: PermuteTable):
    sidx, didx, sc = table.element_index(src.device)
    v = src[sidx]
    dst[didx] = v if sc is None else v * sc.to(v.dtype)
    return dst


# csrc/block_sparse.cu tpeps_block_sparse_limit, in its order
LIMITS = (MAX_RANK, PERMUTE_CHUNK, SKINNY_TILE, SKINNY_SIDE, SKINNY_K, SPLIT_SIDE, SPLIT_DEPTH,
          SPLIT_UNITS)


def _checked(lib):
    """``lib`` once it is known to keep the limits the tables are built to."""
    if not getattr(lib, "k8_limits_checked", False):
        got = tuple(lib.cdll.tpeps_block_sparse_limit(i) for i in range(len(LIMITS)))
        if got != LIMITS:
            raise RuntimeError(f"block_sparse.cu was built with limits {got}, the tables "
                               f"need {LIMITS}")
        lib.k8_limits_checked = True
    return lib


def block_permute(src, dst, table: PermuteTable):
    """Copy the blocks of the flat ``src`` into the flat ``dst`` through
    ``table``; returns ``dst``.  Destination elements no entry covers are
    left as they are.  A launch on an inverse table counts as
    ``block_permute_grad``."""
    if src.dim() != 1 or dst.dim() != 1 or src.dtype != dst.dtype:
        raise ValueError("block_permute: src and dst must be 1-D of one dtype")
    if not route("block_permute", src, dst):
        return block_permute_twin(src, dst, table)
    require_contiguous("block_permute", src=src, dst=dst)
    if table.total == 0:
        return dst
    t = table.on(dst.device)
    lib = _checked(library())
    with torch.cuda.device(dst.device):
        err = getattr(lib.cdll, f"tpeps_block_permute_{suffix(dst)}")(
            src.data_ptr(), dst.data_ptr(), t["c_soff"].data_ptr(), t["c_doff"].data_ptr(),
            t["c_meta"].data_ptr(), t["c_scale"].data_ptr() if "c_scale" in t else None,
            t["tile_ptr"].data_ptr(), table.ntiles, table.rank, stream_of(dst))
    lib.check(err, "block_permute")
    LAUNCHES["block_permute_grad" if table.grad else "block_permute"] += 1
    return dst


def gemm_schedule(m, n, ptr, k) -> dict:
    """The launch schedule of a ``block_gemm`` table: each output block's
    class and the tiles of all classes in one list, in the kernel's layout.

    Classes (csrc/block_sparse.cu): ``SPLIT`` for blocks of at most
    :data:`SPLIT_SIDE` x :data:`SPLIT_SIDE` whose pairs' k sum to at least
    :data:`SPLIT_MIN_K`; ``ROWS`` for n <= :data:`SKINNY_SIDE` < m and
    ``COLS`` for m <= :data:`SKINNY_SIDE` < n, every k at most
    :data:`SKINNY_K`; ``SMALL`` for the rest with m n < :data:`SMALL_MAX_MN`
    and the pairs' k summing below :data:`SMALL_MAX_K`; ``DMMA`` for the
    rest.  A tile is ``(o, class, r0, c0, p0, p1, slot, group)``: a DMMA
    tile covers rows ``r0..r0+63``, columns ``c0..c0+63`` of block ``o`` over
    the pairs ``[p0, p1)``; ROWS (COLS) :data:`SKINNY_TILE` rows (columns)
    from ``r0``; SMALL 128 elements from ``r0``; SPLIT the units ``[p0, p1)``
    (rows of ``units``: pair, k0, k1).  ``slot >= 0``: the tile leaves a
    partial in that slot of ``group`` (``grp_base``: the group's first
    scratch element, ``grp_n``: its slots), and the last tile of the group
    to arrive sums the slots in order.

    Where the DMMA class has fewer than :data:`DMMA_FILL` tiles, a DMMA
    block's pairs are split into ranges of about :data:`DMMA_KPIECE` k (or
    more ranges, to fill the card), at most 2 :data:`DMMA_FILL` partial tiles
    in all; a larger class is not split.  A
    SPLIT block's work is cut at every :data:`SPLIT_DEPTH` of each pair's
    own k: piece c of block o holds chunk c of every pair of o that has one
    (at most :data:`SPLIT_UNITS` a piece), its slot order (c, then pairs).
    Tiles are listed SPLIT by chunk, DMMA, ROWS and COLS by row panel, then
    SMALL: the tiles that read the same rows of a shared operand block run
    together (L2 keeps them for the other pairs that read them)."""
    m, n = np.asarray(m, np.int64), np.asarray(n, np.int64)
    ptr, k = np.asarray(ptr, np.int64), np.asarray(k, np.int64)
    nout = len(m)
    cnt = np.diff(ptr)
    o_of_p = np.repeat(np.arange(nout), cnt)
    K = np.bincount(o_of_p, weights=k, minlength=nout).astype(np.int64)
    kmax = np.zeros(nout, np.int64)
    some = cnt > 0
    if len(k):
        kmax[some] = np.maximum.reduceat(k, ptr[:-1][some])
    kc = np.cumsum(k) - k
    kc = kc - np.concatenate([[0], np.cumsum(k)])[ptr[:-1]][o_of_p]  # k before p in its block
    kind = np.full(nout, DMMA, np.int64)
    kind[(m * n < SMALL_MAX_MN) & (K < SMALL_MAX_K)] = SMALL
    kind[(n <= SKINNY_SIDE) & (m > SKINNY_SIDE) & (kmax <= SKINNY_K)] = ROWS
    kind[(m <= SKINNY_SIDE) & (n > SKINNY_SIDE) & (kmax <= SKINNY_K)] = COLS
    kind[(m <= SPLIT_SIDE) & (n <= SPLIT_SIDE) & (K >= SPLIT_MIN_K)] = SPLIT
    kind[cnt == 0] = SMALL
    parts, grp_n, grp_size = [], [], []

    def tiles(o, *cols):
        t = np.empty((len(o), 8), np.int32)
        t[:, 0] = o
        for j, c in enumerate(cols, 1):
            t[:, j] = c
        parts.append(t)

    # SPLIT: units (pair, chunk of SPLIT_DEPTH of its k), pieces (block, chunk)
    units = np.zeros((0, 3), np.int64)
    sp = np.nonzero(kind[o_of_p] == SPLIT)[0]
    if len(sp):
        nch = _cdiv(k[sp], SPLIT_DEPTH)
        up = np.repeat(sp, nch)
        uc = np.arange(int(nch.sum())) - np.repeat(np.cumsum(nch) - nch, nch)
        uo = o_of_p[up]
        order = np.lexsort((up, uc, uo))  # by block, chunk, pair
        up, uc, uo = up[order], uc[order], uo[order]
        units = np.stack([up, uc * SPLIT_DEPTH, np.minimum((uc + 1) * SPLIT_DEPTH, k[up])], axis=1)
        first = np.ones(len(up), bool)
        first[1:] = (uo[1:] != uo[:-1]) | (uc[1:] != uc[:-1])
        run0 = np.maximum.accumulate(np.where(first, np.arange(len(up)), 0))
        first |= (np.arange(len(up)) - run0) % SPLIT_UNITS == 0
        u0 = np.nonzero(first)[0]
        u1 = np.concatenate([u0[1:], [len(up)]])
        po, pc = uo[u0], uc[u0]
        npc = np.bincount(po, minlength=nout)
        pj = np.arange(len(u0)) - (np.cumsum(npc) - npc)[po]  # slot: rank in (chunk, part)
        multi = npc[po] > 1
        gid = np.cumsum(npc > 1) - 1
        grp_first = len(grp_n)
        tord = np.lexsort((po, pc))  # the tile list by chunk, then block
        tiles(po[tord], SPLIT, 0, 0, u0[tord], u1[tord], np.where(multi, pj, -1)[tord],
              np.where(multi, grp_first + gid[po], -1)[tord])
        g_o = np.nonzero(npc > 1)[0]
        grp_n.extend(npc[g_o].tolist())
        grp_size.extend([SPLIT_SLOT] * len(g_o))
    # DMMA: 64 x 64 tiles, each block's pairs split into ranges of about equal k
    do = np.nonzero(kind == DMMA)[0]
    if len(do):
        tm, tn = _cdiv(m, BIG_TILE), _cdiv(n, BIG_TILE)
        nt = tm * tn
        t1 = int(nt[do].sum())
        splits = np.ones(nout, np.int64)
        if t1 < DMMA_FILL:  # at most 2 DMMA_FILL + t1 partial tiles in all
            want = np.maximum(_cdiv(K[do], DMMA_KPIECE),
                              np.minimum(_cdiv(DMMA_FILL, t1), np.maximum(K[do] // 64, 1)))
            splits[do] = np.minimum.reduce([cnt[do], want,
                                            np.full(len(do), _cdiv(2 * DMMA_FILL, t1))])
        dp = np.nonzero(kind[o_of_p] == DMMA)[0]
        dpo = o_of_p[dp]
        pid = kc[dp] * splits[dpo] // np.maximum(K[dpo], 1)
        first = np.ones(len(dp), bool)
        first[1:] = (dpo[1:] != dpo[:-1]) | (pid[1:] != pid[:-1])
        s0 = dp[first]
        po = dpo[first]
        s1 = np.concatenate([s0[1:], [0]])
        last = np.ones(len(s0), bool)
        last[:-1] = po[1:] != po[:-1]
        s1 = np.where(last, ptr[po + 1], s1)
        npc = np.bincount(po, minlength=nout)
        pj = np.arange(len(s0)) - (np.cumsum(npc) - npc)[po]
        # every piece times every spatial tile of its block
        rep = nt[po]
        to = np.repeat(po, rep)
        loc = np.arange(int(rep.sum())) - np.repeat(np.cumsum(rep) - rep, rep)
        multi = npc[to] > 1
        g_blocks = np.nonzero((kind == DMMA) & (npc > 1))[0]
        gbase = np.zeros(nout, np.int64)
        gbase[g_blocks] = np.cumsum(nt[g_blocks]) - nt[g_blocks]
        grp_first = len(grp_n)
        tiles(to, DMMA, loc // tn[to] * BIG_TILE, loc % tn[to] * BIG_TILE, np.repeat(s0, rep),
              np.repeat(s1, rep), np.where(multi, np.repeat(pj, rep), -1),
              np.where(multi, grp_first + gbase[to] + loc, -1))
        grp_n.extend(np.repeat(npc[g_blocks], nt[g_blocks]).tolist())
        grp_size.extend([TILE_SLOT] * int(nt[g_blocks].sum()))
    # ROWS, COLS (by row panel, then block), SMALL: no split
    for cls, length, step in ((ROWS, m, SKINNY_TILE), (COLS, n, SKINNY_TILE),
                              (SMALL, m * n, SMALL_TILE)):
        oc = np.nonzero(kind == cls)[0]
        rep = _cdiv(length[oc], step)
        to = np.repeat(oc, rep)
        loc = np.arange(int(rep.sum())) - np.repeat(np.cumsum(rep) - rep, rep)
        if cls != SMALL:
            order = np.lexsort((to, loc))
            to, loc = to[order], loc[order]
        tiles(to, cls, loc * step, 0, ptr[to], ptr[to + 1], -1, -1)
    tl = np.concatenate(parts) if parts else np.zeros((0, 8), np.int32)
    gn = np.asarray(grp_n, np.int64)
    gsz = np.asarray(grp_size, np.int64) * gn
    gbase = np.cumsum(gsz) - gsz
    return {"kind": kind, "tiles": tl, "units": units.astype(np.int32),
            "grp_base": gbase.astype(np.int64), "grp_n": gn.astype(np.int32),
            "scratch": int(gsz.sum()), "kinds": int(np.bitwise_or.reduce(
                1 << np.unique(tl[:, 1]), initial=0)) if len(tl) else 0}


_WORK: dict = {}


def workspace(device, dtype, table: "GemmTable", stream=None) -> tuple:
    """``(counters, scratch)`` for a launch of ``table`` on ``device`` in
    ``dtype`` on ``stream`` (a ``cuda_stream`` handle; the current stream by
    default): the int32 arrival counters (zero, and every launch leaves them
    zero) and the partials' slots, grown to the largest table launched so
    far.  Launches that share them must run one after another, so each
    stream has its own: two launches on two streams at once never mix their
    last-arriver counts.  A graph captures its capture stream's pair, so a
    table is called once on that stream before the capture."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (str(device), dtype, stream)
    cnt, scr = _WORK.get(key, (None, None))
    need_c, need_s = max(len(table.grp_n), 1), max(table.scratch_elems, 1)
    if cnt is None or cnt.numel() < need_c or scr.numel() < need_s:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("block_gemm: call the table once on the capture stream "
                               "before capturing a graph")
        need_c = max(need_c, 0 if cnt is None else cnt.numel())
        need_s = max(need_s, 0 if scr is None else scr.numel())
        cnt = torch.zeros(need_c, dtype=torch.int32, device=device)
        scr = torch.empty(need_s, dtype=dtype, device=device)
        _WORK[key] = (cnt, scr)
    return cnt, scr


class GemmTable(_DeviceCache):
    """Output blocks ``(offset, m, n)`` with their pairs in CSR form and the
    launch's schedule (:func:`gemm_schedule`: each block's class in
    ``ob_kind``, the tiles, the SPLIT units, the groups of partial slots).
    ``trans_a``: every A block is stored k x m (read transposed);
    ``trans_b``: every B block n x k."""

    _fields = ("ob_off", "ob_m", "ob_n", "ob_ptr", "pr_a", "pr_b", "pr_k", "pr_s", "tiles",
               "units", "grp_base", "grp_n")

    def __init__(self, ob_off, ob_m, ob_n, ob_ptr, pr_a, pr_b, pr_k, pr_s, trans_a=False,
                 trans_b=False):
        self.ob_off = np.asarray(ob_off, dtype=np.int64)
        self.ob_m = np.asarray(ob_m, dtype=np.int32)
        self.ob_n = np.asarray(ob_n, dtype=np.int32)
        self.ob_ptr = np.asarray(ob_ptr, dtype=np.int32)
        self.pr_a = np.asarray(pr_a, dtype=np.int64)
        self.pr_b = np.asarray(pr_b, dtype=np.int64)
        self.pr_k = np.asarray(pr_k, dtype=np.int32)
        self.pr_s = np.asarray(pr_s, dtype=np.int32)
        sch = gemm_schedule(self.ob_m, self.ob_n, self.ob_ptr, self.pr_k)
        self.ob_kind, self.tiles, self.units = sch["kind"], sch["tiles"], sch["units"]
        self.grp_base, self.grp_n, self.kinds = sch["grp_base"], sch["grp_n"], sch["kinds"]
        self.scratch_elems = sch["scratch"]
        self.nout, self.npairs, self.ntiles = len(self.ob_off), len(self.pr_a), len(self.tiles)
        self.trans_a, self.trans_b = bool(trans_a), bool(trans_b)

    def restricted(self, classes) -> "GemmTable":
        """The same table launching only the tiles of ``classes`` (a timing
        of one class; its other blocks are left as they are)."""
        sub = copy.copy(self)
        keep = np.isin(self.tiles[:, 1], list(classes))
        sub.tiles = self.tiles[keep]
        sub.ntiles = len(sub.tiles)
        sub.kinds = int(np.bitwise_or.reduce(1 << np.unique(sub.tiles[:, 1]).astype(np.int64),
                                             initial=0)) if sub.ntiles else 0
        for cache in ("_dev", "_grad", "_groups"):
            sub.__dict__.pop(cache, None)
        return sub

    def grad_tables(self) -> tuple:
        """``(dA table, dB table)`` of this product's backward, built once and
        kept with the table.  With ``G`` the cotangent of the output:
        ``dA = block_gemm(G, B, dA table)``, each A block the sum over its
        pairs of ``s_p G_o B_p^T`` (B read transposed), and ``dB =
        block_gemm(A, G, dB table)``, each B block the sum of ``s_p A_p^T G_o``
        (A read transposed).  Pairs keep their order within each block."""
        tabs = self.__dict__.get("_grad")
        if tabs is None:
            if self.trans_a or self.trans_b:
                raise NotImplementedError("grad_tables of a transposed product")
            o_of_p = np.repeat(np.arange(self.nout), np.diff(self.ob_ptr))
            m_p, n_p, k_p = self.ob_m[o_of_p], self.ob_n[o_of_p], self.pr_k
            g_p = self.ob_off[o_of_p]

            def regroup(key, rows, cols, pa, pb, pk, **trans):
                order = np.argsort(key, kind="stable")
                offs, first, cnt = np.unique(key[order], return_index=True, return_counts=True)
                ptr = np.concatenate([[0], np.cumsum(cnt)])
                sel = order[first]
                return GemmTable(offs, rows[sel], cols[sel], ptr, pa[order], pb[order], pk[order],
                                 self.pr_s[order], **trans)

            tabs = (regroup(self.pr_a, m_p, k_p, g_p, self.pr_b, n_p, trans_b=True),
                    regroup(self.pr_b, k_p, n_p, self.pr_a, g_p, m_p, trans_a=True))
            self.__dict__["_grad"] = tabs
        return tabs

    def work(self, classes=None) -> tuple:
        """``(flops, elements)`` of the function (of the output blocks of
        ``classes`` only, when given): 2 m n k per pair; each distinct operand
        block read once and each output block written once."""
        mn = self.ob_m.astype(np.int64) * self.ob_n
        o_of_p = np.repeat(np.arange(self.nout), np.diff(self.ob_ptr))
        sel_o = np.ones(self.nout, bool) if classes is None else np.isin(self.ob_kind,
                                                                         list(classes))
        sel_p = sel_o[o_of_p]
        flops = int(2 * (mn[o_of_p] * self.pr_k)[sel_p].sum())
        elems = int(mn[sel_o].sum())
        for off, per in ((self.pr_a, self.ob_m), (self.pr_b, self.ob_n)):
            _, first = np.unique(off[sel_p], return_index=True)
            elems += int((per.astype(np.int64)[o_of_p] * self.pr_k)[sel_p][first].sum())
        return flops, elems

    def groups(self, device) -> tuple:
        """The pairs grouped by ``(m, k, n)`` (cached per device): the A and B
        indices of every group's operand blocks, concatenated group after
        group; per group ``(A start, A length, B start, B length, signs (G,)
        or None where all are +1, m, k, n)``; the output index of every
        product element in the same order; every output element's index."""
        cache = self.__dict__.setdefault("_groups", {})
        key = str(device)
        if key not in cache:
            o_of_p = np.repeat(np.arange(self.nout), np.diff(self.ob_ptr))
            m = self.ob_m.astype(np.int64)[o_of_p]
            n = self.ob_n.astype(np.int64)[o_of_p]
            k = self.pr_k.astype(np.int64)
            t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
            shapes = np.stack([m, k, n], axis=1) if len(k) else np.zeros((0, 3), np.int64)
            uniq, inv = (np.unique(shapes, axis=0, return_inverse=True) if len(k)
                         else (shapes, np.zeros(0, np.int64)))
            inv = inv.reshape(-1)
            groups, ia, ib, ic, a0, b0 = [], [], [], [], 0, 0
            for gi, (mm, kk, nn) in enumerate(uniq.tolist()):
                idx = np.nonzero(inv == gi)[0]
                ia.append((self.pr_a[idx][:, None] + np.arange(mm * kk)[None, :]).reshape(-1))
                ib.append((self.pr_b[idx][:, None] + np.arange(kk * nn)[None, :]).reshape(-1))
                ic.append((self.ob_off[o_of_p[idx]][:, None]
                           + np.arange(mm * nn)[None, :]).reshape(-1))
                sg = self.pr_s[idx]
                groups.append((a0, ia[-1].size, b0, ib[-1].size,
                               None if (sg > 0).all() else t(sg.astype(np.float64)), mm, kk, nn))
                a0 += ia[-1].size
                b0 += ib[-1].size
            cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64)
            mn = self.ob_m.astype(np.int64) * self.ob_n
            outs = np.repeat(self.ob_off, mn) + np.arange(int(mn.sum())) \
                - np.repeat(np.cumsum(mn) - mn, mn)
            cache[key] = (t(cat(ia)), t(cat(ib)), t(cat(ic)), groups, t(outs))
        return cache[key]


def block_gemm_twin(a, b, out, table: GemmTable):
    ia, ib, ic, groups, outs = table.groups(out.device)
    out[outs] = 0
    if not groups:
        return out
    a_all, b_all, prods = a[ia], b[ib], []
    for a0, na, b0, nb, sg, m, k, n in groups:
        A, B = a_all[a0:a0 + na], b_all[b0:b0 + nb]
        A = A.view(-1, k, m).transpose(1, 2) if table.trans_a else A.view(-1, m, k)
        B = B.view(-1, n, k).transpose(1, 2) if table.trans_b else B.view(-1, k, n)
        prod = torch.bmm(A, B)
        if sg is not None:
            prod = prod * sg.to(prod.dtype).view(-1, 1, 1)
        prods.append(prod.reshape(-1))
    out.index_add_(0, ic, torch.cat(prods))
    return out


def block_gemm(a, b, out, table: GemmTable):
    """Every output block of ``table`` in the flat ``out``: the signed sum
    of its pairs' products of blocks of the flat ``a`` and ``b``; returns
    ``out``.  Elements of ``out`` outside the output blocks are untouched.
    A launch on a table with a transposed operand counts as
    ``block_gemm_grad``."""
    if a.dim() != 1 or b.dim() != 1 or out.dim() != 1:
        raise ValueError("block_gemm: operands and output must be flat 1-D buffers")
    if not route("block_gemm", a, b, out):
        return block_gemm_twin(a, b, out, table)
    require_contiguous("block_gemm", a=a, b=b, out=out)
    if table.ntiles == 0:
        return out
    t = table.on(out.device)
    s = stream_of(out)
    counters, scratch = workspace(out.device, out.dtype, table, s)
    lib = _checked(library())
    with torch.cuda.device(out.device):
        err = getattr(lib.cdll, f"tpeps_block_gemm_{suffix(out)}")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), t["ob_off"].data_ptr(),
            t["ob_m"].data_ptr(), t["ob_n"].data_ptr(), t["ob_ptr"].data_ptr(),
            t["pr_a"].data_ptr(), t["pr_b"].data_ptr(), t["pr_k"].data_ptr(),
            t["pr_s"].data_ptr(), t["tiles"].data_ptr(), t["units"].data_ptr(),
            t["grp_base"].data_ptr(), t["grp_n"].data_ptr(), counters.data_ptr(),
            scratch.data_ptr(), table.ntiles, table.kinds, int(table.trans_a),
            int(table.trans_b), s)
    lib.check(err, "block_gemm")
    LAUNCHES["block_gemm_grad" if table.trans_a or table.trans_b else "block_gemm"] += 1
    return out
