"""K8 block-sparse kernels (``csrc/block_sparse.cu``) and their twins.

Both kernels read tables that :mod:`tpeps_torch.sym.tensor` builds once per
block structure (numpy on the host) and that are uploaded once per device:

* :class:`PermuteTable` — one entry per block: source and destination
  offsets, the block's shape in destination order, source and destination
  strides, and an optional per-block scale (+-1, the fermionic signs).
  ``block_permute`` copies every entry; its twin is the same copy as one
  gather and one scatter through the table written out element by element.
  The copy's backward is the copy through :meth:`PermuteTable.inverse`
  (source and destination swapped, the same scale).
* :class:`GemmTable` — per output block its offset and ``(m, n)``, and in
  CSR form the list of its pairs ``(A offset, B offset, k, sign)`` in the
  order the JAX code accumulates them, plus the tile list of the launch.
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

import numpy as np
import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library

MAX_RANK = 12          # csrc/block_sparse.cu MAXR
BIG_MIN = 16           # output blocks at least this wide in m and n take 64 x 64 tiles
BIG_TILE, SMALL_TILE = 64, 128


def _cdiv(a, b):
    return (a + b - 1) // b


def contiguous_strides(dims: np.ndarray) -> np.ndarray:
    """Row-major strides of each row of ``dims`` (nb, r)."""
    nb, r = dims.shape
    st = np.ones((nb, r), dtype=np.int64)
    for i in range(r - 2, -1, -1):
        st[:, i] = st[:, i + 1] * dims[:, i + 1]
    return st


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

    _fields = ("ecum", "soff", "doff", "shape", "sstr", "dstr", "scale")

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
        sizes = shape.prod(axis=1)
        self.ecum = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.total = int(self.ecum[-1])
        self.grad = False  # the inverse of a forward table (a backward's copy)

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
            sizes = np.diff(self.ecum)
            blk = np.repeat(np.arange(self.nblk), sizes)
            loc = np.arange(self.total) - self.ecum[:-1][blk]
            sidx, didx = self.soff[blk].copy(), self.doff[blk].copy()
            shape = self.shape.astype(np.int64)
            for r in range(self.rank - 1, -1, -1):
                n = shape[blk, r]
                i = loc % n
                loc //= n
                sidx += i * self.sstr[blk, r]
                didx += i * self.dstr[blk, r]
            sc = None if self.scale is None else torch.from_numpy(self.scale[blk]).to(device)
            cache[key] = (torch.from_numpy(sidx).to(device), torch.from_numpy(didx).to(device), sc)
        return cache[key]


def block_permute_twin(src, dst, table: PermuteTable):
    sidx, didx, sc = table.element_index(src.device)
    v = src[sidx]
    dst[didx] = v if sc is None else v * sc.to(v.dtype)
    return dst


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
    lib = library()
    with torch.cuda.device(dst.device):
        err = getattr(lib.cdll, f"tpeps_block_permute_{suffix(dst)}")(
            src.data_ptr(), dst.data_ptr(), t["ecum"].data_ptr(), t["soff"].data_ptr(),
            t["doff"].data_ptr(), t["shape"].data_ptr(), t["sstr"].data_ptr(),
            t["dstr"].data_ptr(), t["scale"].data_ptr() if "scale" in t else None,
            table.nblk, table.rank, table.total, stream_of(dst))
    lib.check(err, "block_permute")
    LAUNCHES["block_permute_grad" if table.grad else "block_permute"] += 1
    return dst


class GemmTable(_DeviceCache):
    """Output blocks ``(offset, m, n)`` with their pairs in CSR form and the
    launch's tiles ``(o, kind, r0, c0)``: kind 1 is a 64 x 64 tile at row
    ``r0``, column ``c0``; kind 0 the 128 elements of block ``o`` from
    ``r0``.  ``trans_a``: every A block is stored k x m (read transposed);
    ``trans_b``: every B block n x k."""

    _fields = ("ob_off", "ob_m", "ob_n", "ob_ptr", "pr_a", "pr_b", "pr_k", "pr_s", "tiles")

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
        self.tiles = gemm_tiles(self.ob_m.astype(np.int64), self.ob_n.astype(np.int64))
        self.nout, self.npairs, self.ntiles = len(self.ob_off), len(self.pr_a), len(self.tiles)
        self.trans_a, self.trans_b = bool(trans_a), bool(trans_b)

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

    def work(self) -> tuple:
        """``(flops, elements)`` of the function: 2 m n k per pair; each
        distinct operand block read once and each output block written once."""
        mn = self.ob_m.astype(np.int64) * self.ob_n
        o_of_p = np.repeat(np.arange(self.nout), np.diff(self.ob_ptr))
        flops = int(2 * (mn[o_of_p] * self.pr_k).sum())
        elems = int(mn.sum())
        for off, per in ((self.pr_a, self.ob_m), (self.pr_b, self.ob_n)):
            _, first = np.unique(off, return_index=True)
            elems += int((per.astype(np.int64)[o_of_p] * self.pr_k)[first].sum())
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


def gemm_tiles(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    big = (m >= BIG_MIN) & (n >= BIG_MIN)
    ncol = _cdiv(n, BIG_TILE)
    nt = np.where(big, _cdiv(m, BIG_TILE) * ncol, _cdiv(m * n, SMALL_TILE))
    o = np.repeat(np.arange(len(m)), nt)
    local = np.arange(int(nt.sum())) - np.repeat(np.cumsum(nt) - nt, nt)
    kind = big[o]
    r0 = np.where(kind, (local // ncol[o]) * BIG_TILE, local * SMALL_TILE)
    c0 = np.where(kind, (local % ncol[o]) * BIG_TILE, 0)
    return np.stack([o, kind, r0, c0], axis=1).astype(np.int32)


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
    lib = library()
    with torch.cuda.device(out.device):
        err = getattr(lib.cdll, f"tpeps_block_gemm_{suffix(out)}")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), t["ob_off"].data_ptr(),
            t["ob_m"].data_ptr(), t["ob_n"].data_ptr(), t["ob_ptr"].data_ptr(),
            t["pr_a"].data_ptr(), t["pr_b"].data_ptr(), t["pr_k"].data_ptr(),
            t["pr_s"].data_ptr(), t["tiles"].data_ptr(), table.ntiles, int(table.trans_a),
            int(table.trans_b), stream_of(out))
    lib.check(err, "block_gemm")
    LAUNCHES["block_gemm_grad" if table.trans_a or table.trans_b else "block_gemm"] += 1
    return out
