"""Abelian-symmetric block-sparse tensors on torch (counterpart of
tpeps/sym/tensor.py).

A tensor's blocks live in ONE flat buffer on one device, in sorted key
order (the order of the JAX pytree's leaves), and ``blocks`` gives views
into it.  The block structure (sorted keys and shapes) is an interned
:class:`Struct`, so two tensors with the same structure share one object
and a plan built for one serves the other.

Every contraction runs on K8 (:mod:`tpeps_torch.kernels.blocksparse`):
``tensordot`` builds, once per ``(structure of a, structure of b, axes)``,
a plan with numpy on the host (charges as integer arrays, no per-pair
Python loop): the operand permutes (``block_permute``) and the table of
output blocks with their charge-matched pairs, fermionic signs included
(``block_gemm``).  Plans keep their tables on the card once uploaded.
``transpose`` and the per-sector matrices of the blockwise decompositions
run on ``block_permute`` too.  Charge rule, signatures, fermionic grading
and the leg conventions are those of the JAX package.

Gradients: every flat-buffer operation goes through
:func:`permute_flat` or :func:`gemm_flat`, ``autograd.Function``s whose
forward and backward call the K8 wrappers on detached buffers: the
backward of a copy is the copy through the table's inverse, that of a
product two ``block_gemm``s on the tables derived from its plan (one with
B read transposed, one with A), each cached with the forward table.

Supported symmetries: "U1", "Z2", "U1xU1".
"""

from __future__ import annotations

import itertools
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..kernels.blocksparse import (GemmTable, PermuteTable, block_gemm, block_permute,
                                   contiguous_strides)
from ..linalg.svd import svd_reg


def _qadd(sym, *qs):
    if sym == "Z2":
        return sum(qs) % 2
    if sym == "U1xU1":
        return tuple(sum(x) for x in zip(*qs))
    return sum(qs)


def _qscale(sym, s, q):
    if sym == "Z2":
        return (s * q) % 2
    if sym == "U1xU1":
        return tuple(s * x for x in q)
    return s * q


def _parity(sym, q) -> int:
    """Fermionic parity of a charge (occupation number mod 2)."""
    if sym == "U1xU1":
        return (q[0] + q[1]) % 2
    return q % 2


def _nsym(sym) -> int:
    return 2 if sym == "U1xU1" else 1


@dataclass(frozen=True)
class LegCharges:
    """Charge sectors of one leg: ``charges`` is a tuple of ``(charge, dim)``
    pairs, charge-sorted; ``pshift`` offsets the leg's fermionic grading."""

    charges: tuple
    pshift: int = 0

    @property
    def dims(self):
        return dict(self.charges)

    def total_dim(self):
        return sum(d for _, d in self.charges)

    def offset(self, q):
        off = 0
        for c, d in self.charges:
            if c == q:
                return off
            off += d
        raise KeyError(q)


def leg(charge_dims, pshift: int = 0) -> LegCharges:
    """Build a LegCharges from a {charge: dim} mapping."""
    items = sorted(charge_dims.items(), key=lambda x: (str(type(x[0])), x[0]))
    return LegCharges(tuple(items), pshift)


# ---------------------------------------------------------------------------
# differentiable flat-buffer operations (K8 forward and backward)
# ---------------------------------------------------------------------------


class _PermuteFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, table, numel, zero_fill):
        dst = (torch.zeros if zero_fill else torch.empty)(numel, dtype=src.dtype,
                                                          device=src.device)
        block_permute(src.detach(), dst, table)
        ctx.table, ctx.src_numel = table, src.numel()
        return dst

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        gsrc = torch.zeros(ctx.src_numel, dtype=g.dtype, device=g.device)
        return block_permute(g.detach().contiguous(), gsrc, ctx.table.inverse()), None, None, None


class _GemmFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, table, numel, zero_fill):
        out = (torch.zeros if zero_fill else torch.empty)(numel, dtype=a.dtype, device=a.device)
        block_gemm(a.detach(), b.detach(), out, table)
        ctx.save_for_backward(a, b)
        ctx.table = table
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = (t.detach() for t in ctx.saved_tensors)
        ta, tb = ctx.table.grad_tables()
        g = g.detach().contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = block_gemm(g, b.conj().resolve_conj(), torch.zeros_like(a), ta)
        if ctx.needs_input_grad[1]:
            db = block_gemm(a.conj().resolve_conj(), g, torch.zeros_like(b), tb)
        return da, db, None, None, None


def permute_flat(src, table: PermuteTable, numel: int, zero_fill: bool = False):
    """The flat ``src`` copied through ``table`` into a new buffer of ``numel``
    elements (zeros where no entry writes, when ``zero_fill``); differentiable.
    Meta buffers give a meta result (a structure-only run)."""
    if src.is_meta:
        return torch.empty(numel, dtype=src.dtype, device=src.device)
    return _PermuteFlat.apply(src, table, numel, zero_fill)


def gemm_flat(a, b, table: GemmTable, numel: int, zero_fill: bool = False):
    """``block_gemm`` of the flat operands into a new buffer of ``numel``
    elements (zeros outside the table's output blocks, when ``zero_fill``);
    differentiable (complex operands on the CPU twin only)."""
    if a.is_meta:
        return torch.empty(numel, dtype=a.dtype, device=a.device)
    return _GemmFlat.apply(a, b, table, numel, zero_fill)


# ---------------------------------------------------------------------------
# block structures and their plans
# ---------------------------------------------------------------------------


def _key_rows(keys, rank: int, nsym: int) -> np.ndarray:
    """Keys as an int64 array (nb, rank, nsym)."""
    if nsym == 1:
        arr = np.array(keys, dtype=np.int64).reshape(len(keys), rank, 1)
    else:
        arr = np.array(keys, dtype=np.int64).reshape(len(keys), rank, nsym)
    return arr


def _rows_to_keys(rows: np.ndarray, nsym: int) -> list:
    """Inverse of :func:`_key_rows` for rows (nb, rank, nsym)."""
    lst = rows.tolist()
    if nsym == 1:
        return [tuple(q[0] for q in r) for r in lst]
    return [tuple(tuple(q) for q in r) for r in lst]


class Struct:
    """Sorted block keys and shapes of a tensor, with flat offsets.  Interned:
    equal structures are one object (compare with ``is``)."""

    __slots__ = ("rank", "nsym", "keys", "shapes", "dims", "sizes", "offsets", "numel",
                 "_charges", "_index", "__weakref__")

    def __init__(self, rank, nsym, keys, shapes):
        self.rank, self.nsym = rank, nsym
        self.keys, self.shapes = keys, shapes
        self.dims = np.array(shapes, dtype=np.int64).reshape(len(keys), rank)
        self.sizes = self.dims.prod(axis=1)
        self.offsets = (np.cumsum(self.sizes) - self.sizes).astype(np.int64)
        self.numel = int(self.sizes.sum())
        self._charges = None
        self._index = None

    @property
    def charges(self) -> np.ndarray:
        if self._charges is None:
            self._charges = _key_rows(self.keys, self.rank, self.nsym)
        return self._charges

    @property
    def index(self) -> dict:
        if self._index is None:
            self._index = {k: i for i, k in enumerate(self.keys)}
        return self._index


_STRUCTS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def make_struct(rank: int, nsym: int, keys, shapes) -> Struct:
    """The interned structure of ``keys`` (sorted here) and their shapes."""
    pairs = sorted(zip(keys, shapes), key=lambda kv: kv[0])
    keys = tuple(k for k, _ in pairs)
    shapes = tuple(tuple(int(x) for x in s) for _, s in pairs)
    return _interned(rank, nsym, keys, shapes)


def _interned(rank, nsym, keys, shapes) -> Struct:
    ident = (rank, nsym, keys, shapes)
    s = _STRUCTS.get(ident)
    if s is None:
        s = Struct(rank, nsym, keys, shapes)
        _STRUCTS[ident] = s
    return s


def _struct_from_rows(rows: np.ndarray, dims: np.ndarray, nsym: int) -> Struct:
    """Structure from charge rows (nb, rank, nsym) already in sorted order."""
    rank = rows.shape[1]
    return _interned(rank, nsym, tuple(_rows_to_keys(rows, nsym)),
                     tuple(tuple(r) for r in dims.tolist()))


def _unique_rows(rows: np.ndarray):
    """``np.unique(rows, axis=0, return_inverse=True)`` for int rows (n, w),
    through one mixed-radix int64 id per row where it fits."""
    lo, hi = rows.min(axis=0), rows.max(axis=0)
    radix = (hi - lo + 1).astype(np.float64)
    if np.prod(radix) >= 2.0 ** 62:
        u, inv = np.unique(rows, axis=0, return_inverse=True)
        return u, inv.reshape(-1)
    mult = np.ones(rows.shape[1], dtype=np.int64)
    for i in range(rows.shape[1] - 2, -1, -1):
        mult[i] = mult[i + 1] * int(radix[i + 1])
    ids = (rows - lo) @ mult
    uid, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    return rows[first], inv.reshape(-1)


def _lexsort_rows(rows: np.ndarray) -> np.ndarray:
    flat = rows.reshape(len(rows), -1)
    if flat.shape[1] == 0:
        return np.arange(len(rows))
    return np.lexsort(flat.T[::-1])


class _LRU(OrderedDict):
    def __init__(self, size):
        super().__init__()
        self.size = size
        self.hits = self.misses = 0
        self.build_seconds = 0.0
        self._depth = 0

    def get_or(self, key, build):
        if key in self:
            self.move_to_end(key)
            self.hits += 1
            return self[key]
        self.misses += 1
        t0 = time.perf_counter()
        self._depth += 1
        try:
            val = build()
        finally:
            self._depth -= 1
        if self._depth == 0:  # a nested build counts in its parent's time
            self.build_seconds += time.perf_counter() - t0
        self[key] = val
        if len(self) > self.size:
            self.popitem(last=False)
        return val


PLANS = _LRU(1024)


def plan_cache_stats() -> dict:
    """Hits, misses and host seconds spent building plans (tensordot, permute,
    sector and partner plans)."""
    return {"hits": PLANS.hits, "misses": PLANS.misses, "size": len(PLANS),
            "build_seconds": PLANS.build_seconds}


def _parities(s: Struct, sym, pshifts) -> np.ndarray:
    """(nb, rank) fermionic parities of every block's leg charges."""
    ch = s.charges
    q = ch.sum(axis=2) if sym == "U1xU1" else ch[:, :, 0]
    return (q + np.asarray(pshifts, dtype=np.int64)[None, :]) % 2


def _perm_signs(par: np.ndarray, axes) -> np.ndarray:
    """Grassmann sign of reordering ``theta_0..theta_{r-1}`` into ``axes``,
    per row of parities ``par``: (-1) per inversion among odd symbols."""
    axes = np.asarray(axes, dtype=np.int64)
    if len(axes) < 2:
        return np.ones(len(par))
    odd = par[:, axes]
    inv = np.triu(axes[:, None] > axes[None, :], 1).astype(np.int64)
    cnt = np.einsum("bi,bj,ij->b", odd, odd, inv)
    return np.where(cnt % 2, -1.0, 1.0)


def _permute_plan(s: Struct, axes, scale_key=None, scale=None):
    """Raw permutation of the blocks' legs: ``(out struct, table, dst index
    of each source block)``; ``scale`` (per source block) multiplies."""

    def build():
        ax = list(axes)
        rows = s.charges[:, ax, :]
        dims = s.dims[:, ax]
        order = _lexsort_rows(rows)
        out = _struct_from_rows(rows[order], dims[order], s.nsym)
        dst_of_src = np.empty(len(order), dtype=np.int64)
        dst_of_src[order] = np.arange(len(order))
        sstr = contiguous_strides(s.dims)[:, ax]
        table = PermuteTable(s.offsets[order], out.offsets, dims[order], sstr[order],
                             contiguous_strides(out.dims),
                             None if scale is None else np.asarray(scale)[order])
        return out, table, dst_of_src

    return PLANS.get_or(("perm", s, tuple(axes), scale_key), build)


@dataclass
class DotPlan:
    out: Struct
    perm_a: PermuteTable | None  # None when the operand needs no permute
    perm_b: PermuteTable | None
    gemm: GemmTable


def _dot_plan(sa: Struct, sb: Struct, ax_a, ax_b, signs=None, out_ref: Struct | None = None):
    """Plan of ``a.tensordot(b, (ax_a, ax_b))`` (see the module docstring).
    ``signs``: ``(key, sign_a, sign_b)`` per-block fermionic signs or None.
    ``out_ref``: a structure holding every output key; the output is laid
    out as it (blocks that no pair produces stay untouched)."""

    def build():
        keep_a = [i for i in range(sa.rank) if i not in ax_a]
        keep_b = [i for i in range(sb.rank) if i not in ax_b]
        nA, nB = len(sa.keys), len(sb.keys)
        perm_a, perm_b = tuple(keep_a) + tuple(ax_a), tuple(ax_b) + tuple(keep_b)
        offs = []
        perms = []
        for s, perm in ((sa, perm_a), (sb, perm_b)):
            if perm == tuple(range(s.rank)):
                offs.append(s.offsets)
                perms.append(None)
            else:
                ps, table, dst = _permute_plan(s, perm)
                offs.append(ps.offsets[dst])
                perms.append(table)
        con_a = sa.charges[:, list(ax_a), :].reshape(nA, len(ax_a) * sa.nsym)
        con_b = sb.charges[:, list(ax_b), :].reshape(nB, len(ax_b) * sb.nsym)
        allcon = np.concatenate([con_a, con_b])
        if allcon.shape[1] and len(allcon):
            _, inv = _unique_rows(allcon)
        else:
            inv = np.zeros(nA + nB, dtype=np.int64)
        ida, idb = inv[:nA], inv[nA:]
        ngroups = int(inv.max()) + 1 if len(inv) else 0
        ordb = np.argsort(idb, kind="stable")
        cntb = np.bincount(idb, minlength=ngroups)
        startb = np.concatenate([[0], np.cumsum(cntb)[:-1]]).astype(np.int64)
        reps = cntb[ida]
        pa = np.repeat(np.arange(nA), reps)
        local = np.arange(len(pa)) - np.repeat(np.cumsum(reps) - reps, reps)
        pb = ordb[startb[ida[pa]] + local]
        # output keys: kept legs of a, then of b
        rows = np.concatenate([sa.charges[pa][:, keep_a, :], sb.charges[pb][:, keep_b, :]],
                              axis=1)
        nkeep = len(keep_a) + len(keep_b)
        if len(pa) == 0:
            urows = rows[:0]
            pout = np.zeros(0, dtype=np.int64)
        elif nkeep == 0:
            urows = rows[:1]
            pout = np.zeros(len(pa), dtype=np.int64)
        else:
            urows, pout = _unique_rows(rows.reshape(len(pa), -1))
            urows = urows.reshape(-1, nkeep, sa.nsym)
        # pairs grouped by output, in a's then b's block order within each
        order = np.lexsort((pb, pa, pout))
        pa, pb, pout = pa[order], pb[order], pout[order]
        nout = len(urows)
        first = np.searchsorted(pout, np.arange(nout))
        ptr = np.concatenate([first, [len(pa)]]).astype(np.int64)
        dm = sa.dims[:, keep_a].prod(axis=1)
        dk = sa.dims[:, list(ax_a)].prod(axis=1)
        dn = sb.dims[:, keep_b].prod(axis=1)
        odims = np.concatenate([sa.dims[pa[first]][:, keep_a], sb.dims[pb[first]][:, keep_b]],
                               axis=1)
        out = _struct_from_rows(urows, odims, sa.nsym)
        if out_ref is None:
            ob_off = out.offsets
            res = out
        else:
            try:
                idx = np.array([out_ref.index[k] for k in out.keys], dtype=np.int64)
            except KeyError as exc:
                raise ValueError(f"tensordot: output block {exc.args[0]} lies outside the "
                                 "given output structure") from None
            if len(idx) and not np.array_equal(out_ref.dims[idx], odims):
                raise ValueError("tensordot: output block shapes differ from the given "
                                 "output structure")
            ob_off = out_ref.offsets[idx] if len(idx) else np.zeros(0, dtype=np.int64)
            res = out_ref
        sgn = np.ones(len(pa))
        if signs is not None:
            sgn = signs[1][pa] * signs[2][pb]
        gemm = GemmTable(ob_off, dm[pa[first]], dn[pb[first]], ptr, offs[0][pa], offs[1][pb],
                         dk[pa], np.where(sgn < 0, -1, 1))
        return DotPlan(res, perms[0], perms[1], gemm)

    key = ("dot", sa, sb, tuple(ax_a), tuple(ax_b), None if signs is None else signs[0], out_ref)
    return PLANS.get_or(key, build)


# ---------------------------------------------------------------------------
# the tensor
# ---------------------------------------------------------------------------


def _as_tensor(b, dtype, device):
    if isinstance(b, torch.Tensor):
        return b.to(dtype=dtype, device=device if device is not None else b.device)
    return torch.as_tensor(np.asarray(b), dtype=dtype, device=device)


class AbelianTensor:
    """Block-sparse tensor with abelian charge conservation (see the JAX
    package's ``AbelianTensor`` for the charge rule and fermionic grading).

    ``blocks`` may be given as a dict ``{charges: array}``; they are copied
    into one flat buffer on ``device`` (the blocks' own, else the CPU) in
    ``dtype``.
    """

    def __init__(self, sym: str, signature, legs, n=0, blocks=None, dtype=torch.float64,
                 fermionic: bool = False, conj_reversal: bool = False, device=None):
        self.sym = sym
        if sym == "U1xU1" and isinstance(n, int):
            assert n == 0
            n = (0, 0)
        self.signature = tuple(signature)
        self.legs = tuple(legs)
        self.n = n
        self.dtype = dtype
        self.fermionic = fermionic
        self.conj_reversal = conj_reversal
        blocks = dict(blocks) if blocks else {}
        if device is None:
            first = next(iter(blocks.values()), None)
            device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
        keys = sorted(blocks)
        bl = [_as_tensor(blocks[k], dtype, device) for k in keys]
        self.struct = make_struct(len(self.legs), _nsym(sym), keys, [tuple(b.shape) for b in bl])
        self.data = (torch.cat([b.reshape(-1) for b in bl]) if bl
                     else torch.zeros(0, dtype=dtype, device=device))
        self._blocks = None

    @classmethod
    def _flat(cls, like: "AbelianTensor", struct: Struct, data, **meta) -> "AbelianTensor":
        """A tensor over ``struct`` and the flat ``data``, metadata from ``like``
        unless overridden."""
        t = cls.__new__(cls)
        t.sym = meta.get("sym", like.sym)
        t.signature = tuple(meta.get("signature", like.signature))
        t.legs = tuple(meta.get("legs", like.legs))
        t.n = meta.get("n", like.n)
        t.dtype = meta.get("dtype", data.dtype)
        t.fermionic = meta.get("fermionic", like.fermionic)
        t.conj_reversal = meta.get("conj_reversal", like.conj_reversal)
        t.struct = struct
        t.data = data
        t._blocks = None
        return t

    # -------------------------------------------------------------- meta
    @property
    def blocks(self) -> dict:
        """``{charges: view}`` into the flat buffer, in sorted key order."""
        if self._blocks is None:
            s = self.struct
            self._blocks = {k: self.data[int(o):int(o) + int(z)].view(sh)
                            for k, sh, o, z in zip(s.keys, s.shapes, s.offsets, s.sizes)}
        return self._blocks

    @property
    def device(self):
        return self.data.device

    @property
    def ndim(self):
        return len(self.legs)

    def leg_parity(self, i: int, q) -> int:
        return (_parity(self.sym, q) + self.legs[i].pshift) % 2

    def allowed(self, qs) -> bool:
        tot = _qadd(self.sym, *(_qscale(self.sym, s, q) for s, q in zip(self.signature, qs)))
        return tot == self.n

    def block_shape(self, qs):
        return tuple(l.dims[q] for l, q in zip(self.legs, qs))

    def all_allowed_blocks(self):
        for qs in itertools.product(*[[c for c, _ in l.charges] for l in self.legs]):
            if self.allowed(qs):
                yield qs

    def _pshifts(self):
        return tuple(l.pshift for l in self.legs)

    # ------------------------------------------------------------ create
    @classmethod
    def random(cls, generator: torch.Generator, sym, signature, legs, n=0, dtype=torch.float64,
               fermionic=False, device="cpu"):
        """Uniform [-0.5, 0.5) on every allowed block, drawn from ``generator``
        block after block in sorted key order, then moved to ``device``."""
        t = cls(sym, signature, legs, n, dtype=dtype, fermionic=fermionic, device=device)
        blocks = {}
        for qs in sorted(t.all_allowed_blocks()):
            r = torch.rand(t.block_shape(qs), generator=generator, dtype=torch.float64,
                           device=generator.device)
            blocks[qs] = (r - 0.5).to(dtype=dtype, device=device)
        return t.copy_with(blocks)

    def copy_with(self, blocks):
        return AbelianTensor(self.sym, self.signature, self.legs, self.n, blocks, self.dtype,
                             self.fermionic, self.conj_reversal, device=self.device)

    def to(self, device=None, dtype=None) -> "AbelianTensor":
        data = self.data.to(device=device, dtype=dtype)
        return AbelianTensor._flat(self, self.struct, data)

    def numpy_blocks(self) -> dict:
        return {k: v.detach().cpu().numpy() for k, v in self.blocks.items()}

    def _block_scaled(self, scale_of_block) -> torch.Tensor:
        """The flat buffer times a per-block factor (+-1)."""
        sc = torch.as_tensor(np.asarray(scale_of_block, dtype=np.float64), device=self.device)
        return self.data * torch.repeat_interleave(
            sc.to(self.data.real.dtype), torch.as_tensor(self.struct.sizes, device=self.device),
            output_size=self.struct.numel)

    # --------------------------------------------------------------- ops
    def conj(self):
        """Complex conjugate; flips all signatures and the total charge
        (fermionic: the dagger-reversal sign ``(-1)^{k(k-1)/2}`` per block)."""
        data = self.data.conj().resolve_conj() if self.data.is_complex() else self.data
        if (self.fermionic or self.conj_reversal) and self.struct.keys:
            k = _parities(self.struct, self.sym, self._pshifts()).sum(axis=1)
            sc = np.where((k * (k - 1) // 2) % 2, -1.0, 1.0)
            if (sc < 0).any():
                data = AbelianTensor._flat(self, self.struct, data)._block_scaled(sc)
        return AbelianTensor._flat(self, self.struct, data,
                                   signature=tuple(-s for s in self.signature),
                                   n=_qscale(self.sym, -1, self.n))

    def conj_blocks(self):
        """Conjugate block values only (yastn's ``conj_blocks``)."""
        if not self.data.is_complex():
            return self
        return AbelianTensor._flat(self, self.struct, self.data.conj().resolve_conj())

    def flip_charges(self, axes):
        """Flip the signature of the listed legs AND negate their block
        charges (yastn's ``switch_signature``)."""
        axes = tuple(axes)

        def fq(i, q):
            return _qscale(self.sym, -1, q) if i in axes else q

        sig = tuple(-s if i in axes else s for i, s in enumerate(self.signature))
        legs = tuple(
            leg({_qscale(self.sym, -1, q): d for q, d in l.charges}, l.pshift) if i in axes else l
            for i, l in enumerate(self.legs))
        blocks = {tuple(fq(i, q) for i, q in enumerate(qs)): b for qs, b in self.blocks.items()}
        return AbelianTensor(self.sym, sig, legs, self.n, blocks, self.dtype, self.fermionic,
                             self.conj_reversal, device=self.device)

    def charge_conjugate(self):
        """Negate all block charges and the total charge, keeping signatures."""
        legs = tuple(leg({_qscale(self.sym, -1, q): d for q, d in l.charges}, l.pshift)
                     for l in self.legs)
        blocks = {tuple(_qscale(self.sym, -1, q) for q in qs): b for qs, b in self.blocks.items()}
        return AbelianTensor(self.sym, self.signature, legs, _qscale(self.sym, -1, self.n),
                             blocks, self.dtype, self.fermionic, self.conj_reversal,
                             device=self.device)

    def transpose(self, axes):
        """Leg permutation on ``block_permute``; fermionic tensors pick up the
        Grassmann reordering sign per block."""
        axes = tuple(axes)
        meta = dict(signature=tuple(self.signature[a] for a in axes),
                    legs=tuple(self.legs[a] for a in axes))
        if axes == tuple(range(self.ndim)):
            return AbelianTensor._flat(self, self.struct, self.data, **meta)
        scale = key = None
        if self.fermionic and self.struct.keys:
            scale = _perm_signs(_parities(self.struct, self.sym, self._pshifts()), axes)
            key = ("fsign", self.sym, self._pshifts())
        out, table, _ = _permute_plan(self.struct, axes, key, scale)
        return AbelianTensor._flat(self, out, permute_flat(self.data, table, out.numel), **meta)

    def __add__(self, other):
        assert self.signature == other.signature and self.n == other.n
        if self.struct is other.struct:
            return AbelianTensor._flat(self, self.struct, self.data + other.data)
        out = {}
        for q in set(self.blocks) | set(other.blocks):
            a, b = self.blocks.get(q), other.blocks.get(q)
            out[q] = a + b if (a is not None and b is not None) else (a if a is not None else b)
        return self.copy_with(out)

    def __mul__(self, scalar):
        return AbelianTensor._flat(self, self.struct, scalar * self.data)

    __rmul__ = __mul__

    def norm(self):
        return torch.linalg.vector_norm(self.data)

    def max_abs(self):
        return self.data.abs().max()

    # --------------------------------------------------------- tensordot
    def _dot_setup(self, other, axes, out_like):
        """Checks, the plan and the result's metadata of a tensordot."""
        ax_a, ax_b = (tuple(int(x) % t.ndim for x in ax) for ax, t in
                      zip(axes, (self, other)))
        for i, j in zip(ax_a, ax_b):
            if self.sym != "Z2" and self.signature[i] != -other.signature[j]:
                raise ValueError(
                    f"contracted legs ({i},{j}) must carry opposite signatures, "
                    f"got {self.signature[i]} and {other.signature[j]}")
            if (self.fermionic or other.fermionic) and \
                    self.legs[i].pshift != other.legs[j].pshift:
                raise ValueError(f"contracted legs ({i},{j}) carry different parity shifts")
            da, db = self.legs[i].dims, other.legs[j].dims
            for q in set(da) & set(db):
                if da[q] != db[q]:
                    raise ValueError(
                        f"charge-sector dim mismatch on contracted legs ({i},{j}), "
                        f"charge {q}: {da[q]} vs {db[q]}")
        keep_a = [i for i in range(self.ndim) if i not in ax_a]
        keep_b = [i for i in range(other.ndim) if i not in ax_b]
        fermionic = self.fermionic or other.fermionic
        signs = None
        if fermionic and self.struct.keys and other.struct.keys:
            # the graded contraction's three signs, per block (see the JAX
            # package's tensordot): a's contracted legs to the end, b's to
            # the front reversed, the dual-first pairs' annihilation sign
            perm_a = tuple(keep_a) + ax_a
            perm_b = tuple(reversed(ax_b)) + tuple(keep_b)
            dual_a = tuple(
                i for i, j in zip(ax_a, ax_b)
                if (self.signature[i] if self.sym != "Z2" else -other.signature[j]) == -1)
            par_a = _parities(self.struct, self.sym, self._pshifts())
            par_b = _parities(other.struct, self.sym, other._pshifts())
            sa = _perm_signs(par_a, perm_a)
            if dual_a:
                sa = sa * np.where(par_a[:, list(dual_a)].sum(axis=1) % 2, -1.0, 1.0)
            signs = (("fsign", self.sym, self._pshifts(), other._pshifts(), dual_a), sa,
                     _perm_signs(par_b, perm_b))
        plan = _dot_plan(self.struct, other.struct, ax_a, ax_b, signs,
                         None if out_like is None else out_like.struct)
        meta = dict(
            signature=tuple(self.signature[i] for i in keep_a)
            + tuple(other.signature[i] for i in keep_b),
            legs=tuple(self.legs[i] for i in keep_a) + tuple(other.legs[i] for i in keep_b),
            n=_qadd(self.sym, self.n, other.n), fermionic=fermionic,
            conj_reversal=self.conj_reversal or other.conj_reversal)
        return plan, torch.promote_types(self.data.dtype, other.data.dtype), meta

    def _operands(self, other, plan, dtype):
        abuf, bbuf = self.data.to(dtype), other.data.to(dtype)
        if plan.perm_a is not None:
            abuf = permute_flat(abuf, plan.perm_a, abuf.numel())
        if plan.perm_b is not None:
            bbuf = permute_flat(bbuf, plan.perm_b, bbuf.numel())
        return abuf, bbuf

    def dot_operands(self, other, axes, out_like=None):
        """``(plan, A, B)``: a tensordot's plan and its operands as ``block_gemm``
        takes them (blocks permuted to kept-then-contracted legs for ``self``,
        contracted-then-kept for ``other``)."""
        plan, out_dtype, _ = self._dot_setup(other, axes, out_like)
        return (plan, *self._operands(other, plan, out_dtype))

    def tensordot(self, other, axes, out_like: "AbelianTensor | None" = None):
        """Charge-conserving tensordot on K8 (``block_permute`` for the
        operands, one ``block_gemm``).  Contracted legs must carry matching
        charge sectors with opposite signatures; the result's total charge
        is the group sum.  ``out_like``: lay the result out in this tensor's
        block structure (a superset of the produced blocks; the others are
        zero) — the frozen engine's fixed block sets."""
        plan, out_dtype, meta = self._dot_setup(other, axes, out_like)
        # meta buffers: a structure-only run (close_structure)
        out = gemm_flat(*self._operands(other, plan, out_dtype), plan.gemm, plan.out.numel,
                        zero_fill=out_like is not None)
        return AbelianTensor._flat(self, plan.out, out, **meta)

    # ------------------------------------------------------------ fusion
    def fuse_pair(self, i: int):
        """Fuse adjacent legs ``(i, i+1)`` into one leg (the JAX package's
        convention: signature of leg ``i``, constituents ordered by sorted
        ``(q1, q2)``, row-major)."""
        s1, s2 = self.signature[i], self.signature[i + 1]
        sf = s1
        l1, l2 = self.legs[i], self.legs[i + 1]
        sec = {}
        for q1, q2 in sorted((q1, q2) for q1 in l1.dims for q2 in l2.dims):
            qf = _qscale(self.sym, sf,
                         _qadd(self.sym, _qscale(self.sym, s1, q1), _qscale(self.sym, s2, q2)))
            d1, d2 = l1.dims[q1], l2.dims[q2]
            lst = sec.setdefault(qf, [])
            off = sum(e[2] * e[3] for e in lst)
            lst.append((q1, q2, d1, d2, off))
        fused_leg = leg({qf: sum(e[2] * e[3] for e in lst) for qf, lst in sec.items()},
                        (l1.pshift + l2.pshift) % 2)
        offset_of = {(qf, q1, q2): off for qf, lst in sec.items() for q1, q2, _, _, off in lst}
        out_blocks = {}
        for qs, b in self.blocks.items():
            q1, q2 = qs[i], qs[i + 1]
            qf = _qscale(self.sym, sf,
                         _qadd(self.sym, _qscale(self.sym, s1, q1), _qscale(self.sym, s2, q2)))
            qout = qs[:i] + (qf,) + qs[i + 2:]
            sh = tuple(b.shape)
            bm = b.reshape(sh[:i] + (sh[i] * sh[i + 1],) + sh[i + 2:])
            dst = out_blocks.get(qout)
            if dst is None:
                dst = torch.zeros(sh[:i] + (fused_leg.dims[qf],) + sh[i + 2:],
                                  dtype=b.dtype, device=b.device)
                out_blocks[qout] = dst
            off = offset_of[(qf, q1, q2)]
            dst.narrow(i, off, sh[i] * sh[i + 1]).add_(bm)
        sig = self.signature[:i] + (sf,) + self.signature[i + 2:]
        legs_out = self.legs[:i] + (fused_leg,) + self.legs[i + 2:]
        return AbelianTensor(self.sym, sig, legs_out, self.n, out_blocks, self.dtype,
                             self.fermionic, self.conj_reversal, device=self.device)

    # ---------------------------------------------------------- aux legs
    def add_leg(self, axis: int = -1, s: int = -1, q=None, pshift: int = 0):
        """Insert a dim-1 leg carrying charge ``q`` at ``axis`` (yastn's
        ``add_leg``); by default the leg absorbs the total charge."""
        if axis < 0:
            axis = self.ndim + 1 + axis
        if q is None:
            q = _qscale(self.sym, -s, self.n)
        n_new = _qadd(self.sym, self.n, _qscale(self.sym, s, q))
        blocks = {qs[:axis] + (q,) + qs[axis:]: b.reshape(b.shape[:axis] + (1,) + b.shape[axis:])
                  for qs, b in self.blocks.items()}
        sig = self.signature[:axis] + (s,) + self.signature[axis:]
        legs = self.legs[:axis] + (leg({q: 1}, pshift),) + self.legs[axis:]
        return AbelianTensor(self.sym, sig, legs, n_new, blocks, self.dtype, self.fermionic,
                             self.conj_reversal, device=self.device)

    def trace_scalar(self):
        """Graded trace of a rank-2 tensor: ``sum_q tr(B_q)``, with the cap
        sign ``(-1)^p`` where the dual leg comes first."""
        assert self.ndim == 2
        tot = None
        for (q0, _q1), b in self.blocks.items():
            v = torch.trace(b)
            if self.fermionic and _parity(self.sym, q0) and self.signature[0] == -1:
                v = -v
            tot = v if tot is None else tot + v
        return tot

    # ------------------------------------------------------------- dense
    def to_dense(self):
        """Embed into a dense tensor (charge sectors ordered per leg)."""
        shape = tuple(l.total_dim() for l in self.legs)
        out = torch.zeros(shape, dtype=self.data.dtype, device=self.device)
        for qs, b in self.blocks.items():
            sl = tuple(slice(l.offset(q), l.offset(q) + l.dims[q]) for l, q in zip(self.legs, qs))
            out[sl] = b
        return out

    @classmethod
    def from_dense(cls, dense, sym, signature, legs, n=0):
        """Project a dense tensor onto the allowed charge blocks (blocks that
        are all zero are left out)."""
        dense = torch.as_tensor(dense)
        t = cls(sym, signature, legs, n, dtype=dense.dtype, device=dense.device)
        blocks = {}
        for qs in t.all_allowed_blocks():
            sl = tuple(slice(l.offset(q), l.offset(q) + l.dims[q]) for l, q in zip(t.legs, qs))
            blk = dense[sl]
            if bool((blk != 0).any()):
                blocks[qs] = blk
        return t.copy_with(blocks)


# ---------------------------------------------------------------------------
# per-sector matrices and the blockwise decompositions
# ---------------------------------------------------------------------------


@dataclass
class SectorPlan:
    """Layout of a tensor's per-charge-sector matrices over (rows | cols)."""

    tp_signature: tuple
    tp_legs: tuple
    nrow: int
    sectors: dict   # qsec -> (row_keys, col_keys, row_dims, col_dims, row_off, col_off, base, R, C)
    numel: int
    table: PermuteTable


def _sector_plan(t: AbelianTensor, row_axes, col_axes) -> SectorPlan:
    row_axes, col_axes = tuple(row_axes), tuple(col_axes)
    axes = row_axes + col_axes
    nrow = len(row_axes)
    s = t.struct
    fkey = ("fsign", t.sym, t._pshifts()) if t.fermionic else None

    def build():
        sig = tuple(t.signature[a] for a in axes)
        legs = tuple(t.legs[a] for a in axes)
        ch = s.charges[:, list(axes), :]
        dims = s.dims[:, list(axes)]
        if nrow > 1:
            qs = (ch[:, :nrow, :] * np.asarray(sig[:nrow])[None, :, None]).sum(axis=1)
        else:
            qs = ch[:, 0, :] * sig[0]
        if t.sym == "Z2":
            qs = qs % 2
        sec_keys = [q[0] for q in qs.tolist()] if s.nsym == 1 else [tuple(q) for q in qs.tolist()]
        rkeys = _rows_to_keys(ch[:, :nrow, :], s.nsym)
        ckeys = _rows_to_keys(ch[:, nrow:, :], s.nsym)
        rsize = dims[:, :nrow].prod(axis=1)
        csize = dims[:, nrow:].prod(axis=1)
        by_sec = {}
        for i, q in enumerate(sec_keys):
            by_sec.setdefault(q, []).append(i)
        sectors, base = {}, 0
        doff = np.zeros(len(sec_keys), dtype=np.int64)
        dstr = np.zeros((len(sec_keys), len(axes)), dtype=np.int64)
        rstr = contiguous_strides(dims[:, :nrow]) if nrow else np.zeros((len(dims), 0), np.int64)
        cstr = (contiguous_strides(dims[:, nrow:]) if len(axes) > nrow
                else np.zeros((len(dims), 0), np.int64))
        for q in sorted(by_sec, key=lambda x: (str(type(x)), x)):
            items = by_sec[q]
            row_keys = sorted({rkeys[i] for i in items})
            col_keys = sorted({ckeys[i] for i in items})
            row_dims = {rkeys[i]: int(rsize[i]) for i in items}
            col_dims = {ckeys[i]: int(csize[i]) for i in items}
            row_off, off = {}, 0
            for rk in row_keys:
                row_off[rk] = off
                off += row_dims[rk]
            col_off, offc = {}, 0
            for ck in col_keys:
                col_off[ck] = offc
                offc += col_dims[ck]
            R, C = off, offc
            for i in items:
                doff[i] = base + row_off[rkeys[i]] * C + col_off[ckeys[i]]
                dstr[i, :nrow] = rstr[i] * C
                dstr[i, nrow:] = cstr[i]
            sectors[q] = (row_keys, col_keys, row_dims, col_dims, row_off, col_off, base, R, C)
            base += R * C
        scale = None
        if t.fermionic:
            scale = _perm_signs(_parities(s, t.sym, t._pshifts()), axes)
        table = PermuteTable(s.offsets, doff, dims, contiguous_strides(s.dims)[:, list(axes)],
                             dstr, scale)
        return SectorPlan(sig, legs, nrow, sectors, base, table)

    return PLANS.get_or(("sector", s, axes, nrow, tuple(t.signature), t.legs, fkey), build)


def _sector_matrices(t: AbelianTensor, row_axes, col_axes):
    """Dense per-charge-sector matrices of ``t`` over (row_axes | col_axes),
    gathered by one ``block_permute`` into one buffer.

    :return: ``(plan, {qsec: (row_keys, col_keys, row_dims, col_dims,
        row_off, col_off, M)})``
    """
    plan = _sector_plan(t, row_axes, col_axes)
    buf = permute_flat(t.data, plan.table, plan.numel, zero_fill=True)
    out = {}
    for q, (rk, ck, rd, cd, ro, co, base, R, C) in plan.sectors.items():
        out[q] = (rk, ck, rd, cd, ro, co, buf[base:base + R * C].view(R, C))
    return plan, out


def _assemble(struct: Struct, entries, src, dtype, device):
    """Blocks of ``struct`` copied from the flat ``src``: ``entries`` is a list
    of ``(key, src offset, shape, src strides)`` (each block's own shape,
    row-major); one ``block_permute``."""
    idx = np.array([struct.index[k] for k, *_ in entries], dtype=np.int64)
    rank = max(len(e[2]) for e in entries)
    shape = np.array([e[2] for e in entries], dtype=np.int64).reshape(len(entries), rank)
    table = PermuteTable([e[1] for e in entries], struct.offsets[idx], shape,
                         np.array([e[3] for e in entries], dtype=np.int64).reshape(len(entries), rank),
                         contiguous_strides(shape))
    return permute_flat(src.to(dtype=dtype, device=device), table, struct.numel)


def _isometry(t: AbelianTensor, plan: SectorPlan, cols: dict, new_leg, sig_last=-1, n=0):
    """The isometry tensor with legs (rows..., new) whose sector ``q`` block
    rows are the columns ``cols[q]`` (R_q x k_q) of that sector."""
    nrow = plan.nrow
    keys, shapes, entries, parts, base = [], [], [], [], 0
    for q in sorted(cols, key=lambda x: (str(type(x)), x)):
        Uq = cols[q]
        k = Uq.shape[1]
        rk_list, _ck, row_dims, _cd, row_off = plan.sectors[q][:5]
        parts.append(Uq.contiguous().reshape(-1))
        for rk in rk_list:
            bshape = tuple(plan.tp_legs[i].dims[rk[i]] for i in range(nrow)) + (k,)
            keys.append(rk + (q,))
            shapes.append(bshape)
            entries.append((rk + (q,), base + row_off[rk] * k, (row_dims[rk] * k,), (1,)))
        base += Uq.numel()
    struct = make_struct(nrow + 1, _nsym(t.sym), keys, shapes)
    src = (torch.cat(parts) if parts and not t.data.is_meta
           else torch.empty(base, dtype=t.data.dtype, device=t.device))
    data = (_assemble(struct, entries, src, src.dtype, t.device) if entries
            else torch.zeros(0, dtype=t.data.dtype, device=t.device))
    return AbelianTensor._flat(t, struct, data, signature=plan.tp_signature[:nrow] + (sig_last,),
                               legs=plan.tp_legs[:nrow] + (new_leg,), n=n, conj_reversal=False)


def _co_isometry(t: AbelianTensor, plan: SectorPlan, rows: dict, new_leg, n):
    """The tensor with legs (new, cols...) whose sector ``q`` block columns
    are the rows ``rows[q]`` (k_q x C_q) of that sector; returns it and its
    structure's keys in ``(qsec, col key)`` form."""
    nrow = plan.nrow
    keys, shapes, entries, parts, base = [], [], [], [], 0
    for q in sorted(rows, key=lambda x: (str(type(x)), x)):
        Vq = rows[q].contiguous()
        k, C = Vq.shape
        _rk, ck_list, _rd, col_dims, _ro, col_off = plan.sectors[q][:6]
        parts.append(Vq.reshape(-1))
        for ck in ck_list:
            bshape = (k,) + tuple(plan.tp_legs[nrow + i].dims[ck[i]] for i in range(len(ck)))
            keys.append((q,) + ck)
            shapes.append(bshape)
            entries.append(((q,) + ck, base + col_off[ck], (k, col_dims[ck]), (C, 1)))
        base += Vq.numel()
    struct = make_struct(len(plan.tp_legs) - nrow + 1, _nsym(t.sym), keys, shapes)
    src = (torch.cat(parts) if parts and not t.data.is_meta
           else torch.empty(base, dtype=t.data.dtype, device=t.device))
    data = (_assemble(struct, entries, src, src.dtype, t.device) if entries
            else torch.zeros(0, dtype=t.data.dtype, device=t.device))
    return AbelianTensor._flat(t, struct, data, signature=(1,) + plan.tp_signature[nrow:],
                               legs=(new_leg,) + plan.tp_legs[nrow:], n=n, conj_reversal=False)


def _global_cut(all_vals, chi, reltol, eps_multiplet):
    """Global cross-sector truncation by magnitude with reltol filter and
    multiplet-safe boundary retreat.  ``all_vals``: [(|v|, qsec, i)]."""
    all_vals.sort(key=lambda x: -x[0])
    vmax = all_vals[0][0] if all_vals else 0.0
    if reltol > 0.0:
        all_vals = [e for e in all_vals if e[0] > reltol * vmax]
    if chi is not None and len(all_vals) > chi:
        cut = chi
        if eps_multiplet > 0.0:
            while cut > 1 and abs(all_vals[cut - 1][0] - all_vals[cut][0]) < eps_multiplet * vmax:
                cut -= 1
        all_vals = all_vals[:cut]
    keep = {}
    for _, qsec, i in all_vals:
        keep.setdefault(qsec, []).append(i)
    return keep


def _rows_pshift(plan: SectorPlan) -> int:
    return sum(l.pshift for l in plan.tp_legs[:plan.nrow]) % 2


def eigh_blockwise(t: AbelianTensor, row_axes, col_axes, chi=None, reltol: float = 0.0,
                   eps_multiplet: float = 0.0):
    """Truncated spectral decomposition of a hermitian AbelianTensor over
    (row_axes | col_axes) with a global cross-sector cut by |eigenvalue|:
    one eigh for the self-paired sector, one SVD per +-q pair (the partner's
    isometry is the right-singular basis of the same block; ``svd_reg``'s
    driver on the card).  Every sector's spectrum is read to the host for
    the cut.

    :return: ``(U, W_dict)`` — isometry with a new last leg and the kept
        values (signed for the self-paired sector).
    """
    plan, sector_mats = _sector_matrices(t, row_axes, col_axes)
    all_vals, sector_data, done = [], {}, set()
    for qsec in sector_mats:
        if qsec in done:
            continue
        M = sector_mats[qsec][6]
        qneg = _qscale(t.sym, -1, qsec)
        if qneg == qsec:
            H = 0.5 * (M + M.mH)
            W, U = torch.linalg.eigh(H)
            order = torch.argsort(-W.abs(), stable=True)
            W, U = W[order], U[:, order]
            sector_data[qsec] = (W, U)
            all_vals.extend((abs(w), qsec, i) for i, w in enumerate(W.tolist()))
            done.add(qsec)
        else:
            U, S, Vh = svd_reg(M)
            sector_data[qsec] = (S, U)
            svals = S.tolist()
            all_vals.extend((x, qsec, i) for i, x in enumerate(svals))
            done.add(qsec)
            if qneg in sector_mats:
                sector_data[qneg] = (S, Vh.mH)
                all_vals.extend((x, qneg, i) for i, x in enumerate(svals))
                done.add(qneg)
    keep = _global_cut(all_vals, chi, reltol, eps_multiplet)
    cols, W_out = {}, {}
    for qsec, idxs in keep.items():
        W, U = sector_data[qsec]
        ii = torch.as_tensor(sorted(idxs), device=U.device)
        W_out[qsec] = W[ii]
        cols[qsec] = U[:, ii]
    new_leg = leg({q: c.shape[1] for q, c in cols.items()}, _rows_pshift(plan))
    return _isometry(t, plan, cols, new_leg), W_out


def svd_blockwise(t: AbelianTensor, row_axes, col_axes, chi=None, reltol: float = 0.0,
                  eps_multiplet: float = 0.0):
    """Truncated SVD of an AbelianTensor over (row_axes | col_axes):
    per-sector SVD and a global cut across sectors by singular value.

    :return: ``(U, S_dict, V)`` with a new internal leg.
    """
    plan, sector_mats = _sector_matrices(t, row_axes, col_axes)
    all_svals, sector_data = [], {}
    for qsec, item in sector_mats.items():
        U, S, Vh = svd_reg(item[6])
        sector_data[qsec] = (U, S, Vh)
        all_svals.extend((s, qsec, i) for i, s in enumerate(S.tolist()))
    keep = _global_cut(all_svals, chi, reltol, eps_multiplet)
    ucols, vrows, S_out = {}, {}, {}
    for qsec, idxs in keep.items():
        U, S, Vh = sector_data[qsec]
        ii = torch.as_tensor(sorted(idxs), device=U.device)
        S_out[qsec] = S[ii]
        ucols[qsec] = U[:, ii]
        vrows[qsec] = Vh[ii, :]
    return _finish_svd(t, plan, ucols, S_out, vrows)


def _finish_svd(t, plan, ucols, S_out, vrows):
    """``(U, S, V)`` tensors from per-sector kept columns and rows (shared by
    the dynamic and the frozen SVD)."""
    rows_pshift = _rows_pshift(plan)
    new_leg = leg({q: c.shape[1] for q, c in ucols.items()}, rows_pshift)
    if t.fermionic:
        # graded reconstruction sign (see the JAX package's svd_blockwise):
        # absorbed into V so that U.S.V == T under the graded contraction
        vrows = {q: (-r if (_parity(t.sym, q) + rows_pshift) % 2 else r) for q, r in vrows.items()}
    U_t = _isometry(t, plan, ucols, new_leg)
    V_t = _co_isometry(t, plan, vrows, new_leg, t.n)
    return U_t, S_out, V_t
