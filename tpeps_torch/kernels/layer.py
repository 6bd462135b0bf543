"""K1/K4 fused double layer (``csrc/double_layer.cu``) and its twin.

``double_layer(a, X6, out)`` computes

    out[f,g,e,r,j,i] = sum_{s,v,m} conj(a)[s,v,m,f,g] sum_{u,l} a[s,u,l,e,r] X6[l,m,j,u,v,i]

for the on-site tensor ``a[s,u,l,e,r]``, a strided view ``X6`` in
(l,m,j,u,v,i) order and a strided view ``out`` in (f,g,e,r,j,i) order of the
caller's buffer, so the caller never materialises a transpose.  On the card
it is one launch: the ket layer's intermediate never reaches device memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, route, stream_of, suffix
from .build import library

MAX_BOND, MAX_PHYS = 7, 2  # the kernel's template instances and its ket tiling


class _DLGeom(ctypes.Structure):
    """Mirror of ``struct DLGeom`` in ``double_layer.cu``."""

    _fields_ = [("nj", ctypes.c_int64), ("ni", ctypes.c_int64),
                ("xs", ctypes.c_int64 * 6), ("os", ctypes.c_int64 * 6),
                ("order", ctypes.c_int32 * 5), ("d", ctypes.c_int32), ("D", ctypes.c_int32),
                ("vec", ctypes.c_int32), ("bulk", ctypes.c_int32)]


def store_order(out) -> tuple:
    """The tile axes of ``out`` (0 f, 1 g, 2 e, 3 r, 4 i) by ascending
    stride: the kernel writes a finished tile in this order."""
    strides = [out.stride(ax) for ax in (0, 1, 2, 3, 5)]
    return tuple(sorted(range(5), key=lambda q: (strides[q], q)))


def vector_rows(X6) -> bool:
    """True if every row of X6 along i starts 16 bytes aligned (unit stride
    along i, every other stride a multiple of 16 bytes, the base aligned):
    the kernel then copies X by 16 bytes."""
    vec = 16 // X6.element_size()
    return (X6.stride(5) == 1 and all(st % vec == 0 for st in X6.stride()[:5])
            and X6.data_ptr() % 16 == 0)


def bulk_runs(out) -> bool:
    """True if out's (i, r, g) runs of a tile are contiguous and start 16
    bytes aligned (g unit stride, r stride D, i stride D^2, the other
    strides multiples of 16 bytes, the base aligned): the kernel then
    stores a tile's runs by bulk copies (both call sites of the move)."""
    D, vec = out.shape[0], 16 // out.element_size()
    s = out.stride()
    return (s[1] == 1 and s[3] == D and s[5] == D * D
            and all(x % vec == 0 for x in (s[0], s[2], s[4])) and out.data_ptr() % 16 == 0)


def _no_overlap(t: torch.Tensor) -> bool:
    """True if no two index tuples of ``t`` address one element: sorted by
    stride, each axis steps over the whole span of the ones before it."""
    span = 1
    for s, n in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n > 1):
        if s < span:
            return False
        span = s * n
    return True


def _check(a, X6, out):
    if a.dim() != 5 or len(set(a.shape[1:])) != 1:
        raise ValueError(f"double_layer: a must be (d, D, D, D, D), got {tuple(a.shape)}")
    d, D = a.shape[0], a.shape[1]
    if X6.dim() != 6 or (X6.shape[0], X6.shape[1], X6.shape[3], X6.shape[4]) != (D,) * 4:
        raise ValueError(f"double_layer: X6 must be (l,m,j,u,v,i) with bond axes of {D}, "
                         f"got {tuple(X6.shape)}")
    nj, ni = X6.shape[2], X6.shape[5]
    if tuple(out.shape) != (D, D, D, D, nj, ni):
        raise ValueError(f"double_layer: out must be (f,g,e,r,j,i) = {(D,) * 4 + (nj, ni)}, "
                         f"got {tuple(out.shape)}")
    return d, D, nj, ni


def double_layer_twin(a, X6, out, slice_phys: bool = False):
    """Plain torch version: the ket and the bra as two products, as the JAX
    package writes them (``slice_phys``: one pair per physical index,
    summed)."""
    if not slice_phys:
        q = torch.tensordot(a, X6, dims=([1, 2], [3, 0]))  # (s,e,r) + (m,j,v,i)
        out.copy_(torch.tensordot(a.conj(), q, dims=([0, 1, 2], [0, 5, 3])))
        return out
    acc = None
    for s in range(a.shape[0]):
        qs = torch.tensordot(a[s], X6, dims=([0, 1], [3, 0]))  # (e,r) + (m,j,v,i)
        ms = torch.tensordot(a[s].conj(), qs, dims=([0, 1], [4, 2]))  # (f,g) + (e,r,j,i)
        acc = ms if acc is None else acc + ms
    out.copy_(acc)
    return out


def double_layer(a, X6, out, slice_phys: bool = False):
    """``out[f,g,e,r,j,i] = sum conj(a)[s,v,m,f,g] a[s,u,l,e,r] X6[l,m,j,u,v,i]``;
    returns ``out``.  ``slice_phys`` selects the twin's form (the JAX
    package's two); the kernel contracts the physical index inside either
    way."""
    d, D, nj, ni = _check(a, X6, out)
    if not route("double_layer", a, X6, out):
        return double_layer_twin(a, X6, out, slice_phys)
    if D > MAX_BOND or d > MAX_PHYS:
        raise ValueError(f"double_layer: the kernel takes D <= {MAX_BOND} and d <= {MAX_PHYS}, "
                         f"got D={D}, d={d}")
    if not _no_overlap(out):
        raise ValueError("double_layer: the output view overlaps itself")
    if any(s < 0 for s in X6.stride() + out.stride()):
        raise ValueError("double_layer: negative strides")
    Wk = a.permute(0, 3, 4, 1, 2).reshape(d * D * D, D * D).contiguous()  # (s,e,r) x (u,l)
    WbT = a.conj().permute(0, 2, 1, 3, 4).reshape(d * D * D, D * D).contiguous()  # (s,m,v) x (f,g)
    g = _DLGeom(nj=nj, ni=ni, xs=(ctypes.c_int64 * 6)(*X6.stride()),
                os=(ctypes.c_int64 * 6)(*out.stride()),
                order=(ctypes.c_int32 * 5)(*store_order(out)), d=d, D=D,
                vec=int(vector_rows(X6)), bulk=int(bulk_runs(out)))
    lib = library()
    with torch.cuda.device(a.device):
        err = getattr(lib.cdll, f"tpeps_double_layer_{suffix(a)}")(
            Wk.data_ptr(), WbT.data_ptr(), X6.data_ptr(), out.data_ptr(), ctypes.byref(g),
            stream_of(a))
    lib.check(err, "double_layer")
    LAUNCHES["double_layer"] += 1
    return out
