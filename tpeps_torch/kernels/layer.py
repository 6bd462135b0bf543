"""K1/K4 layer contraction (``csrc/layer_contract.cu``) and its twin.

``layer_contract(W, X, Y, n_k)`` computes ``Y[p..., n...] (+)= sum_k
W[p, k] X[k..., n...]`` where ``X`` and ``Y`` are strided views: the first
``n_k`` axes of ``X`` are the contracted axes, the trailing axes of ``X``
and ``Y`` are the free ones, the leading axes of ``Y`` index the rows of
``W``.  The strides carry all layout changes, so the caller never
materialises a transpose.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, route, stream_of, suffix
from .build import library


class _LayerGeom(ctypes.Structure):
    """Mirror of ``struct LayerGeom`` in ``layer_contract.cu``."""

    _fields_ = [
        ("K", ctypes.c_int64), ("P", ctypes.c_int64), ("N", ctypes.c_int64),
        ("kd", ctypes.c_int64 * 3), ("xk", ctypes.c_int64 * 3),
        ("pd", ctypes.c_int64 * 3), ("yp", ctypes.c_int64 * 3),
        ("nd", ctypes.c_int64 * 4), ("xn", ctypes.c_int64 * 4), ("yn", ctypes.c_int64 * 4),
    ]


def _pad(vals, n, fill):
    return (ctypes.c_int64 * n)(*([fill] * (n - len(vals)) + list(vals)))


def _is_dense(t: torch.Tensor) -> bool:
    """True if ``t`` covers its storage span exactly once (a permutation of
    a contiguous layout), i.e. writes through it never overlap."""
    dims = sorted((s, n) for s, n in zip(t.stride(), t.shape) if n > 1)
    expect = 1
    for s, n in dims:
        if s != expect:
            return False
        expect *= n
    return True


def _check(W, X, Y, n_k):
    if W.dim() != 2 or not W.is_contiguous():
        raise ValueError("layer_contract: W must be a contiguous (P, K) matrix")
    n_n = X.dim() - n_k
    n_p = Y.dim() - n_n
    if not (1 <= n_k <= 3 and 1 <= n_p <= 3 and 1 <= n_n <= 4):
        raise ValueError(f"layer_contract: {n_k} k-axes, {n_p} p-axes, {n_n} n-axes "
                         "(at most 3, 3, 4)")
    if tuple(X.shape[n_k:]) != tuple(Y.shape[n_p:]):
        raise ValueError(f"layer_contract: free axes differ, X {tuple(X.shape)} "
                         f"Y {tuple(Y.shape)}")
    if math.prod(X.shape[:n_k]) != W.shape[1] or math.prod(Y.shape[:n_p]) != W.shape[0]:
        raise ValueError(f"layer_contract: W {tuple(W.shape)} does not match "
                         f"X {tuple(X.shape)} / Y {tuple(Y.shape)}")
    return n_p


def layer_contract_twin(W, X, Y, n_k: int, accumulate: bool = False):
    """Plain torch version: one matmul on the reshaped views."""
    r = (W @ X.reshape(W.shape[1], -1)).reshape(Y.shape)
    if accumulate:
        Y.add_(r)
    else:
        Y.copy_(r)
    return Y


def layer_contract(W, X, Y, n_k: int, accumulate: bool = False):
    """``Y[p..., n...] (+)= sum_k W[p, k] X[k..., n...]``; returns ``Y``."""
    n_p = _check(W, X, Y, n_k)
    if not route("layer_contract", W, X, Y):
        return layer_contract_twin(W, X, Y, n_k, accumulate)
    if not _is_dense(Y):
        raise ValueError("layer_contract: the output view overlaps itself or has gaps")
    if any(s < 0 for s in X.stride()):
        raise ValueError("layer_contract: negative strides")
    n_shape = X.shape[n_k:]
    g = _LayerGeom(
        K=W.shape[1], P=W.shape[0], N=math.prod(n_shape),
        kd=_pad(X.shape[:n_k], 3, 1), xk=_pad(X.stride()[:n_k], 3, 0),
        pd=_pad(Y.shape[:n_p], 3, 1), yp=_pad(Y.stride()[:n_p], 3, 0),
        nd=_pad(n_shape, 4, 1), xn=_pad(X.stride()[n_k:], 4, 0),
        yn=_pad(Y.stride()[n_p:], 4, 0),
    )
    lib = library()
    with torch.cuda.device(W.device):
        # a W too large for shared memory comes back as cudaErrorInvalidValue
        err = getattr(lib.cdll, f"tpeps_layer_contract_{suffix(W)}")(
            W.data_ptr(), X.data_ptr(), Y.data_ptr(), ctypes.byref(g), int(accumulate),
            stream_of(W))
    lib.check(err, "layer_contract")
    LAUNCHES["layer_contract"] += 1
    return Y
