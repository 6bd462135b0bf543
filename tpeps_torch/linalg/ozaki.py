"""Ozaki-scheme float64 matrix products from exact int8 digit products
(counterpart of tpeps/linalg/ozaki.py).

Each row of ``A`` and column of ``B`` is scaled by a power of two, its
mantissa cut into ``s`` signed ``w``-bit digits (int8), and the digit pairs
with ``p + q <= s + 1`` multiplied exactly (int8 x int8 -> int32, the K7
kernel ``ozaki_gemm`` on the H100's tensor cores) and recombined in float64;
the relative error is ~ ``K 2^(-s w)`` (s=8, w=7: f64-class at K ~ 1e4).
The H100 has native FP64, so in the port this is the API-parity option of
the JAX package's ``dot_impl="ozaki[:s]"``, not a speed lever.

:func:`ozaki_matmul` is differentiable (its backward is the same split
product); :func:`ozaki_presplit` is forward-only and raises on an input that
requires grad, where the JAX package silently drops its tangent.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from ..kernels.ozaki import ozaki_gemm, ozaki_split


def _split_int8(X, s: int, w: int, axis: int):
    """Digit planes and exponents of ``X``'s rows (``axis=1``) or columns
    (``axis=0``) on the ``ozaki_split`` kernel."""
    return ozaki_split(X.contiguous(), s, w, axis)


def _check_k(k, w):
    if k >= 1 << (31 - 2 * w):
        raise ValueError(
            f"contraction dim {k} overflows exact int32 "
            f"accumulation for word_bits={w}"
        )


def _accumulate(Ac, ea, Bc, eb, s: int, w: int):
    """Digit products -> float64 result on the ``ozaki_gemm`` kernel
    (float64 groups, then the float32 tail of the groups below 2^-28)."""
    if Ac.shape[0] != s or Bc.shape[0] != s:
        raise ValueError(f"expected {s} digit planes, got {Ac.shape[0]} and {Bc.shape[0]}")
    return ozaki_gemm(Ac, ea, Bc, eb, w)


def _forward_only(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only: its int8 digits carry no gradient "
                           "(use ozaki_matmul for a differentiable product)")


def ozaki_presplit(A, slices: int = 8, word_bits: int = 7):
    """Split a 2-D left operand once for reuse across many products (the
    factored corner applied to several subspace iterates per move).  Returns
    ``(Ac, ea)`` for :func:`ozaki_matmul_presplit`.

    :raises RuntimeError: if ``A`` requires grad (the split has no gradient)
    """
    _forward_only("ozaki_presplit", A)
    _check_k(A.shape[-1], word_bits)
    return _split_int8(A.detach(), slices, word_bits, axis=1)


def ozaki_matmul_presplit(Ac, ea, B, slices: int = 8, word_bits: int = 7):
    """``A @ B`` where A was pre-split by :func:`ozaki_presplit`."""
    _forward_only("ozaki_matmul_presplit", B)
    Bc, eb = _split_int8(B.detach(), slices, word_bits, axis=0)
    return _accumulate(Ac, ea, Bc, eb, slices, word_bits)


def _matmul(A, B, s: int, w: int):
    _check_k(A.shape[-1], w)
    Ac, ea = _split_int8(A, s, w, axis=1)
    Bc, eb = _split_int8(B, s, w, axis=0)
    return _accumulate(Ac, ea, Bc, eb, s, w)


class _OzakiMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B, s, w):
        ctx.save_for_backward(A, B)
        ctx.sw = (s, w)
        return _matmul(A.detach(), B.detach(), s, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, dC):
        # the adjoint of a matmul is a matmul: the same exact-split path
        A, B = (t.detach() for t in ctx.saved_tensors)
        s, w = ctx.sw
        dC = dC.detach()
        dA = _matmul(dC, B.mT, s, w) if ctx.needs_input_grad[0] else None
        dB = _matmul(A.mT, dC, s, w) if ctx.needs_input_grad[1] else None
        return dA, dB, None, None


def ozaki_matmul(A, B, slices: int = 8, word_bits: int = 7):
    """``A @ B`` for float64 matrices via exact int8 digit products.

    :param A: ``(m, k)`` float64
    :param B: ``(k, n)`` float64
    :param slices: digits per operand; relative error ~ ``K 2^(-slices word_bits)``
    :return: ``(m, n)`` float64
    """
    return _OzakiMatmul.apply(A, B, slices, word_bits)


def ozaki_dot_general(a, b, dimension_numbers, slices: int = 8, word_bits: int = 7):
    """float64 ``lax.dot_general`` via :func:`ozaki_matmul`: contracting and
    batch dims are collapsed to one 2-D product per batch element (a loop
    over the collapsed batch axis).  Output axes: batch, free of ``a``, free
    of ``b``."""
    (ca, cb), (ba, bb) = dimension_numbers
    ca, cb, ba, bb = tuple(ca), tuple(cb), tuple(ba), tuple(bb)
    free_a = tuple(i for i in range(a.dim()) if i not in ca + ba)
    free_b = tuple(i for i in range(b.dim()) if i not in cb + bb)
    at = a.permute(ba + free_a + ca)
    bt = b.permute(bb + cb + free_b)
    bshape = tuple(a.shape[i] for i in ba)
    m = math.prod(a.shape[i] for i in free_a)
    k = math.prod(a.shape[i] for i in ca)
    n = math.prod(b.shape[i] for i in free_b)
    out_shape = bshape + tuple(a.shape[i] for i in free_a) + tuple(b.shape[i] for i in free_b)
    if bshape:
        nb = math.prod(bshape)
        a2, b2 = at.reshape(nb, m, k), bt.reshape(nb, k, n)
        out = torch.stack([ozaki_matmul(a2[i], b2[i], slices, word_bits) for i in range(nb)])
    else:
        out = ozaki_matmul(at.reshape(m, k), bt.reshape(k, n), slices, word_bits)
    return out.reshape(out_shape)
