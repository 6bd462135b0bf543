"""Subspace-projector building blocks, forward only (counterpart of
tpeps/linalg/power.py).

CholeskyQR runs through the K3 kernels (:mod:`tpeps_torch.kernels.cholqr`):
the Gram matrix with its ridge and the tall triangular solve are
hand-written; the k x k Cholesky is cuSOLVER's.  The k x k polar factor
and Procrustes alignment are torch ops (the eigh is cuSOLVER's).  The
closed-form polar JVP comes with the gradient slice.
"""

from __future__ import annotations

import torch

from ..kernels.cholqr import gram_ridge, trsm_right_lower_h
from .eigh import eigh_desc


def polar_unitary(O, reg: float = 1.0e-12):
    """Unitary factor of the polar decomposition ``O = W H`` via
    ``W = O (O^H O)^{-1/2}`` with an eigh-based inverse square root."""
    H = O.mH @ O
    w, V = eigh_desc(H, reg)
    w0 = torch.clamp(w[0], min=1e-300)
    keep = w > 1e-24 * w0
    inv_sqrt = torch.where(keep, torch.rsqrt(torch.where(keep, w, torch.ones_like(w))),
                           torch.zeros_like(w))
    W = O @ (V * inv_sqrt[None, :].to(V.dtype)) @ V.mH
    # Guard 1: an ill-conditioned overlap (first sweep against a cold-start
    # basis, or a rank jump between sweeps) would make W rank-deficient,
    # collapse environment directions and permanently break exact spectral
    # multiplets.  A gauge rotation may degrade to identity for one move; a
    # non-unitary one may not.
    cond_ok = w[-1] > 1e-20 * w0
    # Guard 2: an eigh that returns non-finite values on a (near-)singular
    # input must not reach the environment.
    ok = torch.isfinite(torch.view_as_real(W) if W.is_complex() else W).all()
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    return torch.where(ok & cond_ok, W, eye)


def procrustes_align(P, P_ref, col_mask=None):
    """Unitary Procrustes alignment of an orthonormal basis onto a reference:
    ``W`` is the unitary polar factor of ``O = P^H P_ref``.

    :param col_mask: optional 0/1 vector of the KEPT columns of ``P``; the
        alignment is then block-diagonal w.r.t. the mask, so ``P @ W`` keeps
        the exactly-zero columns of a truncated multiplet.
    :return: ``(P @ W, W)``
    """
    O = P.mH @ P_ref
    eye = torch.eye(O.shape[0], dtype=O.dtype, device=O.device)
    if col_mask is not None:
        m = col_mask.to(O.real.dtype)
        O = O * (m[:, None] * m[None, :]) + (1.0 - m)[:, None] * eye
    # ridge toward identity: completes the null space of the overlap so W
    # stays unitary when either basis has zero columns
    O = O + 1e-12 * eye
    W = polar_unitary(O)
    return P @ W, W


def cholesky_qr(P, eps: float = 0.0):
    """Orthonormalize the columns of a tall matrix via Cholesky-QR:
    ``G = P^H P (+ ridge)``, ``L = chol(G)``, ``Q = P L^{-H}``."""
    G = gram_ridge(P, eps)
    L, info = torch.linalg.cholesky_ex(G)
    # a failed factorization becomes NaN, as in the JAX package, and surfaces
    # as a non-finite spectrum in the CTMRG loop; reading `info` here would
    # stall the host on every call.  The solve reads L row-major.
    L = torch.where(info == 0, L, torch.full_like(L, float("nan"))).contiguous()
    return trsm_right_lower_h(L, P)


def cholesky_qr2(P, eps: float = 1.0e-12):
    """Two-pass CholeskyQR; the ridge keeps rank-deficient blocks (cold
    starts, masked multiplets) finite."""
    return cholesky_qr(cholesky_qr(P, eps=eps), eps=eps)


def cold_start_basis(n: int, chi: int, dtype=torch.float64, device="cpu"):
    """Deterministic full-rank cold-start basis (identity columns)."""
    return torch.eye(n, chi, dtype=dtype, device=device)
