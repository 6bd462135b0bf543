"""Subspace-projector building blocks and their gradients (counterpart of
tpeps/linalg/power.py).

CholeskyQR runs through the K3 kernels (:mod:`tpeps_torch.kernels.cholqr`):
the Gram matrix with its ridge and the tall triangular solve are
hand-written, the k x k Cholesky is cuSOLVER's with torch's own gradient.
The polar factor of the Procrustes alignment is the K6 kernel
(:mod:`tpeps_torch.kernels.polar`), its overlap the two-operand Gram.  Each
kernel sits in an ``autograd.Function`` whose backward is a kernel too (the
tall products by a k x k matrix stay ``torch.matmul``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..kernels.cholqr import gram, gram_ridge, trsm_right_lower, trsm_right_lower_h
from ..kernels.polar import polar_unitary as polar_unitary_kernel
from ..kernels.polar import polar_vjp
from .eigh import eigh_desc, multiplet_mask


class _GramRidge(torch.autograd.Function):
    """``G = P^H P + eps tr(P^H P)/k I``."""

    @staticmethod
    def forward(ctx, P, eps):
        ctx.save_for_backward(P)
        ctx.eps = eps
        return gram_ridge(P.detach().contiguous(), eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, gG):
        (P,) = ctx.saved_tensors
        S = gG + gG.mH
        if ctx.eps:
            k = P.shape[1]
            ridge = 2.0 * ctx.eps / k * torch.diagonal(gG).real.sum()
            S = S + ridge * torch.eye(k, dtype=S.dtype, device=S.device)
        return P.detach() @ S, None


class _Gram(torch.autograd.Function):
    """``G = A^H B`` (two operands)."""

    @staticmethod
    def forward(ctx, A, B):
        ctx.save_for_backward(A, B)
        return gram(A.detach().contiguous(), B.detach().contiguous())

    @staticmethod
    @once_differentiable
    def backward(ctx, gG):
        A, B = ctx.saved_tensors
        gA = B.detach() @ gG.mH if ctx.needs_input_grad[0] else None
        gB = A.detach() @ gG if ctx.needs_input_grad[1] else None
        return gA, gB


class _TrsmRightLowerH(torch.autograd.Function):
    """``Q`` with ``Q L^H = P``; backward ``P_bar = Q_bar L^-1`` and
    ``L_bar = -tril(P_bar^H Q)``."""

    @staticmethod
    def forward(ctx, L, P):
        Q = trsm_right_lower_h(L.detach().contiguous(), P.detach().contiguous())
        ctx.save_for_backward(L, Q)
        return Q

    @staticmethod
    @once_differentiable
    def backward(ctx, gQ):
        L, Q = (t.detach() for t in ctx.saved_tensors)
        gP = trsm_right_lower(L.contiguous(), gQ.detach().contiguous())
        gL = -torch.tril(gram(gP.contiguous(), Q)) if ctx.needs_input_grad[0] else None
        return gL, gP


class _PolarUnitary(torch.autograd.Function):
    """Guarded unitary polar factor with the closed-form derivative
    ``dW = W skew(W^H dO)`` (exact where ``O`` is unitary, which is where the
    implicit CTMRG adjoint differentiates it, and degeneracy-proof)."""

    @staticmethod
    def forward(ctx, O):
        W = polar_unitary_kernel(O.detach().contiguous())
        ctx.save_for_backward(W)
        return W

    @staticmethod
    @once_differentiable
    def backward(ctx, gW):
        (W,) = ctx.saved_tensors
        return polar_vjp(W.detach(), gW.detach().contiguous())


def polar_unitary(O):
    """Unitary factor of the polar decomposition ``O = W H``,
    ``W = O (O^H O)^{-1/2}`` from an eigh of ``O^H O``, guarded to identity
    on an ill-conditioned or non-finite result (counterpart of
    ``_polar_unitary_stable``: its gradient is the closed form)."""
    return _PolarUnitary.apply(O)


def procrustes_align(P, P_ref, col_mask=None):
    """Unitary Procrustes alignment of an orthonormal basis onto a reference:
    ``W`` is the unitary polar factor of ``O = P^H P_ref``.

    :param col_mask: optional 0/1 vector of the KEPT columns of ``P``; the
        alignment is then block-diagonal w.r.t. the mask, so ``P @ W`` keeps
        the exactly-zero columns of a truncated multiplet.
    :return: ``(P @ W, W)``
    """
    O = _Gram.apply(P, P_ref)
    eye = torch.eye(O.shape[0], dtype=O.dtype, device=O.device)
    if col_mask is not None:
        m = col_mask.detach().to(O.real.dtype)
        O = O * (m[:, None] * m[None, :]) + (1.0 - m)[:, None] * eye
    # ridge toward identity: completes the null space of the overlap so W
    # stays unitary when either basis has zero columns
    O = O + 1e-12 * eye
    W = polar_unitary(O)
    return P @ W, W


def cholesky_qr(P, eps: float = 0.0):
    """Orthonormalize the columns of a tall matrix via Cholesky-QR:
    ``G = P^H P (+ ridge)``, ``L = chol(G)``, ``Q = P L^{-H}``."""
    G = _GramRidge.apply(P, eps)
    L, info = torch.linalg.cholesky_ex(G)
    # a failed factorization becomes NaN, as in the JAX package, and surfaces
    # as a non-finite spectrum in the CTMRG loop; reading `info` here would
    # stall the host on every call
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    return _TrsmRightLowerH.apply(L, P)


def cholesky_qr2(P, eps: float = 1.0e-12):
    """Two-pass CholeskyQR; the ridge keeps rank-deficient blocks (cold
    starts, masked multiplets) finite."""
    return cholesky_qr(cholesky_qr(P, eps=eps), eps=eps)


def subspace_eigh(M, P0, n_power: int = 2, n_over: int = 8, keep_multiplets: bool = True,
                  eps_multiplet: float = 1.0e-12, ad_decomp_reg: float = 1.0e-12):
    """Approximate leading-|lambda| eigenpairs of a dense hermitian ``M``
    from a warm-start basis ``P0`` (n, chi): block power iteration with
    CholeskyQR2, then Rayleigh-Ritz.

    The working basis is oversampled to ``chi + n_over`` columns so the
    multiplet mask sees the spectrum beyond the cut.

    :return: ``(D, P)``: ``D`` (chi,) descending by magnitude
        (multiplet-masked), ``P`` (n, chi) orthonormal (masked columns zero).
        A non-finite decomposition degrades to ``(1, eye(n, chi))`` for one
        move, decided on the card.
    """
    n, chi = P0.shape
    # masked/zero warm-start columns would make CholeskyQR singular
    colnorm = torch.linalg.vector_norm(P0.detach(), dim=0)
    fallback = torch.eye(n, chi, dtype=P0.dtype, device=P0.device)
    P0 = torch.where(colnorm[None, :] > 1e-12, P0, fallback)
    n_over = min(n_over, n - chi)
    if n_over > 0:
        extra = torch.zeros((n, n_over), dtype=P0.dtype, device=P0.device)
        idx = torch.arange(n_over, device=P0.device)
        extra[chi + idx, idx] = 1.0
        P = torch.cat([P0, extra], dim=1)
    else:
        P = P0
    P = cholesky_qr2(P)
    for _ in range(n_power):
        P = cholesky_qr2(M @ P)
    H = P.mH @ (M @ P)
    H = 0.5 * (H + H.mH)
    D, U = eigh_desc(H, ad_decomp_reg)
    P = P @ U
    Dt, Pt = D[:chi], P[:, :chi]
    if keep_multiplets:
        mask = multiplet_mask(D, chi, eps_multiplet=eps_multiplet)
        Dt = Dt * mask
        Pt = Pt * mask[None, :].to(Pt.dtype)
    finite = lambda t: torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all()
    ok = finite(Dt) & finite(Pt)
    Dt = torch.where(ok, Dt, torch.ones_like(Dt))
    Pt = torch.where(ok, Pt, torch.eye(n, chi, dtype=Pt.dtype, device=Pt.device))
    return Dt, Pt


def cold_start_basis(n: int, chi: int, dtype=torch.float64, device="cuda"):
    """Deterministic full-rank cold-start basis (identity columns)."""
    return torch.eye(n, chi, dtype=dtype, device=device)
