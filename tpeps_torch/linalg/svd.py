"""Reduced SVD with a gap-regularized derivative, and its gauge fixing
(counterpart of ``svd_reg`` and ``fix_svd_signs`` in tpeps/linalg/svd.py).

The derivative is the transpose of the JAX package's JVP (JAX's own SVD JVP
rule with two regularized inverses: the gap inverse ``1/(s_j^2 - s_i^2)``
as a Lorentzian of width ``eps * S[0]^2``, and ``1/s`` set to zero below
``eps * S[0]``), with the complex phase term and the complement terms of a
tall or wide matrix, as an ``autograd.Function``; torch's own SVD backward
divides by the raw gaps.

On the card ``torch.linalg.svd`` runs cuSOLVER with the driver
``SVD_DRIVER``; on the CPU, LAPACK.  ``gesvd`` (QR bidiagonalization, the
algorithm of LAPACK's full SVD) was chosen with numbers (PERF.md, NVIDIA
H100 80GB HBM3 at 700 W): on the 1586-wide +-1 sector of the D=8 chi=160
abelian corner the two full drivers measured within their run-to-run spread
(``gesvd`` 230-309 ms, ``gesvdj`` 260-264).  ``gesvda`` (21 ms) is not used:
it approximates the SVD of a tall matrix and agreed with ``gesvd`` only to
~1e-12 of the largest singular value, the size of the cut's ``svd_reltol``.
A wide matrix is decomposed through its transpose.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

SVD_DRIVER = "gesvd"
PIVOT_TIE_REL = 1.0e-10  # fix_svd_signs: magnitudes this close to a column's largest tie


def _svd(A):
    if not A.is_cuda:
        return torch.linalg.svd(A, full_matrices=False)
    if A.shape[-2] < A.shape[-1]:
        U, S, Vh = torch.linalg.svd(A.mH, full_matrices=False, driver=SVD_DRIVER)
        return Vh.mH, S, U.mH
    return torch.linalg.svd(A, full_matrices=False, driver=SVD_DRIVER)


def svd_reg_vjp(U, S, Vh, gU, gS, gVh, eps: float):
    """Cotangent of ``A`` for the cotangents ``(gU, gS, gVh)`` of ``svd_reg``'s
    outputs (each may be None): the transpose, under ``Re tr(X^H Y)``, of the
    JAX package's regularized JVP.  With ``F_ij`` the Lorentzian
    ``1/(s_j^2 - s_i^2)`` and ``J_u = U^H gU``, ``J_v = V^H gV``::

        Gamma = (F o J_u + (F o J_u)^H) S + S (F o J_v + (F o J_v)^H)
                + diag(gS) + i diag(Im diag(J_u) / s)
        gA = U Gamma V^H + (1 - U U^H) gU S^-1 V^H       (tall)
                         + U S^-1 gVh (1 - V V^H)        (wide)
    """
    m, n, k = U.shape[0], Vh.shape[1], S.shape[0]
    dt = U.dtype
    V = Vh.mH
    s0 = S[0]
    sd = S[None, :] ** 2 - S[:, None] ** 2
    w = (eps * s0) ** 2
    F = sd / (sd * sd + w * w)
    F.fill_diagonal_(0.0)
    small = S.abs() < eps * s0
    s_inv = torch.where(small, torch.zeros_like(S), 1.0 / torch.where(small, torch.ones_like(S), S))
    F, Sd, Sid = F.to(dt), S.to(dt), s_inv.to(dt)
    gam = torch.zeros(k, k, dtype=dt, device=U.device)
    if gU is not None:
        Ju = U.mH @ gU
        X = F * Ju
        gam = gam + (X + X.mH) * Sd[None, :]
        if U.is_complex():
            gam = gam + torch.diag(1j * Ju.diagonal().imag * s_inv)
    if gVh is not None:
        Jv = V.mH @ gVh.mH
        X = F * Jv
        gam = gam + Sd[:, None] * (X + X.mH)
    if gS is not None:
        gam = gam + torch.diag(gS.to(dt))
    gA = U @ gam @ Vh
    if m > n and gU is not None:
        gA = gA + ((gU - U @ (U.mH @ gU)) * Sid[None, :]) @ Vh
    if n > m and gVh is not None:
        gA = gA + (U * Sid[None, :]) @ (gVh - (gVh @ V) @ Vh)
    return gA


class _SvdReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, eps):
        U, S, Vh = _svd(A.detach())
        ctx.save_for_backward(U, S, Vh)
        ctx.eps = eps
        return U, S, Vh

    @staticmethod
    @once_differentiable
    def backward(ctx, gU, gS, gVh):
        U, S, Vh = ctx.saved_tensors
        return svd_reg_vjp(U, S, Vh, gU, gS, gVh, ctx.eps), None


def svd_reg(A, eps: float = 1.0e-12):
    """Reduced SVD ``A = U diag(S) V^H``, ``S`` descending, with the
    gap-regularized derivative (:func:`svd_reg_vjp`).

    :param eps: the derivative's relative regularization (the forward value
        does not depend on it)
    :return: ``(U, S, Vh)`` of shapes ``(m, k), (k,), (k, n)``, ``k = min(m, n)``
    """
    return _SvdReg.apply(A, eps)


def fix_svd_signs(U, Vh):
    """Gauge-fix SVD factor pairs: the largest-|entry| element of each ``U``
    column made real positive; the compensating phase goes into ``Vh`` so
    ``U S Vh`` is unchanged.  Entries within ``PIVOT_TIE_REL`` of a column's largest
    magnitude count as tied and the first of them is the pivot (the JAX
    package's ``argmax`` picks the first of exact ties): the ket/bra symmetry
    of a double layer ties entries exactly, and rounding must not pick the
    pivot, or the sign can change from one CTMRG move to the next and from
    one device to another."""
    Ua = U.detach().abs()
    tied = Ua >= Ua.amax(dim=0, keepdim=True) * (1.0 - PIVOT_TIE_REL)
    first = torch.arange(U.shape[0], 0, -1, device=U.device)[:, None]  # unique maximum: the first
    idx = torch.argmax(tied.to(first.dtype) * first, dim=0)
    pivots = U[idx, torch.arange(U.shape[1], device=U.device)]
    if U.is_complex():
        phase = pivots / torch.clamp(pivots.abs(), min=1e-300)
    else:
        phase = torch.sign(pivots) + (pivots == 0).to(U.dtype)
    return U * phase.conj()[None, :], Vh * phase[:, None]
