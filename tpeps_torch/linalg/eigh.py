"""Hermitian eigendecomposition helpers with an AD-stable gradient
(counterpart of tpeps/linalg/eigh.py).

The eigh itself is ``torch.linalg.eigh`` (cuSOLVER on the card).  Its
gradient is the Lorentzian-broadened one of arXiv:1903.09650, as an
``autograd.Function``: torch's own eigh backward divides by eigenvalue gaps
and breaks on the exact multiplets that iPEPS environments carry.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def safe_inverse(x, epsilon):
    """Lorentzian-regularized reciprocal ``x / (x^2 + eps)``."""
    return x / (x * x + epsilon)


class _EighDesc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, ad_decomp_reg):
        D, U = torch.linalg.eigh(A.detach())
        order = torch.argsort(-D.abs(), stable=True)
        D, U = D[order], U[:, order]
        ctx.save_for_backward(D, U)
        ctx.reg = ad_decomp_reg
        return D, U

    @staticmethod
    @once_differentiable
    def backward(ctx, gD, gU):
        # dA = U (diag(dD) + F o (U^H dU)) U^H, F_ij = safe_inverse(D_j - D_i)
        D, U = ctx.saved_tensors
        Uh = U.mH
        inner = torch.zeros_like(U) if gD is None else torch.diag(gD.to(U.dtype))
        if gU is not None:
            F = safe_inverse(D[None, :] - D[:, None], ctx.reg)
            F.fill_diagonal_(0.0)
            inner = inner + F.to(U.dtype) * (Uh @ gU)
        return U @ inner @ Uh, None


def eigh_desc(A, ad_decomp_reg: float = 1.0e-12):
    """Hermitian eigendecomposition ordered by descending ``|eigenvalue|``.

    :param ad_decomp_reg: regularization of the gap inverse in the gradient
    :return: ``(D, U)`` with ``A = U diag(D) U^H``, ``D`` real.  The sort is
        stable, as JAX's argsort is, so ties keep ascending order.
    """
    return _EighDesc.apply(A, ad_decomp_reg)


def multiplet_mask(D, chi: int, eps_multiplet: float = 1.0e-8, abs_tol: float = 1.0e-14):
    """Mask over the leading ``chi`` values that never splits a
    near-degenerate multiplet: if the cut at ``chi`` falls inside one, the
    cut is pulled back to the last clean gap.

    :param D: spectral values sorted by descending magnitude, ``len >= chi+1``
    :return: mask of shape ``(chi,)`` (1 keep / 0 drop) in ``D``'s real
        dtype; a default-dtype constant here would silently promote a
        float32 move to float64.
    """
    absD = D[: chi + 1].detach().abs()
    absD = torch.where(absD < abs_tol, torch.zeros_like(absD), absD)
    gaps = (absD[:chi] - D[1 : chi + 1].detach().abs()) / (absD[:chi] + 1.0e-16)
    gaps = torch.where(gaps > 1.0, torch.zeros_like(gaps), gaps)
    idx = torch.arange(chi, device=D.device)
    is_gap = gaps > eps_multiplet
    last_gap = torch.where(is_gap, idx, torch.full_like(idx, -1)).max()
    chi_new = torch.where(last_gap >= 0, last_gap, torch.full_like(last_gap, chi))
    cut = torch.where(is_gap[chi - 1], torch.full_like(chi_new, chi), chi_new)
    return (idx <= cut).to(absD.dtype)


def truncated_eigh_sym(
    M,
    chi: int,
    keep_multiplets: bool = True,
    ad_decomp_reg: float = 1.0e-12,
    eps_multiplet: float = 1.0e-12,
    abs_tol: float = 1.0e-14,
):
    """Leading-``chi`` eigenpairs of a hermitian matrix, multiplet-safe,
    zero-padded to ``chi`` columns."""
    N = M.shape[0]
    D, U = eigh_desc(M, ad_decomp_reg)
    chi_eff = min(chi, N)
    Dt = D[:chi_eff]
    Ut = U[:, :chi_eff]
    if keep_multiplets and chi < N:
        mask = multiplet_mask(D, chi_eff, eps_multiplet=eps_multiplet, abs_tol=abs_tol)
        Dt = Dt * mask
        Ut = Ut * mask[None, :]
    if chi_eff < chi:
        Dt = torch.nn.functional.pad(Dt, (0, chi - chi_eff))
        Ut = torch.nn.functional.pad(Ut, (0, chi - chi_eff))
    return Dt, Ut


def fix_eigvec_phase(U):
    """Gauge-fix eigenvector columns: the largest-|entry| element of each
    column made real positive (sign for a real ``U``)."""
    idx = torch.argmax(U.detach().abs(), dim=0)
    pivots = U[idx, torch.arange(U.shape[1], device=U.device)]
    if U.is_complex():
        phase = pivots / torch.clamp(pivots.abs(), min=1e-300)
    else:
        phase = torch.sign(pivots) + (pivots == 0).to(U.dtype)
    return U * phase.conj()[None, :]
