"""Reduced SVD and its gauge fixing (counterpart of ``svd_reg`` and
``fix_svd_signs`` in tpeps/linalg/svd.py, forward only: the regularized
derivative comes with the abelian training path).

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

SVD_DRIVER = "gesvd"


def svd_reg(A, eps: float = 1.0e-12):
    """Reduced SVD ``A = U diag(S) V^H``, ``S`` descending.

    :param eps: the derivative's relative regularization (kept for the
        JAX signature; the forward value does not depend on it)
    :return: ``(U, S, Vh)`` of shapes ``(m, k), (k,), (k, n)``, ``k = min(m, n)``
    """
    if A.requires_grad:
        raise RuntimeError("svd_reg is forward-only in tpeps_torch: its regularized "
                           "derivative comes with the abelian training path")
    if not A.is_cuda:
        return torch.linalg.svd(A, full_matrices=False)
    if A.shape[-2] < A.shape[-1]:
        U, S, Vh = torch.linalg.svd(A.mH, full_matrices=False, driver=SVD_DRIVER)
        return Vh.mH, S, U.mH
    return torch.linalg.svd(A, full_matrices=False, driver=SVD_DRIVER)


def fix_svd_signs(U, Vh):
    """Gauge-fix SVD factor pairs: the largest-|entry| element of each ``U``
    column made real positive; the compensating phase goes into ``Vh`` so
    ``U S Vh`` is unchanged."""
    idx = torch.argmax(U.detach().abs(), dim=0)
    pivots = U[idx, torch.arange(U.shape[1], device=U.device)]
    if U.is_complex():
        phase = pivots / torch.clamp(pivots.abs(), min=1e-300)
    else:
        phase = torch.sign(pivots) + (pivots == 0).to(U.dtype)
    return U * phase.conj()[None, :], Vh * phase[:, None]
