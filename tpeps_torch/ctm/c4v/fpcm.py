"""Fixed-Point Corner Method for the 1-site C4v CTMRG (counterpart of
tpeps/ctm/c4v/fpcm.py).  Instead of iterating absorption moves, the
environment solves fixed-point equations:

1. ``isogauge_mps``: the pulling-through condition ``C T = U C`` for the
   gauge ``C`` and the isometry ``U`` (the dominant eigenvector of the
   T-transfer map, then iterated left polar decompositions);
2. ``fp_T``: the edge tensor is the dominant eigenvector of the channel
   map ``B -> U^H (B a a*) U`` (one absorption with the fixed isometry);
3. 1-2 until T stops changing, then ``fp_C``: the corner is the dominant
   eigenvector of ``B -> U^T c2x2(a, B, T) U``.

Dominant eigenvectors come from :func:`tpeps_torch.linalg.arnoldi.arnoldi_eigs_vecs`
on the environment's device.  No backward: FPCM accelerates convergence,
gradients take the standard moves.  As in the JAX package, the CTMRG loop
never calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...linalg.arnoldi import arnoldi_eigs_vecs, seeded_start
from .ctmrg import _absorb_T, c2x2_sl
from .env import EnvC4v


def polar_decomp_left(M, normalize: bool = False):
    """``M = U' P`` with ``U'`` an isometry and ``P`` hermitian PSD;
    returns ``(P, U')``."""
    U, S, Vh = torch.linalg.svd(M, full_matrices=False)
    if normalize:
        S = S / S[0]
    P = (Vh.mH * S[None, :].to(Vh.dtype)) @ Vh
    return P, U @ Vh


def pull_through(C, T):
    """Solve ``C T ~ U C`` by one left polar decomposition; ``T`` is
    (chi, chi, D^2) and ``U`` comes back in the same layout."""
    chi, D2 = T.shape[1], T.shape[2]
    CT = torch.tensordot(C, T, ([1], [0]))  # (c0, t1, D2)
    CT = CT.permute(0, 2, 1).reshape(C.shape[0] * D2, chi)
    P, U = polar_decomp_left(CT, normalize=True)
    return P, U.reshape(C.shape[0], D2, chi).permute(0, 2, 1)


def _dominant_vec(matvec, v0, m=30):
    w, X = arnoldi_eigs_vecs(matvec, v0, 1, m=m)
    x = X[:, 0]
    # rotate the eigenvector (defined up to a phase) to the real axis
    i = np.argmax(np.abs(x))
    x = x * (np.conj(x[i]) / abs(x[i]))
    if abs(x.imag).max() >= 1e-10 * max(1.0, abs(x.real).max()):
        raise RuntimeError("dominant eigenvector is not real after phase rotation")
    return torch.as_tensor(np.ascontiguousarray(x.real), device=v0.device), w[0]


def fp_TT(T, U=None, C2_0=None):
    """Dominant eigenvector of the (mixed) MPS transfer map
    ``B -> U^T_{0,2} (B T)``."""
    U = T if U is None else U
    chi = T.shape[0]

    def mv(v):
        B = torch.tensordot(v.reshape(chi, chi), T, ([1], [0]))  # (b0, t1, D2)
        return torch.tensordot(U, B, ([0, 2], [0, 2])).reshape(-1)  # (u1, t1)

    v0 = C2_0.reshape(-1) if C2_0 is not None else seeded_start(chi * chi, T, 7)
    x, _ = _dominant_vec(mv, v0)
    return x.reshape(chi, chi)


def isogauge_mps(T, C0=None, isogauge_tol=1e-8, max_iter=50):
    """Iso-gauge the edge MPS: ``(C, U)`` satisfying the pulling-through
    equation."""
    nC2 = fp_TT(T, C2_0=(C0 @ C0 if C0 is not None else None))
    nC2 = 0.5 * (nC2 + nC2.T)
    D, Uc = torch.linalg.eigh(nC2)
    order = torch.argsort(-D.abs())
    D, Uc = D[order], Uc[:, order]
    if float(D[0]) < 0:
        D = -D
    if float(D.min() / D[0]) <= -1e-12:
        raise RuntimeError("transfer fixed point not positive")
    D = D.clamp(min=0.0)
    nC = (Uc * torch.sqrt(D / D[0])[None, :]) @ Uc.T

    P, U = pull_through(nC, T)
    e0 = float(torch.linalg.norm(nC - P)) / max(nC.shape)
    it = 0
    while e0 > isogauge_tol and it < max_iter:
        nC = fp_TT(T, U=U, C2_0=nC)
        nC, _ = polar_decomp_left(nC, normalize=True)
        P, U = pull_through(nC, T)
        e0 = float(torch.linalg.norm(nC - P))
        it += 1
    return nC, U


def fp_T(a, U, T0=None):
    """Dominant eigenvector of the channel map ``B -> U^H (B a a*) U``: one
    edge absorption with a fixed isometry, through :func:`_absorb_T`."""
    chi = U.shape[0]
    D = a.shape[1]
    U4 = U.permute(0, 2, 1).reshape(chi, D, D, chi)

    def mv(v):
        return _absorb_T(a, v.reshape(chi, chi, D * D), U4).reshape(-1)

    v0 = T0.reshape(-1) if T0 is not None else seeded_start(chi * chi * D * D, a, 11)
    x, _ = _dominant_vec(mv, v0)
    return x.reshape(chi, chi, D * D)


def fp_C(a, T, U, C0=None):
    """Dominant eigenvector of ``B -> U^T c2x2(a, B, T) U``."""
    chi = U.shape[0]
    D2 = U.shape[2]
    P_loc = U.permute(0, 2, 1).reshape(chi * D2, chi)

    def mv(v):
        M = c2x2_sl(a, v.reshape(chi, chi), T)
        return (P_loc.mH @ (M @ P_loc)).reshape(-1)

    v0 = C0.reshape(-1) if C0 is not None else seeded_start(chi * chi, a, 13)
    x, _ = _dominant_vec(mv, v0)
    return x.reshape(chi, chi)


@torch.no_grad()
def fpcm_move_sl(a, env: EnvC4v, fpcm_tol=1e-8, isogauge_tol=1e-8, max_outer=50):
    """One FPCM update: alternate iso-gauging and the T fixed point until T
    stops changing, then solve the corner fixed point; a new :class:`EnvC4v`."""
    e0 = np.inf
    Tp, Cp, U = env.T, env.C, None
    it = 0
    while e0 > fpcm_tol and it < max_outer:
        Cp, U = isogauge_mps(Tp, C0=Cp, isogauge_tol=isogauge_tol)
        Tn = fp_T(a, U, T0=Tp)
        Tn = 0.5 * (Tn + Tn.permute(1, 0, 2))
        e0 = float(torch.linalg.norm(Tn - Tp)) / max(Tn.shape)
        Tp = Tn
        it += 1
    nC = fp_C(a, Tp, U, C0=Cp)
    nC = 0.5 * (nC + nC.T)
    return EnvC4v(nC / nC.abs().max(), Tp / Tp.abs().max())
