"""Block-sparse CTM projectors (counterpart of
tpeps/ctm/generic_abelian/projectors.py): ``M = R^T Rt = U S V^H`` truncated
to chi with a global cross-sector cut (:func:`svd_blockwise`),
``P = R U* S^{-1/2}``, ``Pt = Rt V S^{-1/2}``; P and Pt are rank 4:
(chi, Dket, Dbra, chi_new).
"""

from __future__ import annotations

import numpy as np
import torch

from ...sym.tensor import PLANS, AbelianTensor, svd_blockwise
from .components import HALVES


def _scale_new_leg(t, vecs):
    """Multiply ``t``'s blocks along the last (SVD) leg by per-sector vectors
    ``vecs[q]`` (one gather of the concatenated vectors, cached per
    structure; differentiable in the vectors).  A meta tensor (a
    structure-only run) comes back as it is."""
    if t.data.is_meta:
        return t
    qs = sorted(vecs)
    lens = tuple(int(vecs[q].shape[0]) for q in qs)

    def build():
        base = dict(zip(qs, np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)))
        parts = [np.tile(base[k[-1]] + np.arange(sh[-1], dtype=np.int64), int(np.prod(sh[:-1])))
                 for k, sh in zip(t.struct.keys, t.struct.shapes)]
        idx = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
        return torch.from_numpy(idx).to(t.device)

    idx = PLANS.get_or(("scale_new_leg", t.struct, tuple(qs), lens, str(t.device)), build)
    v = torch.cat([vecs[q] for q in qs]).to(t.data.dtype)
    return AbelianTensor._flat(t, t.struct, t.data * v[idx])


def _rsqrt(S):
    return {q: 1.0 / torch.sqrt(s) for q, s in S.items()}


def projectors_from_halves(R, Rt, chi: int, svd_reltol: float = 1.0e-8,
                           eps_multiplet: float = 1.0e-8, **_unused):
    """(P, Pt) from the two rank-6 half-system tensors joined through their
    row triples."""
    M = R.tensordot(Rt, ((0, 1, 2), (0, 1, 2)))  # (R-cols, Rt-cols)
    U, S, V = svd_blockwise(M, (0, 1, 2), (3, 4, 5), chi=chi, reltol=svd_reltol,
                            eps_multiplet=eps_multiplet)
    return projectors_from_svd(R, Rt, U, S, V)


def projectors_from_svd(R, Rt, U, S, V):
    """``P = R U* S^{-1/2}``, ``Pt = Rt V S^{-1/2}`` (shared by the dynamic and
    the frozen projectors)."""
    isq = {} if R.data.is_meta else _rsqrt(S)
    P = _scale_new_leg(R.tensordot(U.conj(), ((3, 4, 5), (0, 1, 2))), isq)
    Vd = V.conj().transpose((1, 2, 3, 0))
    Pt = _scale_new_leg(Rt.tensordot(Vd, ((3, 4, 5), (0, 1, 2))), isq)
    return P, Pt


def ctm_get_projectors(direction, coord, state, env, chi: int, **kwargs):
    """4x4 projectors for a directional move at ``coord``."""
    R, Rt = HALVES[direction](coord, state, env)
    return projectors_from_halves(R, Rt, chi, **kwargs)
