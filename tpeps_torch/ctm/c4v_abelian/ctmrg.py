"""C4v-symmetric abelian CTMRG, the dynamic engine: one enlarged corner,
one truncated block-sparse eigendecomposition with a global cut across
charge sectors, one edge absorption per move (counterpart of
tpeps/ctm/c4v_abelian/ctmrg.py).

The stored T is built from B = flip_signature(A): the enlarged corner
contracts (C, T, T, A) directly, the edge absorption flips (T, A) so the
absorbed row alternates sublattices.  Every contraction runs on K8; the
cut reads every sector's spectrum to the host, and the block structure may
change from move to move (plans are cached by structure).
"""

from __future__ import annotations

import time

import numpy as np

from ...sym.tensor import eigh_blockwise
from ..generic_abelian.components import c2x2_lu
from .env import ENV_C4V_ABELIAN, flip_signature


def c2x2_sl(a, C, T):
    """Enlarged corner from the single (C, T) pair; rank-6 (rows | cols)
    with identical signatures on both triples."""
    return c2x2_lu(C, T, T.transpose((0, 3, 1, 2)), a)


def ctm_move_sl(a, env: ENV_C4V_ABELIAN, proj_kwargs):
    """One C4v move (reference ctmrg_c4v.py ctm_MOVE_sl semantics)."""
    C, T = env.C, env.T
    chi = env.chi
    M = c2x2_sl(a, C, T)
    P, W = eigh_blockwise(
        M, (0, 1, 2), (3, 4, 5), chi=chi,
        reltol=proj_kwargs.get("svd_reltol", 1e-8),
        eps_multiplet=proj_kwargs.get("eps_multiplet", 1e-8),
    )  # legs (chi, Dk, Db, new)
    # C' = P^dagger M P~ (P~: the signature flip of P)
    nC = P.conj().tensordot(M, ((0, 1, 2), (0, 1, 2)))
    nC = nC.tensordot(flip_signature(P), ((1, 2, 3), (0, 1, 2)))
    # T' = P (T_B  B  B*) P, the absorbed row on the other sublattice
    Tf = flip_signature(T)
    af = flip_signature(a)
    z = P.tensordot(Tf, ((0,), (0,)))            # (Pk,Pb,n1, tk,tb,cr)
    z = z.tensordot(af, ((0, 3), (1, 2)))        # (Pb,n1,tb,cr, s,d,r)
    z = z.tensordot(af.conj(), ((0, 2, 4), (1, 2, 0)))  # (n1,cr,d,r, d',r')
    nT = z.tensordot(P, ((1, 2, 4), (0, 1, 2)))  # (n1, rk, rb, n2)
    # symmetrize + normalize (reference ctmrg_c4v.py:131-136)
    nC = 0.5 * (nC + nC.transpose((1, 0)).conj_blocks())
    nT = 0.5 * (nT + nT.transpose((3, 1, 2, 0)).conj_blocks())
    smax = max(float(w.abs().max()) for w in W.values())
    nC = nC * (1.0 / smax)
    nT = nT * (1.0 / float(nT.max_abs()))
    return ENV_C4V_ABELIAN(chi, nC, nT)


def run(state, env: ENV_C4V_ABELIAN, ctm_cfg, conv_check=None, stats=None):
    """CTMRG to convergence (host loop; default convergence: the l2
    distance of successive normalized corner spectra).

    :param stats: optional list; gets one dict per move: the chi profile
        (``{charge: dim}`` of the corner's first leg) and the move's host wall
        seconds up to its convergence test (which reads the spectrum)
    :return: ``(env, history)``
    """
    a = state.site((0, 0))
    proj_kwargs = dict(svd_reltol=ctm_cfg.projector_svd_reltol,
                       eps_multiplet=ctm_cfg.projector_eps_multiplet)
    spec_prev = None
    history = {"conv_crit": []}
    for _ in range(ctm_cfg.ctm_max_iter):
        t0 = time.perf_counter()
        env = ctm_move_sl(a, env, proj_kwargs)
        converged = False
        if conv_check is not None:
            converged, history = conv_check(state, env, history)
        else:
            s = env.get_spectrum()
            spec = np.zeros(env.chi)
            spec[:min(env.chi, s.size)] = s[:env.chi]
            if spec[0] > 0:
                spec /= spec[0]
            if spec_prev is not None:
                dist = float(np.linalg.norm(spec - spec_prev))
                history["conv_crit"].append(dist)
                converged = dist < ctm_cfg.ctm_conv_tol
            spec_prev = spec
        if stats is not None:
            stats.append({"profile": dict(env.C.legs[0].charges),
                          "seconds": time.perf_counter() - t0})
        if converged:
            break
    return env, history
