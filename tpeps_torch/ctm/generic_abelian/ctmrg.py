"""Directional CTMRG over abelian block-sparse tensors for generic unit cells
(counterpart of tpeps/ctm/generic_abelian/ctmrg.py).

A directional move first builds every site's projectors from the input
environment, then absorbs each site into a clone; its outputs are normalized
by their max.  A sweep is each direction of ``ctm_move_sequence``, repeated
``lX`` times (left, right) or ``lY`` times (up, down).  The block structure
changes while the chi sectors grow to the truncation target, so the loop
stays on the host; every contraction runs on K8 with plans cached per
structure, and every sector's spectrum is read for the global cut.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...sym.frozen import reindex_like
from .env import ENV_ABELIAN
from .projectors import ctm_get_projectors

_REL_VECS = {
    (0, -1): {"nC1": (1, -1), "nC2": (-1, -1), "nT": (0, -1)},
    (-1, 0): {"nC1": (-1, -1), "nC2": (-1, 1), "nT": (-1, 0)},
    (0, 1): {"nC1": (-1, 1), "nC2": (1, 1), "nT": (0, 1)},
    (1, 0): {"nC1": (1, 1), "nC2": (1, -1), "nT": (1, 0)},
}


def _like(like, name):
    return None if like is None else like[name]


def _absorb_up(c, state, env, P, Pt, like=None):
    a = state.sites[c]
    cr = state.vertexToSite((c[0] + 1, c[1]))
    C, T = env.C, env.T
    t = C[(c, (1, -1))].tensordot(T[(c, (1, 0))], ((1,), (0,)))     # (x,wk,wb,b)
    nC1 = Pt[cr].tensordot(t, ((0, 1, 2), (0, 1, 2)), out_like=_like(like, "nC1"))  # (q,b)
    t = C[(c, (-1, -1))].tensordot(T[(c, (-1, 0))], ((0,), (0,)))   # (y,d,nk,nb)
    nC2 = t.tensordot(P[c], ((0, 2, 3), (0, 1, 2)), out_like=_like(like, "nC2"))    # (d,q)
    z = T[(c, (0, -1))].tensordot(Pt[c], ((0,), (0,)))              # (u,v,r,l,m,q)
    z = z.tensordot(a, ((0, 3), (1, 2)))                            # (v,r,m,q,s,e,f)
    z = z.tensordot(a.conj(), ((4, 0, 2), (0, 1, 2)))               # (r,q,e,f,g,w)
    nT = z.tensordot(P[cr], ((0, 3, 5), (0, 1, 2)), out_like=_like(like, "nT"))     # (q,e,g,p)
    return nC1, nC2, nT


def _absorb_left(c, state, env, P, Pt, like=None):
    a = state.sites[c]
    cu = state.vertexToSite((c[0], c[1] - 1))
    C, T = env.C, env.T
    t = C[(c, (-1, -1))].tensordot(T[(c, (0, -1))], ((1,), (0,)))   # (x,mk,mb,r)
    nC1 = Pt[cu].tensordot(t, ((0, 1, 2), (0, 1, 2)), out_like=_like(like, "nC1"))  # (q,r)
    t = C[(c, (-1, 1))].tensordot(T[(c, (0, 1))], ((1,), (2,)))     # (x,mk,mb,r)
    nC2 = P[c].tensordot(t, ((0, 1, 2), (0, 1, 2)), out_like=_like(like, "nC2"))    # (q,r)
    z = T[(c, (-1, 0))].tensordot(P[cu], ((0,), (0,)))              # (b,w,v,u,c,q)
    z = z.tensordot(a, ((3, 1), (1, 2)))                            # (b,v,c,q,s,e,f)
    z = z.tensordot(a.conj(), ((4, 2, 1), (0, 1, 2)))               # (b,q,e,f,g,h)
    nT = z.tensordot(Pt[c], ((0, 2, 4), (0, 1, 2)))                 # (q,f,h,p)
    nT = nT.transpose((0, 3, 1, 2))                                 # (q,p,fk,hb)
    return nC1, nC2, nT if like is None else reindex_like(nT, like["nT"])


def _absorb_down(c, state, env, P, Pt, like=None):
    a = state.sites[c]
    cl = state.vertexToSite((c[0] - 1, c[1]))
    C, T = env.C, env.T
    t = C[(c, (-1, 1))].tensordot(T[(c, (-1, 0))], ((0,), (1,)))    # (y,t,nk,nb)
    nC1 = t.tensordot(Pt[cl], ((0, 2, 3), (0, 1, 2)), out_like=_like(like, "nC1"))  # (t,q)
    t = C[(c, (1, 1))].tensordot(T[(c, (1, 0))], ((0,), (3,)))      # (y,t,wk,wb)
    nC2 = t.tensordot(P[c], ((0, 2, 3), (0, 1, 2)), out_like=_like(like, "nC2"))    # (t,q)
    z = T[(c, (0, 1))].tensordot(P[cl], ((2,), (0,)))               # (u,v,r,w,c,q)
    z = z.tensordot(a, ((3, 0), (2, 3)))                            # (v,r,c,q,s,e,f)
    z = z.tensordot(a.conj(), ((4, 2, 0), (0, 2, 3)))               # (r,q,e,f,g,h)
    nT = z.tensordot(Pt[c], ((0, 3, 5), (0, 1, 2)))                 # (q,e,g,p)
    nT = nT.transpose((1, 2, 0, 3))                                 # (ek,gb,q,p)
    return nC1, nC2, nT if like is None else reindex_like(nT, like["nT"])


def _absorb_right(c, state, env, P, Pt, like=None):
    a = state.sites[c]
    cd = state.vertexToSite((c[0], c[1] + 1))
    C, T = env.C, env.T
    t = C[(c, (1, 1))].tensordot(T[(c, (0, 1))], ((1,), (3,)))      # (x,mk,mb,l)
    nC1 = Pt[cd].tensordot(t, ((0, 1, 2), (0, 1, 2)), out_like=_like(like, "nC1"))  # (q,l)
    t = C[(c, (1, -1))].tensordot(T[(c, (0, -1))], ((0,), (3,)))    # (y,l,mk,mb)
    nC2 = t.tensordot(P[c], ((0, 2, 3), (0, 1, 2)), out_like=_like(like, "nC2"))    # (l,q)
    z = T[(c, (1, 0))].tensordot(Pt[c], ((0,), (0,)))               # (w,v,b,u,c,q)
    z = z.tensordot(a, ((3, 0), (1, 4)))                            # (v,b,c,q,s,e,f)
    z = z.tensordot(a.conj(), ((4, 2, 0), (0, 1, 4)))               # (b,q,e,f,g,h)
    nT = z.tensordot(P[cd], ((0, 3, 5), (0, 1, 2)), out_like=_like(like, "nT"))     # (q,e,g,p)
    return nC1, nC2, nT


_ABSORB = {
    (0, -1): _absorb_up,
    (-1, 0): _absorb_left,
    (0, 1): _absorb_down,
    (1, 0): _absorb_right,
}


def _normalized(t):
    return t * (1.0 / t.max_abs())


def target_slots(direction, state):
    """Per site ``c``, the env keys its move writes: ``(C key of nC1, C key of
    nC2, T key of nT)`` at ``c - direction``."""
    rel = _REL_VECS[direction]
    out = []
    for c in state.sites:
        nc = state.vertexToSite((c[0] - direction[0], c[1] - direction[1]))
        out.append((c, (nc, rel["nC1"]), (nc, rel["nC2"]), (nc, rel["nT"])))
    return out


def ctm_move(direction, state, env: ENV_ABELIAN, chi: int, proj_kwargs):
    """One directional move for every site: all projectors from the input
    environment first, then each site absorbed into a clone."""
    P, Pt = {}, {}
    for c in state.sites:
        P[c], Pt[c] = ctm_get_projectors(direction, c, state, env, chi, **proj_kwargs)
    absorb = _ABSORB[direction]
    out = env.clone()
    for c, k1, k2, kt in target_slots(direction, state):
        nC1, nC2, nT = absorb(c, state, env, P, Pt)
        out.C[k1] = _normalized(nC1)
        out.C[k2] = _normalized(nC2)
        out.T[kt] = _normalized(nT)
    return out


def sweep_directions(state, move_seq):
    """The directional moves of one sweep: each direction of ``move_seq``,
    ``lX`` times (left, right) or ``lY`` times (up, down)."""
    return [tuple(d) for d in move_seq
            for _ in range(state.lX if tuple(d) in ((-1, 0), (1, 0)) else state.lY)]


def _corner_spectra(env: ENV_ABELIAN, chi: int):
    """Stacked normalized corner spectra padded to chi (host numpy)."""
    specs = []
    for k in sorted(env.C.keys()):
        s = np.sort(torch.linalg.svdvals(env.C[k].to_dense()).cpu().numpy())[::-1]
        p = np.zeros(chi)
        p[: min(chi, s.size)] = s[:chi]
        if p[0] > 0:
            p /= p[0]
        specs.append(p)
    return np.stack(specs)


def run(state, env: ENV_ABELIAN, ctm_cfg, conv_check=None, stats=None):
    """CTMRG to convergence: sweeps on the host, by default until the l2
    distance of successive normalized corner spectra is below
    ``ctm_conv_tol`` (``ctm_max_iter`` counts sweeps).

    :param stats: optional list; gets one dict per sweep: its host wall
        seconds up to the convergence test and the chi profile of every
        corner's first leg (``{key: {charge: dim}}``)
    :return: ``(env, history)``
    """
    proj_kwargs = dict(svd_reltol=ctm_cfg.projector_svd_reltol,
                       eps_multiplet=ctm_cfg.projector_eps_multiplet)
    dirs = sweep_directions(state, ctm_cfg.ctm_move_sequence)
    chi = env.chi
    spec_prev = None
    history = {"conv_crit": []}
    for _ in range(ctm_cfg.ctm_max_iter):
        t0 = time.perf_counter()
        for direction in dirs:
            env = ctm_move(direction, state, env, chi, proj_kwargs)
        converged = False
        if conv_check is not None:
            converged, history = conv_check(state, env, history)
        else:
            spec = _corner_spectra(env, chi)
            if spec_prev is not None:
                dist = float(np.linalg.norm(spec - spec_prev))
                history["conv_crit"].append(dist)
                converged = dist < ctm_cfg.ctm_conv_tol
            spec_prev = spec
        if stats is not None:
            stats.append({"seconds": time.perf_counter() - t0,
                          "profiles": {k: dict(c.legs[0].charges) for k, c in env.C.items()}})
        if converged:
            break
    return env, history
