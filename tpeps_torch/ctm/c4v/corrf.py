"""Correlation functions of the 1-site C4v iPEPS (counterpart of
tpeps/ctm/c4v/corrf.py).

A two-point function grows a boundary edge ``E[chi, D^2, chi]`` by
transfer-matrix columns T -- A -- T, with ``A = _aXa(a, op)`` the dense
double-layer site (JAX's contraction order).  Each of a column's three
products is one matrix product (cuBLAS on the card) after at most one
permute of an operand: at D=7, chi=147 the ``[b,q,d,r]`` intermediate holds
chi^2 D^4 entries, and one column costs 2 chi^3 D^4 + chi^2 D^8
multiply-adds.
"""

from __future__ import annotations

import torch

from ..generic.corrf import _aXa, _split_op2
from .env import EnvC4v


def get_edge(env: EnvC4v):
    """Initial boundary edge C-T-C, ``[chi, D^2, chi]``."""
    C, T = env
    E = torch.einsum("xy,xbm->ybm", C, T)
    return torch.einsum("ybm,bw->ymw", E, C)


def _column_steps(A, T):
    """One column T[q,t,u] A[u,l,d,r] T[b,w,d] as its five named steps, each
    a function of the previous step's output: three products and the two
    permutes that lay out their operands.  The first takes
    ``edge[t,l,b]``, the last returns ``[q,r,w]``."""
    chi, D2 = T.shape[0], T.shape[2]
    A = A.reshape(D2 * D2, D2 * D2)
    Tq = T.transpose(0, 1).reshape(chi, chi * D2)
    Tw = T.permute(0, 2, 1).reshape(chi * D2, chi)
    return (
        # lbqu: contract t
        ("edge T", lambda e: e.reshape(chi, D2 * chi).transpose(0, 1) @ Tq),
        ("permute 1", lambda E: E.reshape(D2, chi, chi, D2).permute(1, 2, 3, 0)
         .reshape(chi * chi, D2 * D2)),
        # bqdr: contract (u,l)
        ("product with A", lambda E: E @ A),
        ("permute 2", lambda E: E.reshape(chi, chi, D2, D2).permute(1, 3, 0, 2)
         .reshape(chi * D2, chi * D2)),
        # qrw: contract (b,d)
        ("closing T", lambda E: (E @ Tw).reshape(chi, D2, chi)),
    )


def _column(A, T, edge):
    """``edge[t,l,b]`` -> ``[q,r,w]`` through T[q,t,u] A[u,l,d,r] T[b,w,d]."""
    for _, step in _column_steps(A, T):
        edge = step(edge)
    return edge


def apply_TM_1sO(a, env: EnvC4v, edge, op=None):
    """Apply one transfer-matrix column (optional operator) to
    ``edge[chi, D^2, chi]``."""
    return _column(_aXa(a, op), env.T, edge)


def apply_edge(env: EnvC4v, vec):
    """Contract ``vec`` with the closing C-T-C edge."""
    C, T = env
    S = torch.einsum("vmw,vx->mwx", vec, C)
    S = torch.einsum("mwx,bxm->wb", S, T)
    return torch.einsum("wb,bw->", S, C)


def _normalize_pair(E0, E1):
    scale = E0.abs().max()
    return E0 / scale, E1 / scale


def corrf_1sO1sO(a, env: EnvC4v, op1, get_op2, dist: int):
    """<O1(0) O2(r)> for r in [0, dist]: ``get_op2(r)`` is the operator at
    distance r + 1."""
    A0 = _aXa(a)
    E0 = get_edge(env)
    E1 = apply_TM_1sO(a, env, E0, op=op1)
    E0 = _column(A0, env.T, E0)
    out = []
    for r in range(dist + 1):
        E12 = apply_TM_1sO(a, env, E1, op=get_op2(r))
        E0 = _column(A0, env.T, E0)
        E1 = _column(A0, env.T, E1)
        out.append(apply_edge(env, E12) / apply_edge(env, E0))
        E0, E1 = _normalize_pair(E0, E1)
    return torch.stack(out)


def apply_TM_2sO(a, env: EnvC4v, edge, op2=None):
    """Apply TWO consecutive transfer columns with an optional 2-site
    operator spanning them, split into a sum of one-site pairs."""
    if op2 is None:
        A = _aXa(a)
        return _column(A, env.T, _column(A, env.T, edge))
    o1s, o2s = _split_op2(op2, a.shape[0])
    out = None
    for k in range(o1s.shape[0]):
        E = apply_TM_1sO(a, env, edge, op=o1s[k])
        E = apply_TM_1sO(a, env, E, op=o2s[k])
        out = E if out is None else out + E
    return out


def corrf_2sOH2sOH_E1(a, env: EnvC4v, op1, get_op2, dist: int):
    """<O1(0,1) O2(r,r+1)> of horizontal 2-site operators along the
    channel, for r in [1, dist]."""
    A0 = _aXa(a)
    E0 = get_edge(env)
    E1 = apply_TM_2sO(a, env, E0, op2=op1)
    E0 = apply_TM_2sO(a, env, E0)
    out = []
    for r in range(dist):
        E12 = apply_TM_2sO(a, env, E1, op2=get_op2(r))
        E0n = apply_TM_2sO(a, env, E0)
        out.append(apply_edge(env, E12) / apply_edge(env, E0n))
        E0 = _column(A0, env.T, E0)
        E1 = _column(A0, env.T, E1)
        E0, E1 = _normalize_pair(E0, E1)
    return torch.stack(out)


def get_edge2(env: EnvC4v):
    """Width-2 boundary edge C-T-T-C, ``[chi, D^2, D^2, chi]``."""
    C, T = env
    E = torch.einsum("xy,xbm->ybm", C, T)
    E = torch.einsum("ybm,bwz->ymzw", E, T)
    return torch.einsum("ymzw,wv->ymzv", E, C)


def corrf_2sOV2sOV_E2(a, env: EnvC4v, op1, get_op2, dist: int):
    """<O1(0) O2(r)> of vertical 2-site operators through the width-2
    channel, for r in [0, dist]."""
    cap = get_edge2(env)
    E0 = cap
    E1 = apply_TM_1sO_2(a, env, E0, op2=op1)
    E0 = apply_TM_1sO_2(a, env, E0)
    out = []
    for r in range(dist + 1):
        E12 = apply_TM_1sO_2(a, env, E1, op2=get_op2(r))
        E0 = apply_TM_1sO_2(a, env, E0)
        E1 = apply_TM_1sO_2(a, env, E1)
        out.append(torch.einsum("abcd,abcd->", E12, cap) / torch.einsum("abcd,abcd->", E0, cap))
        E0, E1 = _normalize_pair(E0, E1)
    return torch.stack(out)


def apply_TM_1sO_2(a, env: EnvC4v, edge, op2=None):
    """Grow the WIDTH-2 channel by one column (T, a, a, T), with an optional
    vertical 2-site operator inside the column."""
    T = env.T
    if op2 is None:
        A = _aXa(a)
        parts = [(A, A)]
    else:
        o1, o2 = _split_op2(op2, a.shape[0])
        parts = [(_aXa(a, o1[i]), _aXa(a, o2[i])) for i in range(o1.shape[0])]
    out = None
    for A0, A1 in parts:
        E = torch.einsum("tmzb,qtu->mzbqu", edge, T)
        E = torch.einsum("mzbqu,umdr->zbqdr", E, A0)
        E = torch.einsum("zbqdr,dzev->bqrev", E, A1)
        E = torch.einsum("bqrev,bwe->qrvw", E, T)
        out = E if out is None else out + E
    return out
