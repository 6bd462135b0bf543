"""Correlation functions along rows/columns of a generic unit cell
(counterpart of tpeps/ctm/generic/corrf.py).

The two-point function <O1(0) O2(r)> grows a boundary edge with column/row
transfer matrices.  Growth goes right (1,0) or down (0,1); up and left are
the same networks read from the other end.  The environment comes as the
generic dictionaries ``C[(site, corner)]``, ``T[(site, direction)]`` of
any cell, e.g. :func:`tpeps_torch.ctm.c4v.env.env_c4v_to_generic`.
"""

from __future__ import annotations

import numpy as np
import torch


def _shift(c, d):
    return (c[0] + d[0], c[1] + d[1])


def _aXa(a, op=None):
    """Double-layer site ``A[u^2, l^2, d^2, r^2]`` (ket-major pairs) with an
    optional one-site operator on the ket layer."""
    d = a.shape
    a_op = a if op is None else torch.einsum("mefgh,mn->nefgh", a, op)
    A = torch.einsum("nefgh,nabcd->eafbgchd", a_op, a.conj())
    return A.reshape(d[1] ** 2, d[2] ** 2, d[3] ** 2, d[4] ** 2)


def get_edge(coord, direction, sites, site_of, C, T):
    """Boundary edge C-T-C of site ``coord`` facing ``direction``, index
    order left-to-right / up-to-down: ``[chi, D^2, chi]``."""
    c = site_of(coord)
    if direction == (0, -1):  # up
        E = torch.einsum("lmx,xy->lmy", T[(c, (0, -1))], C[(c, (1, -1))])
        E = torch.einsum("xl,lmy->xmy", C[(c, (-1, -1))], E)
    elif direction == (-1, 0):  # left
        E = torch.einsum("xy,xbm->ybm", C[(c, (-1, -1))], T[(c, (-1, 0))])
        E = torch.einsum("ybm,bw->ymw", E, C[(c, (-1, 1))])
    elif direction == (0, 1):  # down
        E = torch.einsum("xy,myr->xmr", C[(c, (-1, 1))], T[(c, (0, 1))])
        E = torch.einsum("xmr,br->xmb", E, C[(c, (1, 1))])
    elif direction == (1, 0):  # right
        E = torch.einsum("tmb,bw->tmw", T[(c, (1, 0))], C[(c, (1, 1))])
        E = torch.einsum("xt,tmw->xmw", C[(c, (1, -1))], E)
    else:
        raise ValueError(f"Invalid direction: {direction}")
    return E


def apply_TM_1sO(coord, direction, sites, site_of, C, T, edge, op=None):
    """Apply one column/row transfer matrix (optional operator) to
    ``edge[chi, D^2, chi]``."""
    c = site_of(coord)
    A = _aXa(sites[c], op)
    if direction == (1, 0):
        # edge = left boundary [top, D^2, bottom]; grow rightward
        E = torch.einsum("tnq,tmb->nqmb", T[(c, (0, -1))], edge)
        E = torch.einsum("nqmb,nmdr->qbdr", E, A)
        return torch.einsum("qbdr,dbw->qrw", E, T[(c, (0, 1))])
    if direction == (0, 1):
        # edge = top boundary [left, D^2, right]; grow downward
        E = torch.einsum("tbn,tmr->bnmr", T[(c, (-1, 0))], edge)
        E = torch.einsum("bnmr,mndw->brdw", E, A)
        return torch.einsum("brdw,rwq->bdq", E, T[(c, (1, 0))])
    raise NotImplementedError(
        f"direction {direction}: grow with (1,0)/(0,1) and read from the other end")


def apply_edge(coord, direction, sites, site_of, C, T, vec):
    """Close the network: ``vec`` against the boundary edge in the growth
    direction."""
    E = get_edge(coord, direction, sites, site_of, C, T)
    return torch.einsum("abc,abc->", vec, E)


def corrf_1sO1sO(coord, direction, sites, site_of, C, T, op1, get_op2, dist: int):
    """<O1(0) O2(r)> for r in [0, dist]; ``get_op2(r)`` is the operator at
    distance r + 1."""
    rev = (-direction[0], -direction[1])
    c0 = coord
    E0 = get_edge(c0, rev, sites, site_of, C, T)
    E1 = apply_TM_1sO(c0, direction, sites, site_of, C, T, E0, op=op1)
    E0 = apply_TM_1sO(c0, direction, sites, site_of, C, T, E0)
    out = []
    for r in range(dist + 1):
        c0 = _shift(c0, direction)
        E12 = apply_TM_1sO(c0, direction, sites, site_of, C, T, E1, op=get_op2(r))
        E0 = apply_TM_1sO(c0, direction, sites, site_of, C, T, E0)
        E1 = apply_TM_1sO(c0, direction, sites, site_of, C, T, E1)
        num = apply_edge(c0, direction, sites, site_of, C, T, E12)
        den = apply_edge(c0, direction, sites, site_of, C, T, E0)
        out.append(num / den)
        scale = E0.abs().max()
        E0, E1 = E0 / scale, E1 / scale
    return torch.stack(out)


def _split_op2(op2, d):
    """SVD-split a two-site gate ``op2[s0,s1,s0',s1']`` into
    ``sum_k o1_k (x) o2_k`` on the host (small d: an exact split); the
    factors go back to ``op2``'s device and dtype."""
    m = np.asarray(op2.detach().cpu()).reshape(d, d, d, d).transpose(0, 2, 1, 3)
    U, S, Vh = np.linalg.svd(m.reshape(d * d, d * d), full_matrices=False)
    k = max(int((S > 1e-14 * max(S[0], 1e-300)).sum()), 1)
    o1 = (U[:, :k] * S[:k][None, :]).T.reshape(k, d, d)
    o2 = Vh[:k].reshape(k, d, d)
    conv = lambda x: torch.as_tensor(x, device=op2.device).to(op2.dtype)
    return conv(o1), conv(o2)


def apply_TM_2sO(coord, direction, sites, site_of, C, T, edge, op2=None):
    """Apply TWO consecutive transfer columns with an optional 2-site
    operator spanning them."""
    c1 = _shift(coord, direction)
    if op2 is None:
        E = apply_TM_1sO(coord, direction, sites, site_of, C, T, edge)
        return apply_TM_1sO(c1, direction, sites, site_of, C, T, E)
    o1s, o2s = _split_op2(op2, sites[site_of(coord)].shape[0])
    out = None
    for k in range(o1s.shape[0]):
        E = apply_TM_1sO(coord, direction, sites, site_of, C, T, edge, op=o1s[k])
        E = apply_TM_1sO(c1, direction, sites, site_of, C, T, E, op=o2s[k])
        out = E if out is None else out + E
    return out


def corrf_2sOH2sOH_E1(coord, direction, sites, site_of, C, T, op1, get_op2, dist: int):
    """<O1(0,1) O2(r,r+1)> of 2-site operators oriented along ``direction``,
    for r in [1, dist]."""
    rev = (-direction[0], -direction[1])
    c0 = coord
    E0 = get_edge(c0, rev, sites, site_of, C, T)
    E1 = apply_TM_2sO(c0, direction, sites, site_of, C, T, E0, op2=op1)
    E0 = apply_TM_2sO(c0, direction, sites, site_of, C, T, E0)
    c0 = _shift(_shift(c0, direction), direction)
    out = []
    for r in range(dist):
        E12 = apply_TM_2sO(c0, direction, sites, site_of, C, T, E1, op2=get_op2(r))
        E0n = apply_TM_2sO(c0, direction, sites, site_of, C, T, E0)
        num = apply_edge(_shift(c0, direction), direction, sites, site_of, C, T, E12)
        den = apply_edge(_shift(c0, direction), direction, sites, site_of, C, T, E0n)
        out.append(num / den)
        E0 = apply_TM_1sO(c0, direction, sites, site_of, C, T, E0)
        E1 = apply_TM_1sO(c0, direction, sites, site_of, C, T, E1)
        scale = E0.abs().max()
        E0, E1 = E0 / scale, E1 / scale
        c0 = _shift(c0, direction)
    return torch.stack(out)


def get_edge2(coord, direction, sites, site_of, C, T):
    """Width-2 boundary edge C-T-T-C over rows y, y+1, ``[chi, D^2, D^2,
    chi]``: the left boundary (-1,0) of a rightward channel or its right
    closing edge (1,0)."""
    c0 = site_of(coord)
    c1 = site_of((coord[0], coord[1] + 1))
    if direction == (-1, 0):
        E = torch.einsum("xy,xbm->ybm", C[(c0, (-1, -1))], T[(c0, (-1, 0))])
        E = torch.einsum("ybm,bwn->ymnw", E, T[(c1, (-1, 0))])
        return torch.einsum("ymnw,wv->ymnv", E, C[(c1, (-1, 1))])
    if direction == (1, 0):
        E = torch.einsum("tmb,xt->xmb", T[(c0, (1, 0))], C[(c0, (1, -1))])
        E = torch.einsum("xmb,bnw->xmnw", E, T[(c1, (1, 0))])
        return torch.einsum("xmnw,wv->xmnv", E, C[(c1, (1, 1))])
    raise NotImplementedError(f"direction {direction}")


def apply_TM_1sO_2(coord, direction, sites, site_of, C, T, edge, op2=None):
    """Grow a WIDTH-2 channel by one column T, a(x,y), a(x,y+1), T, with an
    optional vertical 2-site operator inside the column (+x growth only)."""
    if direction != (1, 0):
        raise NotImplementedError("width-2 channel implemented for +x growth")
    c0 = site_of(coord)
    c1 = site_of((coord[0], coord[1] + 1))
    if op2 is None:
        parts = [(_aXa(sites[c0]), _aXa(sites[c1]))]
    else:
        o1s, o2s = _split_op2(op2, sites[c0].shape[0])
        parts = [(_aXa(sites[c0], o1s[k]), _aXa(sites[c1], o2s[k]))
                 for k in range(o1s.shape[0])]
    Tt, Tb = T[(c0, (0, -1))], T[(c1, (0, 1))]
    out = None
    for A0, A1 in parts:
        E = torch.einsum("tnq,tmzb->nqmzb", Tt, edge)
        E = torch.einsum("nqmzb,nmdr->qzbdr", E, A0)
        E = torch.einsum("qzbdr,dzev->qbrev", E, A1)
        E = torch.einsum("qbrev,ebw->qrvw", E, Tb)
        out = E if out is None else out + E
    return out


def corrf_2sOV2sOV_E2(coord, direction, sites, site_of, C, T, op1, get_op2, dist: int):
    """<O1(0) O2(r)> of vertical 2-site operators along +x through a
    width-2 channel, for r in [0, dist]."""
    if direction != (1, 0):
        raise NotImplementedError("width-2 channel implemented for +x growth")
    c0 = coord
    E0 = get_edge2(c0, (-1, 0), sites, site_of, C, T)
    E1 = apply_TM_1sO_2(c0, direction, sites, site_of, C, T, E0, op2=op1)
    E0 = apply_TM_1sO_2(c0, direction, sites, site_of, C, T, E0)
    out = []
    for r in range(dist + 1):
        c0 = _shift(c0, direction)
        E12 = apply_TM_1sO_2(c0, direction, sites, site_of, C, T, E1, op2=get_op2(r))
        E0 = apply_TM_1sO_2(c0, direction, sites, site_of, C, T, E0)
        E1 = apply_TM_1sO_2(c0, direction, sites, site_of, C, T, E1)
        cap = get_edge2(_shift(c0, direction), direction, sites, site_of, C, T)
        num = torch.einsum("abcd,abcd->", E12, cap)
        den = torch.einsum("abcd,abcd->", E0, cap)
        out.append(num / den)
        scale = E0.abs().max()
        E0, E1 = E0 / scale, E1 / scale
    return torch.stack(out)
