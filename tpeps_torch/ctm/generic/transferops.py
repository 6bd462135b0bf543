"""Transfer-operator spectra of a generic unit cell (counterpart of
tpeps/ctm/generic/transferops.py): leading eigenvalues of the width-1
channel transfer operator and of the approximate exp(-H_ent) of a width-L
cylinder, through the Krylov loop of :mod:`tpeps_torch.linalg.arnoldi` on
the environment's device.  ``state`` and ``env`` are duck-typed: ``sites``,
``vertexToSite``, ``site()``, ``lX``, ``lY`` and ``chi``, ``C``, ``T``
dictionaries in the generic layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ...linalg.arnoldi import arnoldi_eigs, seeded_start
from .corrf import apply_TM_1sO


def _as_pairs(w):
    w = w / np.abs(w[0])
    return np.stack([w.real, w.imag], axis=1)


@torch.no_grad()
def get_Top_spec(n: int, coord, direction, state, env, m: int | None = None):
    """Leading ``n`` eigenvalues of the transfer operator in ``direction``,
    normalized by the dominant one, as an (n, 2) numpy array of (re, im)."""
    sites, site_of = state.sites, state.vertexToSite
    a = sites[site_of(coord)]
    chi = env.chi
    if direction == (1, 0):
        D2 = a.shape[2] ** 2
    elif direction == (0, 1):
        D2 = a.shape[1] ** 2
    else:
        raise NotImplementedError(f"direction {direction}")
    shape = (chi, D2, chi)
    # number of sites the channel passes through before repeating
    L = state.lX if direction == (1, 0) else state.lY

    def matvec(v):
        E = v.reshape(shape)
        cc = coord
        for _ in range(L):
            E = apply_TM_1sO(cc, direction, sites, site_of, env.C, env.T, E)
            cc = (cc[0] + direction[0], cc[1] + direction[1])
        return E.reshape(-1)

    return _as_pairs(arnoldi_eigs(matvec, seeded_start(chi * D2 * chi, a), n, m=m))


_DIR_TO_IND = {(0, -1): 1, (-1, 0): 2, (0, 1): 3, (1, 0): 4}


def _eh_T(state, env, c, d):
    """Environment T reshaped to [chi, chi, D, D] with the two bond-facing
    legs split."""
    chi = env.chi
    D = state.site(c).shape[_DIR_TO_IND[d]]
    T = env.T[(state.vertexToSite(c), d)]
    if d == (0, -1):
        return T.permute(0, 2, 1).reshape(chi, chi, D, D)
    if d == (-1, 0):
        return T.reshape(chi, chi, D, D)
    if d == (0, 1):
        return T.permute(1, 2, 0).reshape(chi, chi, D, D)
    if d == (1, 0):
        return T.permute(0, 2, 1).reshape(chi, chi, D, D)
    raise ValueError(d)


@torch.no_grad()
def get_EH_spec_Ttensor(n, L, coord, direction, state, env, m=None):
    """Leading spectrum of exp(-H_ent) of a width-``L`` cylinder, with the
    left/right fixed points sigma_L/sigma_R approximated by MPOs of
    environment T tensors: the matvec applies sigma(direction), then
    sigma(opposite) to a D^L vector with periodic closure.

    :return: (n, 2) numpy array of (re, im) normalized by the leading
        value, or None when D^L <= n
    """
    if L <= 1:
        raise ValueError("L must be larger than 1")
    if not state.lX == state.lY == 1:
        raise NotImplementedError("only single-site unit cells supported")
    ind = _DIR_TO_IND[direction]
    d_grow = {1: (-1, 0), 2: (0, 1), 3: (1, 0), 4: (0, -1)}[ind]
    d_opp = (-direction[0], -direction[1])
    D = state.site(coord).shape[ind]
    size = D**L
    if size <= n:
        return None

    def mv_sigma(V, d_sigma):
        # V[i0..i_{L-1}]; thread chi along the T chain, close periodically
        c = state.vertexToSite(coord)
        T = _eh_T(state, env, c, d_sigma)  # [chi_up, chi_dn, D_out, D_in]
        V = torch.tensordot(T, V, ([3], [0]))  # [u, d, o0, i1..i_{L-1}]
        for i in range(1, L - 1):
            c = (c[0] + d_grow[0], c[1] + d_grow[1])
            T = _eh_T(state, env, c, d_sigma)
            # contract T's chi_up with d_prev and its D_in with i_i
            V = torch.tensordot(T, V, ([0, 3], [1, 2 + i]))
            # [d, o_i, u0, o0..o_{i-1}, i_{i+1}..] -> [u0, d, o0..o_i, i_{i+1}..]
            perm = [2, 0] + list(range(3, 3 + i)) + [1] + list(range(3 + i, L + 2))
            V = V.permute(perm)
        c = (c[0] + d_grow[0], c[1] + d_grow[1])
        T = _eh_T(state, env, c, d_sigma)
        # close: chi_up with V's d, chi_dn with V's u0 (PBC), D_in with the
        # last input leg
        V = torch.tensordot(T, V, ([0, 1, 3], [1, 0, L + 1]))
        return V.permute(list(range(1, L)) + [0])  # [o0..o_{L-1}]

    def matvec(v):
        V = v.reshape((D,) * L)
        V = mv_sigma(mv_sigma(V, direction), d_opp)
        return V.reshape(-1)

    like = env.C[(state.vertexToSite(coord), (-1, -1))]
    return _as_pairs(np.asarray(arnoldi_eigs(matvec, seeded_start(size, like), n, m=m)))


@torch.no_grad()
def get_full_EH_spec_Ttensor(L, coord, direction, state, env):
    """FULL spectrum of the approximate exp(-H_ent) of a width-``L``
    cylinder: sigma_L/sigma_R as dense MPO chains of environment T tensors
    with periodic closure, their product diagonalized on the host (the
    exact counterpart of :func:`get_EH_spec_Ttensor` for small D^L).

    :return: numpy complex eigenvalues of sigma(direction) sigma(opposite),
        by descending magnitude, normalized by the leading one
    """
    ind = _DIR_TO_IND[direction]
    d_grow = {1: (-1, 0), 2: (0, 1), 3: (1, 0), 4: (0, -1)}[ind]
    d_opp = (-direction[0], -direction[1])
    D = state.site(coord).shape[ind]

    def sigma_dense(d_sigma):
        c = state.vertexToSite(coord)
        S = _eh_T(state, env, c, d_sigma)  # [chi_u, chi_d, D_out, D_in]
        for k in range(1, L):
            c = state.vertexToSite((c[0] + d_grow[0], c[1] + d_grow[1]))
            Tk = _eh_T(state, env, c, d_sigma)
            # S axes: [u, o0..o_{k-1}, i0..i_{k-1}, d_new, o_k, i_k]
            S = torch.tensordot(S, Tk, ([1], [0]))
            perm = ([0, 2 * k + 1] + list(range(1, k + 1)) + [2 * k + 2]
                    + list(range(k + 1, 2 * k + 1)) + [2 * k + 3])
            S = S.permute(perm)  # [u, d, o0..o_k, i0..i_k]
        S = torch.diagonal(S, dim1=0, dim2=1).sum(-1)  # PBC closure
        return S.reshape(D**L, D**L)

    M = sigma_dense(direction) @ sigma_dense(d_opp)
    vals = np.linalg.eigvals(M.detach().cpu().numpy())
    vals = vals[np.argsort(-np.abs(vals))]
    return vals / np.abs(vals[0])
