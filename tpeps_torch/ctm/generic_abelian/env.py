"""Abelian block-sparse CTM environment for generic unit cells (counterpart
of tpeps/ctm/generic_abelian/env.py): the container and its
initializations.  Environment legs keep their charge structure and the
D-pair legs stay unfused:

* ``C[(coord,(dx,dy))]`` rank-2 (chi, chi)
* ``T[(c,(0,-1))]`` top:    (chi_left, Dk_down, Db_down, chi_right)
* ``T[(c,(-1,0))]`` left:   (chi_up, chi_down, Dk_right, Db_right)
* ``T[(c,(0,1))]``  bottom: (Dk_up, Db_up, chi_left, chi_right)
* ``T[(c,(1,0))]``  right:  (chi_up, Dk_left, Db_left, chi_down)

chi legs carry emergent charge sectors: the initial ones are fused
double-layer (ket, bra) pairs, after a move the truncated SVD legs.
"""

from __future__ import annotations

import torch

from ...sym.tensor import AbelianTensor, leg

CORNER_VECS = ((-1, -1), (1, -1), (1, 1), (-1, 1))
EDGE_VECS = ((0, -1), (-1, 0), (0, 1), (1, 0))


class ENV_ABELIAN:
    """Container of AbelianTensor corners and edges."""

    def __init__(self, chi: int, C=None, T=None):
        self.chi = chi
        self.C = dict(C) if C else {}
        self.T = dict(T) if T else {}

    def clone(self):
        return ENV_ABELIAN(self.chi, dict(self.C), dict(self.T))

    def get_spectra(self):
        """Sorted singular values of every corner (dense embedding)."""
        return {k: torch.linalg.svdvals(c.to_dense()) for k, c in self.C.items()}


def env_with_grading(env: ENV_ABELIAN, fermionic: bool) -> ENV_ABELIAN:
    """Every environment tensor with the given Grassmann grading flag (the
    flat buffers shared, no copies): the bosonic environment's graded view
    that fermionic observables contract with (see the JAX package)."""
    out = ENV_ABELIAN(env.chi)
    for grp, dst in ((env.C, out.C), (env.T, out.T)):
        for k, t in grp.items():
            dst[k] = AbelianTensor._flat(t, t.struct, t.data, fermionic=fermionic)
    return out


def _normalized(t):
    """``t / max|t|`` with the scale detached."""
    return t * (1.0 / t.max_abs().detach())


def init_env(state, chi: int, init_type: str = "CTMRG") -> ENV_ABELIAN:
    if init_type == "CTMRG":
        return init_from_ipeps_pbc(state, chi)
    if init_type == "eye":
        return init_eye(state, chi)
    raise ValueError(f"Invalid abelian environment initialization: {init_type}")


# corner signatures mirroring init_from_ipeps_pbc's fused pairs
_EYE_CORNER_SIG = {(-1, -1): (-1, -1), (1, -1): (1, -1), (1, 1): (1, 1), (-1, 1): (1, -1)}


def init_eye(state, chi: int) -> ENV_ABELIAN:
    """Identity-channel environment: every corner the scalar 1 on a dim-1
    charge-0 chi leg, every edge the identity on its (ket, bra) bond pair;
    the ket leg keeps the site tensor's signature, the bra leg its
    conjugate's (the JAX package's ``init_eye``)."""
    env = ENV_ABELIAN(chi)
    for coord in state.sites:
        a = state.sites[coord]
        sym = a.sym
        q0 = (0, 0) if sym == "U1xU1" else 0
        t0 = leg({q0: 1})
        one = torch.ones((1, 1), dtype=torch.float64)
        for cvec in CORNER_VECS:
            env.C[(coord, cvec)] = AbelianTensor(sym, _EYE_CORNER_SIG[cvec], (t0, t0), 0,
                                                 {(q0, q0): one}, a.dtype, a.fermionic,
                                                 device=a.device)

        def eye_edge(bond_ax, order):
            lk = a.legs[bond_ax]
            sk, sb = -a.signature[bond_ax], a.signature[bond_ax]
            legs, sig = {"mid": ((t0, lk, lk, t0), (1, sk, sb, -1)),
                         "tail": ((t0, t0, lk, lk), (1, -1, sk, sb)),
                         "head": ((lk, lk, t0, t0), (sk, sb, 1, -1))}[order]
            blocks = {}
            for q, d in lk.charges:
                ey = torch.eye(d, dtype=torch.float64)
                if order == "mid":
                    blocks[(q0, q, q, q0)] = ey.reshape(1, d, d, 1)
                elif order == "tail":
                    blocks[(q0, q0, q, q)] = ey.reshape(1, 1, d, d)
                else:
                    blocks[(q, q, q0, q0)] = ey.reshape(d, d, 1, 1)
            return AbelianTensor(sym, sig, legs, 0, blocks, a.dtype, a.fermionic,
                                 device=a.device)

        env.T[(coord, (0, -1))] = eye_edge(1, "mid")    # (chi_l, uk, ub, chi_r)
        env.T[(coord, (-1, 0))] = eye_edge(2, "tail")   # (chi_u, chi_d, lk, lb)
        env.T[(coord, (0, 1))] = eye_edge(3, "head")    # (dk, db, chi_l, chi_r)
        env.T[(coord, (1, 0))] = eye_edge(4, "mid")     # (chi_u, rk, rb, chi_d)
    return env


def init_from_ipeps_pbc(state, chi: int) -> ENV_ABELIAN:
    """Environment from PBC-traced double layers: the site's double layer
    with the physical leg and the outward legs traced, (ket, bra) pairs
    fused into chi legs (``fuse_pair``), each tensor normalized by its max."""
    env = ENV_ABELIAN(chi)

    def corner(A, axes):
        c = A.tensordot(A.conj(), (axes, axes))
        return _normalized(c.transpose((0, 2, 1, 3)).fuse_pair(0).fuse_pair(1))

    def edge(A, axes, order, fuse):
        t = A.tensordot(A.conj(), (axes, axes)).transpose(order)
        for i in fuse:
            t = t.fuse_pair(i)
        return _normalized(t)

    for coord in state.sites:
        x, y = coord
        # site legs a[s,u,l,d,r] = (0..4)
        env.C[(coord, (-1, -1))] = corner(state.site((x - 1, y - 1)), (0, 1, 2))  # [d^2, r^2]
        env.C[(coord, (1, -1))] = corner(state.site((x + 1, y - 1)), (0, 1, 4))   # [l^2, d^2]
        env.C[(coord, (1, 1))] = corner(state.site((x + 1, y + 1)), (0, 3, 4))    # [u^2, l^2]
        env.C[(coord, (-1, 1))] = corner(state.site((x - 1, y + 1)), (0, 2, 3))   # [u^2, r^2]
        perm = (0, 3, 1, 4, 2, 5)
        env.T[(coord, (0, -1))] = edge(state.site((x, y - 1)), (0, 1), perm, (0, 3))
        env.T[(coord, (-1, 0))] = edge(state.site((x - 1, y)), (0, 2), perm, (0, 1))
        env.T[(coord, (0, 1))] = edge(state.site((x, y + 1)), (0, 3), perm, (2, 3))
        env.T[(coord, (1, 0))] = edge(state.site((x + 1, y)), (0, 4), perm, (0, 3))
    return env

