"""C4v-symmetric abelian CTM environment: one corner C and one edge T
(counterpart of tpeps/ctm/c4v_abelian/env.py).

The lattice carries the C4v tensor ``A`` (uniform signature +1, as stored
in C4v abelian state files) on one sublattice and ``B = flip_signature(A)``
on the other (the U(1) Neel pattern); ``C`` is the double layer of ``A``,
``T`` of ``B``.  Leg conventions (ket-major pairs)::

    C: (d-pair fused [+1], r-pair fused [+1])
    T: (chi_left [-1], D_ket [-1], D_bra [+1], chi_right [-1])
"""

from __future__ import annotations

import torch

from ...ipeps.ipeps_abelian import IPEPS_ABELIAN
from ...sym.tensor import AbelianTensor, _qscale


def flip_signature(t):
    """yastn's ``flip_signature``: flip every leg signature and the total
    charge; block charges and values are unchanged (no copy)."""
    return AbelianTensor._flat(t, t.struct, t.data, signature=tuple(-s for s in t.signature),
                               n=_qscale(t.sym, -1, t.n), fermionic=False, conj_reversal=False)


class ENV_C4V_ABELIAN:
    def __init__(self, chi: int, C=None, T=None):
        self.chi = chi
        self.C = C
        self.T = T

    def get_spectrum(self):
        """Singular values of the dense corner, descending, on the host."""
        return torch.linalg.svdvals(self.C.to_dense()).cpu().numpy()


def _normalized(t):
    return t * (1.0 / float(t.max_abs()))


def init_env(state, chi: int) -> ENV_C4V_ABELIAN:
    """PBC double-layer init (reference env_c4v_abelian.py:214-283)."""
    A = state.site((0, 0))
    assert A.signature == (1, 1, 1, 1, 1), (
        "C4v abelian engine expects the native uniform +1 signature "
        f"(got {A.signature}); read states with read_ipeps_abelian")
    B = flip_signature(A)
    c = A.tensordot(A.conj(), ((0, 1, 2), (0, 1, 2)))  # (dk, rk, db, rb)
    c = c.transpose((0, 2, 1, 3)).fuse_pair(0).fuse_pair(1)
    t = B.tensordot(B.conj(), ((0, 1), (0, 1)))  # (lk,dk,rk, lb,db,rb)
    t = t.transpose((0, 3, 1, 4, 2, 5)).fuse_pair(0)  # (chi_l, dk, db, rk, rb)
    t = t.fuse_pair(3)  # (chi_l, dk, db, chi_r)
    return ENV_C4V_ABELIAN(chi, _normalized(c), _normalized(t))


def _phase_b(B):
    """The B-sublattice phase: -1 on the physical charge +1 component."""
    return B.copy_with({qs: (-b if qs[0] == 1 else b) for qs, b in B.blocks.items()})


def as_generic(state, env: ENV_C4V_ABELIAN):
    """View the C4v environment as a generic bipartite one: ``(state_bp,
    env_g)`` with the explicit [[A,B],[B,A]] Neel state (B with the physical
    phase, so energies use the plain Hamiltonian) and the single (C, T) in
    all 8 generic slots per site via C4v transposes and sublattice flips."""
    from ..generic_abelian.env import ENV_ABELIAN

    A = state.site((0, 0))
    B = _phase_b(flip_signature(A)).flip_charges((0,))
    st = IPEPS_ABELIAN(state.sym, {(0, 0): A, (1, 0): B},
                       vertexToSite=lambda x: ((x[0] + x[1]) % 2, 0), lX=2, lY=2)
    C, T = env.C, env.T
    Cf, Tf = flip_signature(C), flip_signature(T)
    g = ENV_ABELIAN(env.chi)
    for c, CC, TT in (((0, 0), C, T), ((1, 0), Cf, Tf)):
        for vec in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            g.C[(c, vec)] = CC
        g.T[(c, (0, -1))] = TT                          # (chi_l, dk, db, chi_r)
        g.T[(c, (-1, 0))] = TT.transpose((0, 3, 1, 2))  # (chi_u, chi_d, rk, rb)
        g.T[(c, (0, 1))] = TT.transpose((1, 2, 0, 3))   # (uk, ub, chi_l, chi_r)
        g.T[(c, (1, 0))] = TT                           # (chi_u, lk, lb, chi_d)
    return st, g
