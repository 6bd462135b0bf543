"""Spin-1/2 J1-J2-J3-lambda model with a chiral 4-site plaquette term
(counterpart of tpeps/models/j1j2lambda.py):

    H = J1 sum_<ij> S_i.S_j + J2 sum_<<ij>> S_i.S_j + J3 sum_<<<ij>>> S_i.S_j
      + i lambda sum_p (P_p - P_p^-1)

where P_p permutes the four spins of a plaquette cyclically.  It needs a
complex dtype.
"""

from __future__ import annotations

import torch

from ..ctm.c4v import rdm as rdm_c4v
from ..ctm.c4v.env import EnvC4v
from ..groups import su2
from .j1j2 import J1J2_C4V_BIPARTITE, _cast_to_real

_ROTATE = "xj,yk,ixylauvd,ub,vc->ijklabcd"


def _chiral_plaquette_term(dtype, device):
    """i(P4 - P4^-1) on a 2x2 plaquette in the s0 s1 / s2 s3 physical order
    of the 2x2 RDMs."""
    # swap of the first two of four spin-1/2 sites
    P12 = torch.tensor([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                       dtype=dtype, device=device).reshape(2, 2, 2, 2)
    id2 = torch.eye(4, dtype=dtype, device=device).reshape(2, 2, 2, 2)
    P12II = torch.einsum("abij,cdkl->abcdijkl", P12, id2)
    PI12I = P12II.permute(3, 0, 1, 2, 7, 4, 5, 6)
    PII12 = P12II.permute(2, 3, 0, 1, 6, 7, 4, 5)
    # cyclic permutation from transpositions, applied right to left
    P4 = torch.tensordot(PI12I, P12II, ([4, 5, 6, 7], [0, 1, 2, 3]))
    P4 = torch.tensordot(PII12, P4, ([4, 5, 6, 7], [0, 1, 2, 3]))
    chiral = 1.0j * (P4 - P4.reshape(16, 16).T.reshape((2,) * 8))
    # ring order s0->s1->s3->s2 -> the RDMs' row-major s0 s1 / s2 s3 order
    return chiral.permute(0, 1, 3, 2, 4, 5, 7, 6)


class J1J2LAMBDA_C4V_BIPARTITE(J1J2_C4V_BIPARTITE):
    """C4v bipartite J1-J2-J3-lambda."""

    def __init__(self, j1=1.0, j2=0.0, j3=0.0, hz_stag=0.0, delta_zz=1.0, lmbd=0.0,
                 dtype=torch.complex128, device="cuda"):
        if not dtype.is_complex:
            raise ValueError("J1-J2-lambda requires a complex dtype")
        super().__init__(j1=j1, j2=j2, j3=j3, hz_stag=hz_stag, delta_zz=delta_zz, dtype=dtype,
                         device=device)
        self.lmbd = lmbd
        s2 = su2.SU2(self.phys_dim, dtype=dtype, device=device)
        rot = s2.BP_rot()
        # this model's plaquette term differs from J1J2's: the staggered field
        # enters as the 4-site product SZ(-SZ)(-SZ)SZ, and there is no
        # uniform-field term
        id2 = s2.I_N(N=2)
        h2x2_SS_dzz = torch.einsum("ijab,klcd->ijklabcd", self.SS_delta_zz, id2)
        h2x2_SS = torch.einsum("ijab,klcd->ijklabcd", self.SS, id2)
        perm = lambda t, p: t.permute(p)
        hp = 0.5 * j1 * (
            h2x2_SS_dzz
            + perm(h2x2_SS_dzz, (0, 2, 1, 3, 4, 6, 5, 7))
            + perm(h2x2_SS_dzz, (2, 3, 0, 1, 6, 7, 4, 5))
            + perm(h2x2_SS_dzz, (3, 1, 2, 0, 7, 5, 6, 4))
        ) + j2 * (
            perm(h2x2_SS, (0, 3, 2, 1, 4, 7, 6, 5))
            + perm(h2x2_SS, (2, 1, 0, 3, 6, 5, 4, 7))
        ) - 0.25 * hz_stag * torch.einsum("ia,jb,kc,ld->ijklabcd", s2.SZ(), -s2.SZ(),
                                          -s2.SZ(), s2.SZ())
        self.hp_rot = torch.einsum(_ROTATE, rot, rot, hp, rot, rot)
        self.chiral_rot = torch.einsum(_ROTATE, rot, rot, _chiral_plaquette_term(dtype, device),
                                       rot, rot)
        self.hp_chiral_rot = lmbd * self.chiral_rot

    def energy_1x1(self, a, env: EnvC4v):
        """Energy per site from the full 2x2 RDM (+ the 3x1 RDM for J3)."""
        rho2x2 = rdm_c4v.rdm2x2(a, env)
        e = torch.einsum("ijklabcd,ijklabcd", rho2x2, self.hp_rot + self.hp_chiral_rot)
        if abs(self.j3) > 0:
            rho3x1 = rdm_c4v.rdm3x1(a, env, sym_pos_def=True)
            e = e + 2 * self.j3 * torch.einsum("ijab,ijab", rho3x1, self.SS)
        return _cast_to_real(e)

    @torch.no_grad()
    def eval_obs(self, a, env: EnvC4v):
        """Magnetization, spin components, SS2x1 (+ SS3x1, ChiralT)."""
        obs = {}
        if abs(self.j3) > 0:
            rho3x1 = rdm_c4v.rdm3x1(a, env)
            obs["SS3x1"] = _cast_to_real(torch.einsum("ijab,ijab", rho3x1, self.SS))
        if abs(self.lmbd) > 0:
            rho2x2 = rdm_c4v.rdm2x2(a, env)
            obs["ChiralT"] = _cast_to_real(
                torch.einsum("ijklabcd,ijklabcd", rho2x2, self.chiral_rot))
        rho2x1 = rdm_c4v.rdm2x1_sl(a, env)
        obs["SS2x1"] = _cast_to_real(torch.einsum("ijab,ijab", rho2x1, self.SS_rot))
        rho1x1 = torch.einsum("ijaj->ia", rho2x1)
        rho1x1 = rho1x1 / torch.trace(rho1x1)
        for label, op in self.obs_ops.items():
            obs[label] = torch.trace(rho1x1 @ op)
        obs["m"] = torch.sqrt(torch.abs(obs["sz"] ** 2 + obs["sp"] * obs["sm"]))
        labels = ["m"] + list(self.obs_ops) + ["SS2x1"]
        if abs(self.j3) > 0:
            labels += ["SS3x1"]
        if abs(self.lmbd) > 0:
            labels += ["ChiralT"]
        return [obs[l] for l in labels], labels
