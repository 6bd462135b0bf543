"""Spin-1/2 J1-J2(-J3) model (counterpart of ``J1J2`` and
``J1J2_C4V_BIPARTITE`` in tpeps/models/j1j2.py): ``J1J2`` builds the
Hamiltonian terms (the 2x2-plaquette term ``get_hp`` that the abelian model
contracts with its RDMs, its rotated form ``hp_rot``, the bond operators,
the observables' operators); ``J1J2_C4V_BIPARTITE`` adds the C4v energies,
observables and correlation functions.  The operators live on ``device``:
the card unless the caller asks for the CPU."""

from __future__ import annotations

from math import sqrt

import torch

from ..ctm.c4v import corrf as corrf_c4v
from ..ctm.c4v import rdm as rdm_c4v
from ..ctm.c4v.env import EnvC4v
from ..groups import su2


def _cast_to_real(t):
    return t.real if t.is_complex() else t


def _contract(rho, op):
    return torch.einsum("ijkl,ijkl", rho, op)


class J1J2:
    """Hamiltonian terms of the J1-J2-J3 model on the square lattice."""

    def __init__(self, j1=1.0, j2=0.0, j3=0.0, hz_stag=0.0, delta_zz=1.0,
                 h_uni=(0.0, 0.0, 0.0), dtype=torch.float64, device="cuda"):
        self.dtype = dtype
        self.device = device
        self.phys_dim = 2
        self.j1, self.j2, self.j3 = j1, j2, j3
        self.hz_stag = hz_stag
        self.delta_zz = delta_zz
        self.h_uni = torch.as_tensor(h_uni, dtype=dtype, device=device)
        self._h_uni_norm = float(sum(abs(h) ** 2 for h in h_uni) ** 0.5)
        if h_uni[2] != 0 and not dtype.is_complex:
            raise ValueError("the h^y term requires a complex dtype")

        s2 = su2.SU2(self.phys_dim, dtype=dtype, device=device)
        id2, id3 = s2.I_N(N=2), s2.I_N(N=3)
        kron = lambda x, y: torch.einsum("ij,ab->iajb", x, y)
        self.SS_delta_zz = s2.SS(xyz=(delta_zz, 1.0, 1.0))
        self.SS = s2.SS()
        h_uni_1x1 = torch.einsum("x,xia->ia", self.h_uni, s2.S())
        hz_2x1_nn = kron(s2.SZ(), s2.I()) + kron(s2.I(), -s2.SZ())
        huni_2x1_nn = kron(h_uni_1x1, s2.I()) + kron(s2.I(), h_uni_1x1)

        rot = s2.BP_rot()
        rot2 = lambda op: torch.einsum("ki,kjcb,ca->ijab", rot, op, rot)
        self.SS_rot = rot2(self.SS)
        self.SS_delta_zz_rot = rot2(self.SS_delta_zz)
        self.hz_2x1_rot = rot2(hz_2x1_nn)
        self.huni_2x1_rot = rot2(huni_2x1_nn)

        # plaquette terms h_p such that e = <h_p> (reference j1j2.py:123-147)
        h2x2_SS_dzz = torch.einsum("ijab,klcd->ijklabcd", self.SS_delta_zz, id2)
        h2x2_SS = torch.einsum("ijab,klcd->ijklabcd", self.SS, id2)
        h2x2_hz = torch.einsum("ia,jklbcd->ijklabcd", s2.SZ(), id3)
        h2x2_hu = torch.einsum("ia,jklbcd->ijklabcd", h_uni_1x1, id3)

        def get_hp(coord):
            perm = lambda t, p: t.permute(p)
            return 0.5 * self.j1 * (
                h2x2_SS_dzz
                + perm(h2x2_SS_dzz, (0, 2, 1, 3, 4, 6, 5, 7))
                + perm(h2x2_SS_dzz, (2, 3, 0, 1, 6, 7, 4, 5))
                + perm(h2x2_SS_dzz, (3, 1, 2, 0, 7, 5, 6, 4))
            ) + self.j2 * (
                perm(h2x2_SS, (0, 3, 2, 1, 4, 7, 6, 5))
                + perm(h2x2_SS, (2, 1, 0, 3, 6, 5, 4, 7))
            ) - 0.25 * self.hz_stag * ((-1) ** (coord[0] + coord[1])) * (
                h2x2_hz
                - perm(h2x2_hz, (3, 0, 1, 2, 7, 4, 5, 6))
                - perm(h2x2_hz, (2, 3, 0, 1, 6, 7, 4, 5))
                + perm(h2x2_hz, (1, 2, 3, 0, 5, 6, 7, 4))
            ) + 0.25 * (
                h2x2_hu
                + perm(h2x2_hu, (2, 3, 0, 1, 6, 7, 4, 5))
                + perm(h2x2_hu, (3, 0, 1, 2, 7, 4, 5, 6))
                + perm(h2x2_hu, (1, 2, 3, 0, 5, 6, 7, 4))
            )

        self.get_hp = get_hp
        self.hp_rot = torch.einsum("xj,yk,ixylauvd,ub,vc->ijklabcd", rot, rot, get_hp((0, 0)),
                                   rot, rot)
        self.obs_ops = {"sz": s2.SZ(), "sp": s2.SP(), "sm": s2.SM()}
        # the chiral plaquette coupling: J1J2LAMBDA_C4V_BIPARTITE sets it
        self.lmbd = 0.0

    def _no_lambda(self, what):
        if self.lmbd != 0:
            raise ValueError(f"{what} does not include the lambda chiral plaquette term; "
                             "use J1J2LAMBDA_C4V_BIPARTITE (tpeps_torch.models.j1j2lambda)")


class J1J2_C4V_BIPARTITE(J1J2):
    """J1-J2-J3 on the square lattice, 1-site C4v ansatz, bipartite rotation."""

    def __init__(self, j1=1.0, j2=0.0, j3=0.0, hz_stag=0.0, delta_zz=1.0,
                 h_uni=(0.0, 0.0, 0.0), dtype=torch.float64, device="cuda"):
        super().__init__(j1=j1, j2=j2, j3=j3, hz_stag=hz_stag, delta_zz=delta_zz,
                         h_uni=h_uni, dtype=dtype, device=device)

    def energy_1x1(self, a, env: EnvC4v):
        """Energy per site from the full 2x2-plaquette RDM (+ the 3x1 RDM for
        J3)."""
        self._no_lambda("energy_1x1")
        rho2x2 = rdm_c4v.rdm2x2(a, env, sym_pos_def=True)
        e = torch.einsum("ijklabcd,ijklabcd", rho2x2, self.hp_rot)
        if abs(self.j3) > 0:
            rho3x1 = rdm_c4v.rdm3x1(a, env, sym_pos_def=True)
            e = e + 2 * self.j3 * _contract(rho3x1, self.SS)
        return _cast_to_real(e)

    def _energy_nn_nnn(self, a, env, rdm_nn, rdm_nnn):
        rho_nn = rdm_nn(a, env, sym_pos_def=True)
        e = 2.0 * self.j1 * _contract(rho_nn, self.SS_delta_zz_rot)
        e = e - 0.5 * self.hz_stag * _contract(rho_nn, self.hz_2x1_rot)
        if self._h_uni_norm > 0:
            e = e + 0.5 * _contract(rho_nn, self.huni_2x1_rot)
        if abs(self.j2) > 0:
            rho_nnn = rdm_nnn(a, env, sym_pos_def=True)
            e = e + 2.0 * self.j2 * _contract(rho_nnn, self.SS)
        if abs(self.j3) > 0:
            rho3x1 = rdm_c4v.rdm3x1_sl(a, env, sym_pos_def=True)
            e = e + 2 * self.j3 * _contract(rho3x1, self.SS)
        return _cast_to_real(e)

    def energy_1x1_lowmem(self, a, env: EnvC4v):
        """Energy per site from the NN + NNN (+ 3x1) RDMs; differentiable in
        ``a`` and ``env``."""
        self._no_lambda("energy_1x1_lowmem")
        return self._energy_nn_nnn(a, env, rdm_c4v.rdm2x2_NN_lowmem_sl,
                                   rdm_c4v.rdm2x2_NNN_lowmem_sl)

    def energy_1x1_tiled(self, a, env: EnvC4v):
        """Energy per site through the ``*_tiled`` RDM entry points."""
        self._no_lambda("energy_1x1_tiled")
        return self._energy_nn_nnn(a, env, rdm_c4v.rdm2x2_NN_tiled, rdm_c4v.rdm2x2_NNN_tiled)

    @torch.no_grad()
    def eval_obs(self, a, env: EnvC4v):
        """Observables (m, <sz>, <sp>, <sm>, SS2x1, [SS_nnn], [SS3x1])."""
        obs = {}
        if abs(self.j3) > 0:
            obs["SS3x1"] = complex(_contract(rdm_c4v.rdm3x1_sl(a, env), self.SS)).real
        if abs(self.j2) > 0:
            rho_nnn = rdm_c4v.rdm2x2_NNN_lowmem_sl(a, env)
            obs["SS_nnn"] = complex(_contract(rho_nnn, self.SS)).real
        rho2x1 = rdm_c4v.rdm2x1_sl(a, env)
        obs["SS2x1"] = complex(_contract(rho2x1, self.SS_rot)).real
        rho1x1 = torch.einsum("ijaj->ia", rho2x1)
        rho1x1 = rho1x1 / torch.trace(rho1x1)
        for label, op in self.obs_ops.items():
            obs[label] = complex(torch.trace(rho1x1 @ op))
        obs["m"] = sqrt(abs(obs["sz"] ** 2 + obs["sp"] * obs["sm"]))
        labels = ["m"] + list(self.obs_ops) + ["SS2x1"]
        if abs(self.j2) > 0:
            labels += ["SS_nnn"]
        if abs(self.j3) > 0:
            labels += ["SS3x1"]
        return [obs[l] for l in labels], labels

    @torch.no_grad()
    def eval_corrf_SS(self, a, env: EnvC4v, dist: int):
        """Spin-spin correlations <S(0).S(r)>, r = 1..dist+1, with the
        bipartite rotation on the second operator at odd distances."""
        sz = self.obs_ops["sz"]
        sx = 0.5 * (self.obs_ops["sp"] + self.obs_ops["sm"])
        isy = -0.5 * (self.obs_ops["sp"] - self.obs_ops["sm"])  # i*Sy
        rot = su2.get_rot_op(self.phys_dim, dtype=self.dtype, device=self.device)

        def bilat(op):
            op_rot = torch.einsum("ki,kl,lj->ij", rot, op, rot)
            return lambda r: op_rot if r % 2 == 0 else op

        szsz = corrf_c4v.corrf_1sO1sO(a, env, sz, bilat(sz), dist)
        sxsx = corrf_c4v.corrf_1sO1sO(a, env, sx, bilat(sx), dist)
        nsysy = corrf_c4v.corrf_1sO1sO(a, env, isy, bilat(isy), dist)
        return {"ss": szsz + sxsx - nsysy, "szsz": szsz, "sxsx": sxsx, "sysy": -nsysy}

    def _SS_rot_pair(self):
        """S.S with the bipartite rotation on the first spin, and its image
        with the rotation on the second spin."""
        rot = su2.get_rot_op(self.phys_dim, dtype=self.dtype, device=self.device)
        SS_rot = torch.einsum("ki,kjcb,ca->ijab", rot, self.SS, rot)
        return SS_rot, SS_rot.permute(1, 0, 3, 2)

    @torch.no_grad()
    def eval_corrf_DD_H(self, a, env: EnvC4v, dist: int):
        """Horizontal dimer-dimer correlations <(S(r+3).S(r+2))(S(1).S(0))>."""
        SS_rot, op_rot = self._SS_rot_pair()
        return {"dd": corrf_c4v.corrf_2sOH2sOH_E1(
            a, env, SS_rot, lambda r: SS_rot if r % 2 == 0 else op_rot, dist)}

    @torch.no_grad()
    def eval_corrf_DD_V(self, a, env: EnvC4v, dist: int):
        """Vertical dimer-dimer correlations <(S(r+1,1).S(r+1,0))(S(0,1).S(0,0))>
        through the width-2 channel."""
        SS_rot, op_rot = self._SS_rot_pair()
        return {"dd": corrf_c4v.corrf_2sOV2sOV_E2(
            a, env, SS_rot, lambda r: SS_rot if r % 2 == 0 else op_rot, dist)}
