"""J1-J2 model over abelian (U(1)) block-sparse states (counterpart of
tpeps/models/abelian/j1j2.py): the abelian RDMs return dense rho, so the
Hamiltonian terms of :class:`~tpeps_torch.models.j1j2.J1J2` are used as they
are; only the RDM source differs."""

from __future__ import annotations

from math import sqrt

import torch

from ...ctm.generic_abelian import rdm as rdm_ab
from ..j1j2 import J1J2, _cast_to_real


class J1J2_ABELIAN(J1J2):
    """J1-J2 energies and observables from abelian environments; methods take
    ``(state: IPEPS_ABELIAN, env: ENV_ABELIAN)``."""

    def energy_per_site(self, state, env):
        """Average 2x2-plaquette energy over the unit cell's sites."""
        assert self.j3 == 0
        e = 0.0
        for coord in state.sites:
            rho = rdm_ab.rdm2x2(coord, state, env)
            e = e + torch.einsum("ijklabcd,ijklabcd", rho, self.get_hp(coord))
        return _cast_to_real(e / len(state.sites))

    @torch.no_grad()
    def eval_obs(self, state, env):
        """Per-site magnetizations and NN bond <S.S>."""
        obs = {}
        for coord in state.sites:
            rho = rdm_ab.rdm1x1(coord, state, env)
            for label, op in self.obs_ops.items():
                obs[f"{label}{coord}"] = complex(torch.trace(rho @ op))
            obs[f"m{coord}"] = sqrt(
                abs(obs[f"sz{coord}"] ** 2 + obs[f"sp{coord}"] * obs[f"sm{coord}"]))
        for coord in state.sites:
            rho_h = rdm_ab.rdm2x1(coord, state, env)
            rho_v = rdm_ab.rdm1x2(coord, state, env)
            obs[f"SS2x1{coord}"] = complex(torch.einsum("ijab,ijab", rho_h, self.SS_delta_zz)).real
            obs[f"SS1x2{coord}"] = complex(torch.einsum("ijab,ijab", rho_v, self.SS_delta_zz)).real
        labels = ([f"m{c}" for c in state.sites]
                  + [f"{l}{c}" for c in state.sites for l in self.obs_ops]
                  + [f"SS2x1{c}" for c in state.sites]
                  + [f"SS1x2{c}" for c in state.sites])
        return [obs[l] for l in labels], labels
