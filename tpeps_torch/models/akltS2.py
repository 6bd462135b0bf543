"""S=2 AKLT model on the square lattice, one-site C4v ansatz with bipartite
rotation (counterpart of ``AKLTS2_C4V_BIPARTITE`` in tpeps/models/akltS2.py):
the bond term projects onto total spin 4, a quartic polynomial in S.S; the
AKLT state is its exact zero-energy ground state.  The generic-cell
``AKLTS2`` waits for the generic RDMs.
"""

from __future__ import annotations

from math import sqrt

import torch

from ..ctm.c4v import rdm as rdm_c4v
from ..groups import su2
from .j1j2 import _cast_to_real


def _aklt_h(dtype, device):
    pd = 5
    SS = su2.SU2(pd, dtype=dtype, device=device).SS()
    SSm = SS.reshape(pd * pd, pd * pd)
    h = (1.0 / 14) * (SSm + (7.0 / 10.0) * SSm @ SSm + (7.0 / 45.0) * SSm @ SSm @ SSm
                      + (1.0 / 90.0) * SSm @ SSm @ SSm @ SSm)
    return h.reshape(pd, pd, pd, pd), SS


class AKLTS2_C4V_BIPARTITE:
    """One-site C4v AKLT with bipartite rotation."""

    def __init__(self, dtype=torch.float64, device="cuda"):
        self.dtype = dtype
        self.device = device
        self.phys_dim = 5
        h, SS = _aklt_h(dtype, device)
        s5 = su2.SU2(self.phys_dim, dtype=dtype, device=device)
        rot = s5.BP_rot()
        # rotate the physical space of the second site
        self.h2_rot = torch.einsum("jl,ilak,kb->ijab", rot, h, rot)
        self.SS = SS
        self.SS_rot = torch.einsum("jl,ilak,kb->ijab", rot, SS, rot)
        self.obs_ops = {"sz": s5.SZ(), "sp": s5.SP(), "sm": s5.SM()}

    def energy_1x1(self, a, env):
        """One bond's <h_rot>."""
        rho = rdm_c4v.rdm2x1_sl(a, env)
        return _cast_to_real(torch.einsum("ijab,ijab", rho, self.h2_rot))

    @torch.no_grad()
    def eval_obs(self, a, env):
        obs = {}
        rho21 = rdm_c4v.rdm2x1_sl(a, env)
        obs["SS2x1"] = complex(torch.einsum("ijab,ijab", rho21, self.SS_rot)).real
        rho1 = torch.einsum("ijaj->ia", rho21)
        rho1 = rho1 / torch.trace(rho1)
        for label, op in self.obs_ops.items():
            obs[label] = complex(torch.trace(rho1 @ op))
        obs["m"] = sqrt(abs(obs["sz"] ** 2 + obs["sp"] * obs["sm"]))
        labels = ["m", "sz", "sp", "sm", "SS2x1"]
        return [obs[l] for l in labels], labels
