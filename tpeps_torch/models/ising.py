"""Transverse-field Ising model with a plaquette term, one-site C4v ansatz
(counterpart of ``ISING_C4V`` in tpeps/models/ising.py):

    H = -sum_<ij> 4 Sz_i Sz_j + q sum_p 16 (Sz)^4_p - hx sum_i 2 Sx_i

The generic-cell ``ISING`` waits for the generic RDMs.
"""

from __future__ import annotations

import torch

from ..ctm.c4v import rdm as rdm_c4v
from ..groups import su2
from .j1j2 import _cast_to_real


class ISING_C4V:
    """One-site C4v transverse-field Ising model."""

    def __init__(self, hx=0.0, q=0.0, dtype=torch.float64, device="cuda"):
        self.dtype = dtype
        self.device = device
        self.phys_dim = 2
        self.hx = hx
        self.q = q
        s2 = su2.SU2(self.phys_dim, dtype=dtype, device=device)
        id2 = torch.eye(4, dtype=dtype, device=device).reshape(2, 2, 2, 2)
        SzSz = 4 * torch.einsum("ij,ab->iajb", s2.SZ(), s2.SZ())
        SzSzIdId = torch.einsum("ijab,klcd->ijklabcd", SzSz, id2)
        SzSzSzSz = torch.einsum("ijab,klcd->ijklabcd", SzSz, SzSz)
        Sx = s2.SP() + s2.SM()
        SxId = torch.einsum("ij,ab->iajb", Sx, s2.I())
        SxIdIdId = torch.einsum("ia,jb,kc,ld->ijklabcd", Sx, s2.I(), s2.I(), s2.I())
        self.szsz = SzSz
        self.szszszsz = SzSzSzSz
        self.sx = Sx
        self.h2 = -SzSz - 0.5 * hx * SxId
        self.hp = (-SzSzIdId - SzSzIdId.permute(0, 2, 1, 3, 4, 6, 5, 7) - q * SzSzSzSz
                   - hx * SxIdIdId)
        self.obs_ops = {"sz": 2 * s2.SZ(), "sp": 2 * s2.SP(), "sm": 2 * s2.SM()}

    def energy_1x1_nn(self, a, env):
        """Nearest-neighbour energy from the 2x1 RDM (q = 0 only)."""
        if self.q != 0:
            raise ValueError("the plaquette term needs energy_1x1_plaqette")
        rho = rdm_c4v.rdm2x1_sl(a, env)
        eSx = torch.einsum("ijaj,ia", rho, self.sx)
        eSzSz = torch.einsum("ijab,ijab", rho, self.szsz)
        return _cast_to_real(-2 * eSzSz - self.hx * eSx)

    def energy_1x1_plaqette(self, a, env):
        """Plaquette energy from the full 2x2 RDM."""
        rho = rdm_c4v.rdm2x2(a, env)
        return _cast_to_real(torch.einsum("ijklabcd,ijklabcd", rho, self.hp))

    @torch.no_grad()
    def eval_obs(self, a, env):
        obs = {}
        rho = rdm_c4v.rdm1x1(a, env)
        for label, op in self.obs_ops.items():
            obs[label] = complex(torch.trace(rho @ op)).real
        obs["sx"] = 0.5 * (obs["sp"] + obs["sm"])
        rho22 = rdm_c4v.rdm2x2(a, env)
        obs["SzSzSzSz"] = complex(torch.einsum("ijklabcd,ijklabcd", rho22, self.szszszsz)).real
        labels = ["sz", "sx", "SzSzSzSz"]
        return [obs[l] for l in labels], labels
