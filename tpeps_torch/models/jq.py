"""J-Q model: Heisenberg bonds and the 4-site plaquette singlet-projector
term, one-site C4v ansätze (counterpart of ``JQ_C4V``, ``JQ_C4V_BIPARTITE``
and ``JQ_C4V_PLAQUETTE`` in tpeps/models/jq.py):

    H = j1 sum_<ij> S_i.S_j - q sum_p (S_i.S_j - 1/4)(S_k.S_l - 1/4) + the
        other pairing of each plaquette

The generic-cell ``JQ`` waits for the generic RDMs.
"""

from __future__ import annotations

from math import sqrt

import torch

from ..ctm.c4v import rdm as rdm_c4v
from ..groups import su2
from .j1j2 import _cast_to_real


def _embed(op2, idx, n, eye):
    """The two-site operator ``op2[b1,b2,k1,k2]`` at qubits ``idx=(i,j)`` of an
    ``n``-qubit register as a ``2^n x 2^n`` matrix (products of disjoint
    supports then compose by matrix products)."""
    bra = [chr(ord("a") + i) for i in range(n)]
    ket = [chr(ord("A") + i) for i in range(n)]
    i, j = idx
    sub_op = bra[i] + bra[j] + ket[i] + ket[j]
    sub_ids = [bra[k] + ket[k] for k in range(n) if k not in idx]
    out = "".join(bra) + "".join(ket)
    t = torch.einsum(",".join([sub_op] + sub_ids) + "->" + out, op2, *([eye] * len(sub_ids)))
    return t.reshape(2**n, 2**n)


class JQ_C4V:
    """One-site C4v J-Q: one 2x2 plaquette RDM carries the whole energy,
    e = <hp> with hp folding two NN bonds and the two ring pairings."""

    def __init__(self, j1=0.0, q=1.0, dtype=torch.float64, device="cuda", rotated=False):
        self.dtype = dtype
        self.device = device
        self.phys_dim = 2
        self.j1 = j1
        self.q = q
        s2 = su2.SU2(self.phys_dim, dtype=dtype, device=device)
        id2 = torch.eye(4, dtype=dtype, device=device).reshape(2, 2, 2, 2)
        SS = s2.SS()
        if rotated:
            # the bipartite pattern absorbed into B = R A
            rot = s2.BP_rot()
            SS = torch.einsum("ki,kjcb,ca->ijab", rot, SS, rot)
        SSp = SS - 0.25 * id2
        ring = torch.einsum("ijab,klcd->ijklabcd", SSp, SSp)
        ring = ring + ring.permute(0, 2, 1, 3, 4, 6, 5, 7)
        nn = torch.einsum("ijab,klcd->ijklabcd", SS, id2)
        self.h2 = SS
        self.h4 = ring
        self.hp = j1 * (nn + nn.permute(0, 2, 1, 3, 4, 6, 5, 7)) - q * ring
        self.obs_ops = {"sz": s2.SZ(), "sp": s2.SP(), "sm": s2.SM()}

    def energy_1x1(self, a, env):
        rho = rdm_c4v.rdm2x2(a, env)
        return _cast_to_real(torch.einsum("ijklabcd,ijklabcd", rho, self.hp))

    @torch.no_grad()
    def eval_obs(self, a, env):
        obs = {}
        rho1 = rdm_c4v.rdm1x1(a, env)
        for label, op in self.obs_ops.items():
            obs[label] = complex(torch.trace(rho1 @ op)).real
        obs["m"] = sqrt(abs(obs["sz"] ** 2 + obs["sp"] * obs["sm"]))
        rho2 = rdm_c4v.rdm2x1(a, env)
        obs["SS2x1"] = complex(torch.einsum("ijab,ijab", rho2, self.h2)).real
        labels = ["m", "sz", "sp", "sm", "SS2x1"]
        return [obs[l] for l in labels], labels


class JQ_C4V_BIPARTITE(JQ_C4V):
    """C4v J-Q with the antiferromagnetic sublattice rotation folded into the
    Hamiltonian."""

    def __init__(self, j1=0.0, q=1.0, dtype=torch.float64, device="cuda"):
        super().__init__(j1=j1, q=q, dtype=dtype, device=device, rotated=True)


class JQ_C4V_PLAQUETTE:
    """J-Q for a plaquette-merged one-site C4v iPEPS: each tensor holds four
    spins (s0 s1 / s2 s3, phys_dim 2^4), so H splits into an on-site term h1
    (intra-plaquette bonds and ring) and a NN term h2 folding the horizontal
    and vertical inter-plaquette couplings; ``q`` weights the intra- and
    ``q_inter`` the inter-plaquette ring exchange."""

    def __init__(self, j1=0.0, q=1.0, q_inter=1.0, dtype=torch.float64, device="cuda"):
        self.dtype = dtype
        self.device = device
        self.phys_dim = 16
        self.j1 = j1
        self.q = q
        self.q_inter = q_inter
        s2 = su2.SU2(2, dtype=dtype, device=device)
        eye = torch.eye(2, dtype=dtype, device=device)
        id2 = torch.eye(4, dtype=dtype, device=device).reshape(2, 2, 2, 2)
        SS = s2.SS()
        SSp = SS - 0.25 * id2
        self.SS = SS

        E4 = lambda op, i, j: _embed(op, (i, j), 4, eye)
        # intra-plaquette: four bonds + the two ring pairings {01,23},{02,13}
        self.h1 = self.j1 * (E4(SS, 0, 1) + E4(SS, 2, 3) + E4(SS, 0, 2) + E4(SS, 1, 3)) \
            - self.q * (E4(SSp, 0, 1) @ E4(SSp, 2, 3) + E4(SSp, 0, 2) @ E4(SSp, 1, 3))
        # inter-plaquette: qubits 0..3 of i, 4..7 of its right neighbour j:
        # horizontal bonds s1_i-s0_j, s3_i-s2_j and their ring pairings; the
        # vertical term is its image under the diagonal reflection, folded
        # onto the same horizontal rdm2x1 by C4v symmetry
        E8 = lambda op, i, j: _embed(op, (i, j), 8, eye)
        h2_h = self.j1 * (E8(SS, 1, 4) + E8(SS, 3, 6)) - self.q_inter * (
            E8(SSp, 1, 4) @ E8(SSp, 3, 6) + E8(SSp, 1, 3) @ E8(SSp, 4, 6))
        h2_v = self.j1 * (E8(SS, 2, 4) + E8(SS, 3, 5)) - self.q_inter * (
            E8(SSp, 2, 4) @ E8(SSp, 3, 5) + E8(SSp, 2, 3) @ E8(SSp, 4, 5))
        self.h2 = (h2_h + h2_v).reshape(16, 16, 16, 16)
        self.obs_ops = {"sz": s2.SZ(), "sp": s2.SP(), "sm": s2.SM()}

    def energy_1x1(self, a, env):
        """e = (<h1>_rho1x1 + <h2>_rho2x1) / 4 per site of the original lattice."""
        rho1 = rdm_c4v.rdm1x1(a, env)
        rho2 = rdm_c4v.rdm2x1(a, env)
        e1 = torch.einsum("ij,ij", rho1, self.h1)
        e2 = torch.einsum("ijab,ijab", rho2, self.h2)
        return _cast_to_real(e1 + e2) / 4.0

    @torch.no_grad()
    def eval_obs(self, a, env):
        """Magnetizations of the four spins, from the plaquette rdm1x1 read as
        a 4-qubit density matrix."""
        obs = {}
        rho = rdm_c4v.rdm1x1(a, env).reshape((2,) * 8)
        for r in range(4):
            bra = [chr(ord("a") + i) for i in range(4)]
            ket = list(bra)
            bra[r], ket[r] = "x", "y"
            expr = "".join(bra) + "".join(ket) + ",xy"
            for label, op in self.obs_ops.items():
                obs[f"{label}{r}"] = complex(torch.einsum(expr, rho, op)).real
            obs[f"m{r}"] = sqrt(abs(obs[f"sz{r}"] ** 2 + obs[f"sp{r}"] * obs[f"sm{r}"]))
        labels = [f"m{r}" for r in range(4)] + [
            f"{l}{r}" for r in range(4) for l in ("sz", "sp", "sm")]
        return [obs[l] for l in labels], labels
