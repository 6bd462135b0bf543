"""One-site C4v-symmetric iPEPS (counterpart of tpeps/ipeps/ipeps_c4v.py)."""

from __future__ import annotations

import torch

from ..groups.pg import make_c4v_symm, make_c4v_symm_A1
from . import ipeps as ipeps_mod


class IPEPS_C4V(ipeps_mod.IPEPS):
    """Single-site ansatz; the lattice is tiled by one tensor."""

    def __init__(self, site=None):
        sites = {(0, 0): site} if site is not None else {}
        super().__init__(sites, lX=1, lY=1)

    def site(self, coord=None):
        return self.sites[(0, 0)]

    def write_to_file(self, outputfile, symmetrize=True, **kwargs):
        tmp = IPEPS_C4V(symmetrize_c4v(self.site())) if symmetrize else self
        ipeps_mod.write_ipeps(tmp, outputfile, **kwargs)

    def get_aux_bond_dims(self):
        return list(self.site().shape[1:])

    def add_noise(self, noise: float, generator=None):
        """Add uniform noise in [0, noise) to the site, drawn from
        ``generator`` (a ``torch.Generator`` on the site's device)."""
        if noise == 0:
            return self
        A = self.site()
        r = torch.rand(torch.view_as_real(A).shape if A.is_complex() else A.shape,
                       generator=generator, dtype=A.real.dtype, device=A.device)
        self.sites[(0, 0)] = A + noise * (torch.view_as_complex(r) if A.is_complex() else r)
        return self


def extend_bond_dim_c4v(state: IPEPS_C4V, new_d: int) -> IPEPS_C4V:
    """Zero-pad the auxiliary dimensions of the site up to ``new_d``."""
    A = state.site()
    if any(new_d < d for d in A.shape[1:]):
        raise ValueError("new bond dimension smaller than existing")
    pad = []
    for d in reversed(A.shape[1:]):
        pad += [0, new_d - d]
    return IPEPS_C4V(torch.nn.functional.pad(A, pad))


def symmetrize_c4v(A, normalize: bool = False):
    """Project an on-site tensor to A1 (real) or A1 + iA2 (complex) and
    optionally normalize."""
    if A.is_complex():
        A = make_c4v_symm(A.real) + 1.0j * make_c4v_symm(A.imag, irreps=["A2"])
    else:
        A = make_c4v_symm_A1(A)
    if normalize:
        A = A / torch.linalg.vector_norm(A)
    return A


def read_ipeps_c4v(jsonfile, aux_seq=(0, 1, 2, 3), dtype=None, device="cuda") -> IPEPS_C4V:
    """Read a single-site state."""
    state = ipeps_mod.read_ipeps(jsonfile, aux_seq=aux_seq, dtype=dtype, device=device)
    if len(state.sites) != 1:
        raise ValueError("state has more than a single on-site tensor")
    return IPEPS_C4V(next(iter(state.sites.values())))
