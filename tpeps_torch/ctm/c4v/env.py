"""C4v-symmetric CTM environment (counterpart of tpeps/ctm/c4v/env.py).

A single corner ``C`` (chi x chi) and a single half-row/-column tensor
``T`` (chi x chi x D^2) describe the whole infinite environment::

    C--1 0--T--1 0--C
    |       |       |
    0       2       1

Both are hermitian under exchange of their environment indices.  The fused
``D^2`` index orders (ket, bra) with ket major.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...linalg.eigh import eigh_desc


class EnvC4v(NamedTuple):
    """C4v CTM environment: corner ``C[chi,chi]`` + edge ``T[chi,chi,D^2]``."""

    C: torch.Tensor
    T: torch.Tensor

    @property
    def chi(self) -> int:
        return self.C.shape[0]


def init_env(a, chi: int, init_type: str = "CTMRG", generator=None, dtype=None) -> EnvC4v:
    """Initialize the environment from the on-site tensor ``a[s,u,l,d,r]``
    on ``a``'s device.

    * "PROD"   — single-element C, leading-transfer-eigenvector T
    * "RANDOM" — random hermitian C, random T (needs a ``torch.Generator``)
    * "CTMRG"  — built from the on-site tensor with PBC trace
    """
    dtype = dtype or a.dtype
    if init_type == "PROD":
        return init_prod(a, chi, dtype)
    if init_type == "RANDOM":
        if generator is None:
            raise ValueError("RANDOM init requires a torch.Generator")
        return init_random(generator, chi, a.shape[1] ** 2, dtype, a.device)
    if init_type == "CTMRG":
        return init_from_ipeps_pbc(a, chi, dtype)
    raise ValueError(f"Invalid environment initialization: {init_type}")


def init_prod(a, chi: int, dtype) -> EnvC4v:
    """Product-state environment."""
    D2 = a.shape[1] ** 2
    C = torch.zeros((chi, chi), dtype=dtype, device=a.device)
    C[0, 0] = 1.0
    t = torch.einsum("meifj,maibj->eafb", a, a.conj()).reshape(D2, D2)
    t = t / t.abs().max()
    _, U = eigh_desc(t)
    T = torch.zeros((chi, chi, D2), dtype=dtype, device=a.device)
    T[0, 0, :] = U[:, 0]
    return EnvC4v(C, T)


def init_random(generator, chi: int, D2: int, dtype, device="cuda") -> EnvC4v:
    """Random hermitian environment, uniform in [0, 1) per real component,
    drawn from ``generator`` (which must live on ``device``)."""
    real = torch.empty((), dtype=dtype).real.dtype
    if dtype.is_complex:
        tmpC = torch.rand((chi, chi, 2), generator=generator, dtype=real, device=device)
        tmpC = torch.complex(tmpC[..., 0], tmpC[..., 1]).to(dtype)
        T = torch.rand((chi, chi, D2, 2), generator=generator, dtype=real, device=device)
        T = torch.complex(T[..., 0], T[..., 1]).to(dtype)
    else:
        tmpC = torch.rand((chi, chi), generator=generator, dtype=dtype, device=device)
        T = torch.rand((chi, chi, D2), generator=generator, dtype=dtype, device=device)
    C = 0.5 * (tmpC + tmpC.mH)
    return EnvC4v(C, T)


def init_from_ipeps_pbc(a, chi: int, dtype) -> EnvC4v:
    """Environment from the on-site tensor with PBC trace: C = eigenvalues
    of the corner double-layer matrix, T = the transfer tensor rotated into
    the corner eigenbasis, both zero-padded to chi."""
    D = a.shape[1]
    D2 = D * D
    c = torch.einsum("mijef,mijab->eafb", a, a.conj()).reshape(D2, D2)
    c = c / c.abs().max()
    Dspec, U = eigh_desc(c)
    n = min(chi, D2)
    C = torch.zeros((chi, chi), dtype=dtype, device=a.device)
    C[:n, :n] = torch.diag(Dspec[:n]).to(dtype)
    t = torch.einsum("meifg,maibc->eafbgc", a, a.conj()).reshape(D2, D2, D2)
    t = t / t.abs().max()
    t = torch.einsum("ai,abs,bj->ijs", U, t, U.conj())
    T = torch.zeros((chi, chi, D2), dtype=dtype, device=a.device)
    T[:n, :n, :] = t[:n, :n, :].to(dtype)
    return EnvC4v(C, T)


def compute_multiplets(C, eps_multiplet_gap: float = 1.0e-10):
    """Degeneracy structure of the corner spectrum, on the host: the
    descending |eigenvalues| of ``C`` and the sizes of its multiplets
    (levels closer than ``eps_multiplet_gap`` share one)."""
    D = torch.linalg.eigvalsh(C).abs().sort(descending=True).values.cpu()
    D = torch.cat([D, torch.zeros(1, dtype=D.dtype)])
    m = []
    l = 0
    for i in range(C.shape[0]):
        l += 1
        if float(D[i] - D[i + 1]) > eps_multiplet_gap:
            m.append(l)
            l = 0
    return D[:-1], m


def env_c4v_to_generic(a, env: EnvC4v):
    """Expand the single (C, T) pair into the per-site/per-direction generic
    environment dictionaries of a 1x1 cell: all four corners equal C, each
    T oriented by the generic index conventions.

    :return: ``(sites, vertexToSite, C_dict, T_dict)``
    """
    c = (0, 0)
    C_dict = {(c, v): env.C for v in ((-1, -1), (1, -1), (1, 1), (-1, 1))}
    T_dict = {
        (c, (0, -1)): env.T.permute(0, 2, 1),
        (c, (-1, 0)): env.T,
        (c, (0, 1)): env.T.permute(2, 0, 1),
        (c, (1, 0)): env.T.permute(0, 2, 1),
    }
    return {c: a}, (lambda coord: c), C_dict, T_dict
