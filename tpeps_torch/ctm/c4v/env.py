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
