"""Point-group symmetrization of on-site tensors ``a[s, u, l, d, r]``
(counterpart of tpeps/groups/pg.py)."""

from __future__ import annotations

import torch


def make_c4v_symm_A1(A):
    """Projection on the A1 irrep of C4v."""
    A = 0.5 * (A + A.permute(0, 1, 4, 3, 2))  # left-right reflection
    A = 0.5 * (A + A.permute(0, 3, 2, 1, 4))  # up-down reflection
    A = 0.5 * (A + A.permute(0, 4, 1, 2, 3))  # pi/2 anti-clockwise
    A = 0.5 * (A + A.permute(0, 2, 3, 4, 1))  # pi/2 clockwise
    return A


def make_c4v_symm_A2(A):
    """Projection on the A2 irrep."""
    A = 0.5 * (A - A.permute(0, 1, 4, 3, 2))  # sigma
    A = 0.5 * (A - A.permute(0, 4, 3, 2, 1))  # sigma R^-1
    A = 0.5 * (A + A.permute(0, 4, 1, 2, 3))  # R
    A = 0.5 * (A + A.permute(0, 3, 4, 1, 2))  # R^2
    return A


def make_c4v_symm_B1(A):
    """Projection on the B1 irrep."""
    A = 0.5 * (A + A.permute(0, 1, 4, 3, 2))
    A = 0.5 * (A - A.permute(0, 4, 3, 2, 1))
    A = 0.5 * (A - A.permute(0, 4, 1, 2, 3))
    A = 0.5 * (A + A.permute(0, 3, 4, 1, 2))
    return A


def make_c4v_symm_B2(A):
    """Projection on the B2 irrep."""
    A = 0.5 * (A - A.permute(0, 1, 4, 3, 2))
    A = 0.5 * (A + A.permute(0, 4, 3, 2, 1))
    A = 0.5 * (A + A.permute(0, 4, 1, 2, 3))
    A = 0.5 * (A - A.permute(0, 3, 4, 1, 2))
    return A


_PROJECTIONS = {
    "A1": make_c4v_symm_A1,
    "A2": make_c4v_symm_A2,
    "B1": make_c4v_symm_B1,
    "B2": make_c4v_symm_B2,
}


def make_c4v_symm(A, irreps=("A1",)):
    """Sum of projections on the chosen C4v irreps."""
    irreps = set(irreps)
    if not irreps.issubset(_PROJECTIONS):
        raise ValueError(f"unknown C4v irrep in {sorted(irreps)}")
    out = torch.zeros_like(A)
    for irrep in irreps:
        out = out + _PROJECTIONS[irrep](A)
    return out
