"""K3 CholeskyQR kernels (``csrc/cholqr.cu``) and their twins: the Gram
matrix with its ridge, the two-operand Gram ``A^H B``, the right triangular
solve ``Q L^H = P`` and its backward counterpart ``X L = B``."""

from __future__ import annotations

import torch

from . import LAUNCHES, arrival_counters, require_contiguous, route, stream_of, suffix
from .build import library

TRSM_MAX_K = 256  # the solves' widest L (csrc/cholqr.cu: a 64-row tile and two panels fit)


def gram_ridge_twin(P, eps: float = 0.0):
    k = P.shape[1]
    G = P.mH @ P
    if eps:
        G = G + eps * torch.trace(G).real / k * torch.eye(k, dtype=G.dtype, device=G.device)
    return G


def gram_twin(A, B):
    return A.mH @ B


def _launch_gram(name: str, A, B, eps: float, sym: bool):
    """One launch of the Gram kernel; its launcher plans the grid, and says
    how much scratch the plan needs on this card."""
    n, ka = A.shape
    kb = B.shape[1]
    lib = library()
    sfx = suffix(A)
    counters = arrival_counters(A.device)
    with torch.cuda.device(A.device):
        scratch = getattr(lib.cdll, f"tpeps_gram_scratch_{sfx}")(n, ka, kb, int(sym))
        lib.check(int(-min(scratch, 0)), name)
        part = torch.empty(max(scratch, 1), dtype=A.dtype, device=A.device)
        G = torch.empty((ka, kb), dtype=A.dtype, device=A.device)
        err = getattr(lib.cdll, f"tpeps_gram_clusters_{sfx}")(
            A.data_ptr(), B.data_ptr(), part.data_ptr(), counters.data_ptr(), counters.numel(),
            G.data_ptr(), n, ka, kb, float(eps), int(sym), stream_of(A))
    lib.check(err, name)
    LAUNCHES[name] += 1
    return G


def gram_ridge(P, eps: float = 0.0):
    """``G = P^H P + eps * tr(P^H P) / k * I`` for a tall ``P`` (n, k)."""
    if P.dim() != 2:
        raise ValueError(f"gram_ridge: P must be 2-D, got {tuple(P.shape)}")
    if not route("gram_ridge", P):
        return gram_ridge_twin(P, eps)
    require_contiguous("gram_ridge", P=P)
    return _launch_gram("gram_ridge", P, P, eps, True)


def gram(A, B):
    """``G = A^H B`` for tall ``A`` (n, ka) and ``B`` (n, kb)."""
    if A.dim() != 2 or B.dim() != 2 or A.shape[0] != B.shape[0]:
        raise ValueError(f"gram: shapes A {tuple(A.shape)}, B {tuple(B.shape)}")
    if not route("gram", A, B):
        return gram_twin(A, B)
    require_contiguous("gram", A=A, B=B)
    return _launch_gram("gram", A, B, 0.0, False)


def trsm_right_lower_h_twin(L, P):
    return torch.linalg.solve_triangular(L.mH, P, upper=True, left=False)


def trsm_right_lower_twin(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False, left=False)


def _launch_trsm(name: str, fn: str, L, P):
    if L.dim() != 2 or P.dim() != 2 or L.shape != (P.shape[1], P.shape[1]):
        raise ValueError(f"{name}: shapes L {tuple(L.shape)}, rhs {tuple(P.shape)}")
    require_contiguous(name, L=L, rhs=P)
    n, k = P.shape
    if k > TRSM_MAX_K:
        raise ValueError(f"{name}: k={k} does not fit the kernel (k <= {TRSM_MAX_K})")
    X = torch.empty_like(P)
    lib = library()
    with torch.cuda.device(P.device):
        err = getattr(lib.cdll, f"{fn}_{suffix(P)}")(
            L.data_ptr(), P.data_ptr(), X.data_ptr(), n, k, stream_of(P))
    lib.check(err, name)
    LAUNCHES[name] += 1
    return X


def trsm_right_lower_h(L, P):
    """``Q`` with ``Q L^H = P`` for lower-triangular ``L`` (k, k) and ``P`` (n, k)."""
    if not route("trsm_right_lower_h", L, P):
        return trsm_right_lower_h_twin(L, P)
    return _launch_trsm("trsm_right_lower_h", "tpeps_trsm_right_lower_h", L, P)


def trsm_right_lower(L, B):
    """``X`` with ``X L = B`` for lower-triangular ``L`` (k, k) and ``B`` (n, k):
    the backward of :func:`trsm_right_lower_h` (``P_bar = Q_bar L^-1``)."""
    if not route("trsm_right_lower", L, B):
        return trsm_right_lower_twin(L, B)
    return _launch_trsm("trsm_right_lower", "tpeps_trsm_right_lower", L, B)
