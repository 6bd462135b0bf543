"""K3 CholeskyQR kernels (``csrc/cholqr.cu``) and their twins: the Gram
matrix with its ridge, and the right triangular solve ``Q L^H = P``."""

from __future__ import annotations

import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library


def gram_ridge_twin(P, eps: float = 0.0):
    k = P.shape[1]
    G = P.mH @ P
    if eps:
        G = G + eps * torch.trace(G).real / k * torch.eye(k, dtype=G.dtype, device=G.device)
    return G


def gram_ridge(P, eps: float = 0.0):
    """``G = P^H P + eps * tr(P^H P) / k * I`` for a tall ``P`` (n, k)."""
    if P.dim() != 2:
        raise ValueError(f"gram_ridge: P must be 2-D, got {tuple(P.shape)}")
    if not route("gram_ridge", P):
        return gram_ridge_twin(P, eps)
    require_contiguous("gram_ridge", P=P)
    n, k = P.shape
    lib = library()
    splits = lib.cdll.tpeps_gram_splits(n)
    part = torch.empty((splits, k, k), dtype=P.dtype, device=P.device)
    G = torch.empty((k, k), dtype=P.dtype, device=P.device)
    with torch.cuda.device(P.device):
        err = getattr(lib.cdll, f"tpeps_gram_ridge_{suffix(P)}")(
            P.data_ptr(), part.data_ptr(), G.data_ptr(), n, k, float(eps), stream_of(P))
    lib.check(err, "gram_ridge")
    LAUNCHES["gram_ridge"] += 1
    return G


def trsm_right_lower_h_twin(L, P):
    return torch.linalg.solve_triangular(L.mH, P, upper=True, left=False)


def trsm_right_lower_h(L, P):
    """``Q`` with ``Q L^H = P`` for lower-triangular ``L`` (k, k) and ``P`` (n, k)."""
    if L.dim() != 2 or P.dim() != 2 or L.shape != (P.shape[1], P.shape[1]):
        raise ValueError(f"trsm_right_lower_h: shapes L {tuple(L.shape)}, P {tuple(P.shape)}")
    if not route("trsm_right_lower_h", L, P):
        return trsm_right_lower_h_twin(L, P)
    require_contiguous("trsm_right_lower_h", L=L, P=P)
    n, k = P.shape
    smem = (k * (k + 1) // 2 + k) * P.element_size()
    if k > 256 or smem > 232448:
        raise ValueError(f"trsm_right_lower_h: k={k} does not fit the kernel "
                         f"(k <= 256 and {smem} B of shared memory <= 232448)")
    Q = torch.empty_like(P)
    lib = library()
    with torch.cuda.device(P.device):
        err = getattr(lib.cdll, f"tpeps_trsm_right_lower_h_{suffix(P)}")(
            L.data_ptr(), P.data_ptr(), Q.data_ptr(), n, k, stream_of(P))
    lib.check(err, "trsm_right_lower_h")
    LAUNCHES["trsm_right_lower_h"] += 1
    return Q
