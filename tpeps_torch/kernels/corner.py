"""K2 corner apply (``csrc/corner_apply.cu``) and its twin: ``Y = M2 @ P``
for the enlarged corner as the matrix ``M2[(j,e,f),(i,r,g)]``."""

from __future__ import annotations

import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library


def corner_apply_twin(M2, P):
    return M2 @ P


def corner_apply(M2, P):
    """``Y = M2 @ P`` with ``M2`` (n, n) and ``P`` (n, m)."""
    if M2.dim() != 2 or P.dim() != 2 or M2.shape[0] != M2.shape[1] or M2.shape[1] != P.shape[0]:
        raise ValueError(f"corner_apply: shapes {tuple(M2.shape)} @ {tuple(P.shape)}")
    if not route("corner_apply", M2, P):
        return corner_apply_twin(M2, P)
    require_contiguous("corner_apply", M2=M2, P=P)
    n, m = P.shape
    Y = torch.empty((n, m), dtype=P.dtype, device=P.device)
    lib = library()
    with torch.cuda.device(P.device):
        err = getattr(lib.cdll, f"tpeps_corner_apply_{suffix(P)}")(
            M2.data_ptr(), P.data_ptr(), Y.data_ptr(), n, m, stream_of(P))
    lib.check(err, "corner_apply")
    LAUNCHES["corner_apply"] += 1
    return Y
