"""K2 corner apply (``csrc/corner_apply.cu``) and its twin: ``Y = M2 @ P``
for the enlarged corner as the matrix ``M2[(j,e,f),(i,r,g)]``.  float64 on
the FP64 tensor cores (DMMA); float32 as three TF32 products on the tensor
cores (each operand split into a TF32 hi and lo part, ``A_hi B_hi + A_hi
B_lo + A_lo B_hi``), float32's accuracy whatever PyTorch's TF32 settings
say."""

from __future__ import annotations

import torch

from . import LAUNCHES, arrival_counters, require_contiguous, route, stream_of, suffix
from .build import library


def corner_apply_twin(M2, P):
    return M2 @ P


def corner_apply(M2, P):
    """``Y = M2 @ P`` with ``M2`` (n, n), row-major with any row pitch, and
    ``P`` (n, m) contiguous."""
    if M2.dim() != 2 or P.dim() != 2 or M2.shape[0] != M2.shape[1] or M2.shape[1] != P.shape[0]:
        raise ValueError(f"corner_apply: shapes {tuple(M2.shape)} @ {tuple(P.shape)}")
    if not route("corner_apply", M2, P):
        return corner_apply_twin(M2, P)
    n, m = P.shape
    if n > 1 and (M2.stride(1) != 1 or M2.stride(0) < n):
        raise ValueError(f"corner_apply: M2 must be row-major, got strides {M2.stride()}")
    require_contiguous("corner_apply", P=P)
    Y = torch.empty((n, m), dtype=P.dtype, device=P.device)
    lib, sfx = library(), suffix(P)
    with torch.cuda.device(P.device):
        scratch = getattr(lib.cdll, f"tpeps_corner_apply_scratch_{sfx}")(n, m)
        lib.check(int(-min(scratch, 0)), "corner_apply")
        part = torch.empty(max(scratch, 1), dtype=P.dtype, device=P.device)
        counters = arrival_counters(P.device)
        err = getattr(lib.cdll, f"tpeps_corner_apply_{sfx}")(
            M2.data_ptr(), M2.stride(0), P.data_ptr(), Y.data_ptr(), part.data_ptr(),
            part.numel(), counters.data_ptr(), counters.numel(), n, m, stream_of(P))
    lib.check(err, "corner_apply")
    LAUNCHES["corner_apply"] += 1
    return Y
