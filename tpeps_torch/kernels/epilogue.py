"""K4 edge epilogue (``csrc/t_epilogue.cu``) and its twin: hermitian
symmetrisation of ``T'`` over its two trailing (chi) axes, then division by
``max|T'|`` (``"inf"``) or by its 2-norm (any other value)."""

from __future__ import annotations

import torch

from . import LAUNCHES, barrier_counters, require_contiguous, route, stream_of, suffix
from .build import library


def t_epilogue_twin(nT, normalization: str = "inf"):
    nT = 0.5 * (nT + nT.transpose(-2, -1).conj())
    if normalization == "inf":
        scale = nT.abs().max()
    else:
        scale = torch.linalg.vector_norm(nT)
    return nT / scale


def t_epilogue(nT, normalization: str = "inf"):
    """Symmetrised and normalised copy of ``nT`` (..., m, m)."""
    if nT.dim() < 2 or nT.shape[-1] != nT.shape[-2]:
        raise ValueError(f"t_epilogue: trailing axes must be square, got {tuple(nT.shape)}")
    if not route("t_epilogue", nT):
        return t_epilogue_twin(nT, normalization)
    require_contiguous("t_epilogue", nT=nT)
    m = nT.shape[-1]
    batch = nT.numel() // (m * m) if m else 0
    lib = library()
    part = torch.empty(lib.cdll.tpeps_t_epilogue_partials(), dtype=nT.dtype, device=nT.device)
    bar = barrier_counters(nT.device, "t_epilogue")
    out = torch.empty_like(nT)
    mode = 0 if normalization == "inf" else 1
    with torch.cuda.device(nT.device):
        err = getattr(lib.cdll, f"tpeps_t_epilogue_{suffix(nT)}")(
            nT.data_ptr(), out.data_ptr(), part.data_ptr(), bar.data_ptr(), batch, m, mode,
            stream_of(nT))
    lib.check(err, "t_epilogue")
    LAUNCHES["t_epilogue"] += 1
    return out
