"""The on-card symmetric eigendecomposition (``csrc/eigh_small.cu``) and its
twin: the Rayleigh-Ritz eigh of the factored move, which must not read to
the host (cuSOLVER's eigh does, and does not capture into a CUDA graph)."""

from __future__ import annotations

import torch

from . import LAUNCHES, require_contiguous, route, stream_of
from .build import library

MAX_SWEEPS = 30  # block Jacobi sweep cap; an unconverged decomposition gives NaN
# the largest k routed here (the kernel keeps V^T in one block's shared
# memory, k <= 170): the factored move's largest chi on the card (its polar
# kernel, K6, takes k <= 192)
EIGH_SMALL_MAX = 169


def eigh_small_twin(H):
    """``torch.linalg.eigh``; a float32 matrix is decomposed in float64 and
    rounded once, as the kernel does."""
    if H.dtype == torch.float32:
        w, V = torch.linalg.eigh(H.double())
        return w.float(), V.float()
    return torch.linalg.eigh(H)


def eigh_small(H, info=None):
    """Eigendecomposition ``H = V diag(w) V^T`` of a real symmetric ``H`` (k, k),
    k <= ``EIGH_SMALL_MAX``, with nothing read to the host.  The kernel's eigenvalues are in
    no particular order (the twin's ascend); where its Jacobi sweeps did not
    converge in ``MAX_SWEEPS`` sweeps, ``w`` and ``V`` are NaN.

    :param info: optional int32 tensor of 2 on the card; the kernel writes the
        sweeps it ran and whether they converged (diagnostics)
    :return: ``(w, V)``, the eigenvectors in the columns of ``V``
    """
    if H.dim() != 2 or H.shape[0] != H.shape[1]:
        raise ValueError(f"eigh_small: a square matrix expected, got {tuple(H.shape)}")
    if not route("eigh_small", H):
        return eigh_small_twin(H)
    require_contiguous("eigh_small", H=H)
    if H.dtype == torch.float32:
        w, V = eigh_small(H.double(), info)
        return w.float(), V.float()
    k = H.shape[0]
    if k > EIGH_SMALL_MAX:
        raise ValueError(f"eigh_small: k={k} does not fit the kernel (k <= {EIGH_SMALL_MAX})")
    lib = library()
    w = torch.empty(k, dtype=H.dtype, device=H.device)
    Vt = torch.empty_like(H)
    if info is None:
        info = torch.empty(2, dtype=torch.int32, device=H.device)
    with torch.cuda.device(H.device):
        err = lib.cdll.tpeps_eigh_small_f64(H.data_ptr(), w.data_ptr(), Vt.data_ptr(),
                                            info.data_ptr(), k, MAX_SWEEPS, stream_of(H))
    lib.check(err, "eigh_small")
    LAUNCHES["eigh_small"] += 1
    return w, Vt.mT
