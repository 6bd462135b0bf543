"""K6 polar kernels (``csrc/polar.cu``) and their twins: the guarded unitary
polar factor of a small square matrix, and the vector-Jacobian product of
its closed-form derivative ``O_bar = W skew(W^H W_bar)``.

The polar factor of a single-precision overlap is computed in double
precision and rounded once (kernel and twin alike): in float32 the
eigendecomposition and the products would each round at ~k eps, amplified
by the overlap's conditioning."""

from __future__ import annotations

import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library

_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90
MAX_SWEEPS = 20  # Jacobi sweep cap; an unconverged decomposition gives I


def polar_unitary_twin(O):
    """``W = O (O^H O)^{-1/2}`` from an eigh of ``O^H O``; identity when the
    overlap is ill-conditioned (``w_min <= 1e-20 w_max``) or ``W`` is not
    finite.  The same guards as tpeps/linalg/power.py:polar_unitary."""
    if O.dtype in (torch.float32, torch.complex64):
        return polar_unitary_twin(O.to(torch.promote_types(O.dtype, torch.float64))).to(O.dtype)
    H = O.mH @ O
    w, V = torch.linalg.eigh(H)
    order = torch.argsort(-w.abs(), stable=True)
    w, V = w[order], V[:, order]
    w0 = torch.clamp(w[0], min=1e-300)
    keep = w > 1e-24 * w0
    inv_sqrt = torch.where(keep, torch.rsqrt(torch.where(keep, w, torch.ones_like(w))),
                           torch.zeros_like(w))
    W = O @ (V * inv_sqrt[None, :].to(V.dtype)) @ V.mH
    # an ill-conditioned overlap (first sweep against a cold-start basis)
    # would give a rank-deficient W; a non-finite eigh must not reach the
    # environment: a gauge rotation may degrade to identity for one move
    cond_ok = w[-1] > 1e-20 * w0
    ok = torch.isfinite(torch.view_as_real(W) if W.is_complex() else W).all()
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    return torch.where(ok & cond_ok, W, eye)


def polar_vjp_twin(W, W_bar):
    A = W.mH @ W_bar
    return W @ ((A - A.mH) * 0.5)


def _check_square(name: str, *mats):
    for M in mats:
        if M.dim() != 2 or M.shape[0] != M.shape[1] or M.shape != mats[0].shape:
            raise ValueError(f"{name}: square matrices of one shape expected, "
                             f"got {[tuple(x.shape) for x in mats]}")


def polar_unitary(O, info=None, max_sweeps: int = MAX_SWEEPS):
    """Guarded unitary polar factor ``W`` of a square ``O`` (k, k), k <= 192.
    ``W`` is the identity where the overlap is ill-conditioned, ``W`` is not
    finite, or the kernel's Jacobi branch did not converge in ``max_sweeps``
    sweeps (the twin's eigh raises where it fails).

    :param info: optional int32 tensor of 5 on the card; the kernels write
        the Jacobi sweeps, whether they converged, whether the overlap passed
        the condition guard, whether ``W`` was finite, and 1 when the
        near-orthogonal (Newton-Schulz) branch ran (diagnostics; the twin
        leaves it untouched)
    """
    _check_square("polar_unitary", O)
    if not route("polar_unitary", O):
        return polar_unitary_twin(O)
    require_contiguous("polar_unitary", O=O)
    if O.dtype == torch.float32:
        return polar_unitary(O.double(), info, max_sweeps).float()
    k = O.shape[0]
    lib = library()
    smem = lib.cdll.tpeps_polar_smem(k, O.element_size())
    if k > 192 or smem > _SMEM_LIMIT:
        raise ValueError(f"polar_unitary: k={k} does not fit the kernel (k <= 192 and "
                         f"{smem} B of shared memory <= {_SMEM_LIMIT})")
    scratch = torch.empty(4 * k * k + k, dtype=O.dtype, device=O.device)
    W = torch.empty_like(O)
    if info is None:
        info = torch.empty(5, dtype=torch.int32, device=O.device)
    with torch.cuda.device(O.device):
        err = lib.cdll.tpeps_polar_unitary_f64(
            O.data_ptr(), scratch.data_ptr(), W.data_ptr(), info.data_ptr(), k, max_sweeps,
            stream_of(O))
    lib.check(err, "polar_unitary")
    LAUNCHES["polar_unitary"] += 1
    return W


def polar_vjp(W, W_bar):
    """``O_bar = W skew(W^H W_bar)``: the VJP of the polar factor's
    closed-form derivative at the (guarded) factor ``W``."""
    _check_square("polar_vjp", W, W_bar)
    if not route("polar_vjp", W, W_bar):
        return polar_vjp_twin(W, W_bar)
    require_contiguous("polar_vjp", W=W, W_bar=W_bar)
    k = W.shape[0]
    Ob = torch.empty_like(W)
    lib = library()
    with torch.cuda.device(W.device):
        err = getattr(lib.cdll, f"tpeps_polar_vjp_{suffix(W)}")(
            W.data_ptr(), W_bar.data_ptr(), Ob.data_ptr(), k, stream_of(W))
    lib.check(err, "polar_vjp")
    LAUNCHES["polar_vjp"] += 1
    return Ob
