"""K6 polar kernels (``csrc/polar.cu``) and their twins: the guarded unitary
polar factor of a small square matrix, and the vector-Jacobian product of
its closed-form derivative ``O_bar = W skew(W^H W_bar)``.

The polar factor of a single-precision overlap is computed in double
precision and rounded once (kernel and twin alike): in float32 every
product of the iteration (or of the twin's eigendecomposition) would round
at ~k eps, amplified by the overlap's conditioning."""

from __future__ import annotations

import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library

# the Newton-Schulz step cap: an overlap with sigma_min = 1e-10 sigma_max (the
# JAX guard's w_min = 1e-20 w_max) converges within 66 steps, one with the
# ridge of procrustes_align's singular case (1e-12 sigma_max) needs 74 or more;
# a run that does not converge within the cap gives I
MAX_STEPS = 70
_STATS: dict = {}


def polar_stats(device) -> torch.Tensor:
    """The card's histogram of the kernel's calls, accumulated on the card
    since the tensor was made or zeroed (``polar_stats(dev).zero_()``): entry
    ``s`` counts the calls that converged after ``s`` Newton-Schulz steps,
    the last entry those that did not (and gave I).  Read it once after a
    run, not per move: a read stalls the stream."""
    device = torch.device(device)
    s = _STATS.get(device)
    if s is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("polar_stats: call polar_unitary once on this device before "
                               "capturing a graph")
        # a normal tensor even when the first call runs under inference_mode,
        # so that it can be zeroed outside it
        with torch.inference_mode(False):
            s = _STATS[device] = torch.zeros(library().cdll.tpeps_polar_stats_len(),
                                             dtype=torch.int32, device=device)
    return s


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


def _check_k(name: str, k: int, lib) -> None:
    max_k = lib.cdll.tpeps_polar_max_k()
    if k > max_k:
        raise ValueError(f"{name}: k={k} > {max_k}, the kernel's limit (one cluster of at "
                         f"most {max_k // 16} blocks of 16 columns)")


def polar_unitary(O, info=None, max_steps: int = MAX_STEPS):
    """Guarded unitary polar factor ``W`` of a square ``O`` (k, k), k <= 192
    on the card.  ``W`` is the identity where the kernel's Newton-Schulz
    iteration did not converge within ``max_steps`` steps (an overlap more
    ill-conditioned than the twin's guard, ``sigma_min <= 1e-10
    sigma_max``, or near it) or met a non-finite value, or where ``W`` is
    not finite (the twin's eigh raises where it fails).

    :param info: optional int32 tensor of 5 on the card; the kernel writes
        the steps run, whether they converged, whether ``W`` was kept (not
        replaced by I), whether ``W`` was finite, and 1 when ``||O^T O -
        I||_F < 0.9`` (a near-orthogonal overlap); diagnostics, the twin
        leaves it untouched.  Every call also adds to :func:`polar_stats`.
    """
    _check_square("polar_unitary", O)
    if not route("polar_unitary", O):
        return polar_unitary_twin(O)
    require_contiguous("polar_unitary", O=O)
    if O.dtype == torch.float32:
        return polar_unitary(O.double(), info, max_steps).float()
    k = O.shape[0]
    lib = library()
    _check_k("polar_unitary", k, lib)
    if not 1 <= max_steps <= lib.cdll.tpeps_polar_max_steps():
        raise ValueError(f"polar_unitary: max_steps={max_steps} outside [1, "
                         f"{lib.cdll.tpeps_polar_max_steps()}]")
    W = torch.empty_like(O)
    stats = polar_stats(O.device)
    with torch.cuda.device(O.device):
        err = lib.cdll.tpeps_polar_unitary_f64(
            O.data_ptr(), W.data_ptr(), None if info is None else info.data_ptr(),
            stats.data_ptr(), k, max_steps, stream_of(O))
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
    lib = library()
    _check_k("polar_vjp", k, lib)
    Ob = torch.empty_like(W)
    with torch.cuda.device(W.device):
        err = getattr(lib.cdll, f"tpeps_polar_vjp_{suffix(W)}")(
            W.data_ptr(), W_bar.data_ptr(), Ob.data_ptr(), k, stream_of(W))
    lib.check(err, "polar_vjp")
    LAUNCHES["polar_vjp"] += 1
    return Ob
