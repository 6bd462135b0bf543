"""K5 loop control (``csrc/ctm_commit.cu``) and its twin: the convergence
test and commit of ``run_fixed_point_tpu``'s ``while_loop`` after one move,
on the card (tpeps/ctm/c4v/move_tpu.py:288-303).

The loop state is a :class:`LoopState` of tensors on one device: the
committed ``C``, ``T`` (internal layout), ``P``, the Procrustes rotation
``W`` of the last committed move (the identity before the first),
``|spec|`` of the last committed move, ``dist`` (1 element), the loop's
``conv_tol`` (1 element, float64) and ``ctl`` (int32: the iteration count
``i``, the ``done`` flag, a counter the kernel uses and resets, and
``max_iter``).  The loop's limits live on the card with the rest, so a CUDA
graph of moves serves any limits: they are loaded, not captured.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library

CONV_ON = ("spec", "env")


class LoopState(NamedTuple):
    C: torch.Tensor
    T: torch.Tensor
    P: torch.Tensor
    W: torch.Tensor
    spec: torch.Tensor
    dist: torch.Tensor
    conv_tol: torch.Tensor
    ctl: torch.Tensor


def _ctl(max_iter: int) -> torch.Tensor:
    n = min(max(int(max_iter), 0), 2**31 - 1)  # int32 on the card
    return torch.tensor([0, int(n == 0), 0, n], dtype=torch.int32)


def loop_state(C, T_int, P, max_iter: int, conv_tol: float) -> LoopState:
    """A fresh state as the ``while_loop``'s first carry: copies of ``C``,
    ``T_int``, ``P``, ``W = I``, ``|spec_prev| = inf``, ``dist = inf``,
    ``i = 0``, the limits, and ``done`` when ``max_iter <= 0``."""
    rdtype = C.real.dtype
    chi = C.shape[0]
    W = torch.eye(chi, dtype=C.dtype, device=C.device)
    spec = torch.full((chi,), math.inf, dtype=rdtype, device=C.device)
    dist = torch.full((1,), math.inf, dtype=rdtype, device=C.device)
    tol = torch.full((1,), conv_tol, dtype=torch.float64, device=C.device)
    return LoopState(C.clone(), T_int.clone(), P.clone().contiguous(), W, spec, dist, tol,
                     _ctl(max_iter).to(C.device))


def reset(state: LoopState, C, T_int, P, max_iter: int, conv_tol: float, W=None) -> None:
    """Load a start and the loop's limits into an existing state in place
    (static graph buffers); ``W`` defaults to the identity."""
    state.C.copy_(C)
    state.T.copy_(T_int)
    state.P.copy_(P)
    state.W.copy_(torch.eye(state.W.shape[0], dtype=state.W.dtype) if W is None else W)
    state.spec.fill_(math.inf)
    state.dist.fill_(math.inf)
    state.conv_tol.fill_(conv_tol)
    state.ctl.copy_(_ctl(max_iter))


def ctm_commit_twin(state: LoopState, C2, T2, P2, W2, spec2, conv_on: str = "spec") -> None:
    """The same step in torch ops (no host read), in place on ``state``."""
    C, T, P, W, spec, dist, conv_tol, ctl = state
    go = ctl[1] == 0
    if conv_on == "env":
        d = torch.maximum((C2 - C).abs().max(), (T2 - T).abs().max())
    else:
        d = torch.linalg.vector_norm(spec2.abs() - spec)
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))
    C.copy_(torch.where(go, C2, C))
    T.copy_(torch.where(go, T2, T))
    P.copy_(torch.where(go, P2, P))
    W.copy_(torch.where(go, W2, W))
    spec.copy_(torch.where(go, spec2.abs(), spec))
    dist.copy_(torch.where(go, d, dist))
    it = ctl[0] + go.to(torch.int32)
    done = torch.where(go, ~((it < ctl[3]) & (d.double() > conv_tol[0])), ~go)
    ctl[0] = it
    ctl[1] = done.to(torch.int32)


def ctm_commit(state: LoopState, C2, T2, P2, W2, spec2, *, conv_on: str = "spec") -> None:
    """One step of the on-card loop after a move with outputs ``(C2, T2, spec2,
    P2, W2)``: ``dist`` as ``run_fixed_point_tpu``'s body forms it (a non-finite
    one becomes inf); the move is committed to ``state`` only while the loop
    has not ended, and ``done = not (i < max_iter and dist > conv_tol)`` with
    the limits held in ``state``."""
    if conv_on not in CONV_ON:
        raise ValueError(f"ctm_commit: conv_on={conv_on!r} must be one of {CONV_ON}")
    for name, new, old in (("C", C2, state.C), ("T", T2, state.T), ("P", P2, state.P),
                           ("W", W2, state.W), ("spec", spec2, state.spec)):
        if new.shape != old.shape:
            raise ValueError(f"ctm_commit: {name} shape {tuple(new.shape)} != {tuple(old.shape)}")
    if not route("ctm_commit", state.C, state.T, state.P, state.W, state.spec, state.dist, C2,
                 T2, P2, W2, spec2):
        return ctm_commit_twin(state, C2, T2, P2, W2, spec2, conv_on)
    if state.ctl.device != state.C.device or state.ctl.dtype != torch.int32:
        raise ValueError("ctm_commit: ctl must be int32 on the state's device")
    if state.conv_tol.device != state.C.device or state.conv_tol.dtype != torch.float64:
        raise ValueError("ctm_commit: conv_tol must be float64 on the state's device")
    require_contiguous("ctm_commit", C=state.C, T=state.T, P=state.P, W=state.W,
                       spec=state.spec, C2=C2, T2=T2, P2=P2, W2=W2, spec2=spec2)
    lib = library()
    part = torch.empty(lib.cdll.tpeps_ctm_commit_partials(), dtype=C2.dtype, device=C2.device)
    with torch.cuda.device(C2.device):
        err = getattr(lib.cdll, f"tpeps_ctm_commit_{suffix(C2)}")(
            state.C.data_ptr(), state.T.data_ptr(), state.P.data_ptr(), state.W.data_ptr(),
            state.spec.data_ptr(), state.dist.data_ptr(), state.conv_tol.data_ptr(),
            state.ctl.data_ptr(), part.data_ptr(), C2.data_ptr(), T2.data_ptr(), P2.data_ptr(),
            W2.data_ptr(), spec2.data_ptr(), C2.numel(), T2.numel(), P2.numel(), W2.numel(),
            spec2.numel(), int(conv_on == "env"), stream_of(C2))
    lib.check(err, "ctm_commit")
    LAUNCHES["ctm_commit"] += 1
