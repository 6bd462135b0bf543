"""K9 epilogue (``csrc/frozen_commit.cu``) and its twin: the end of a frozen
C4v abelian move and one step of ``run_frozen``'s ``while_loop``
(tpeps/ctm/c4v_abelian/frozen.py:73-77, 141-149), on the card.

The loop state is a :class:`FrozenState` of tensors on one device: the
committed ``C`` and ``T`` as flat buffers in their frozen block layouts,
``dist2`` (1 element), ``conv_tol`` (1 element, float64) and ``ctl`` (int32:
the move count ``i``, the ``done`` flag, a counter the kernel uses and
resets, and ``max_iter``).  A move's raw outputs come in the same layouts,
with per element the flat index of its transpose partner (-1: none).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import LAUNCHES, require_contiguous, route, stream_of, suffix
from .build import library


class FrozenState(NamedTuple):
    C: torch.Tensor
    T: torch.Tensor
    dist2: torch.Tensor
    conv_tol: torch.Tensor
    ctl: torch.Tensor


def frozen_state(C, T, max_iter: int, conv_tol: float) -> FrozenState:
    """The ``while_loop``'s first carry: copies of the flat ``C`` and ``T``,
    ``dist2 = inf``, ``i = 0``, the limits, ``done`` when ``max_iter <= 0``."""
    n = min(max(int(max_iter), 0), 2**31 - 1)
    dev = C.device
    return FrozenState(C.clone(), T.clone(),
                       torch.full((1,), math.inf, dtype=C.real.dtype, device=dev),
                       torch.full((1,), conv_tol, dtype=torch.float64, device=dev),
                       torch.tensor([0, int(n == 0), 0, n], dtype=torch.int32, device=dev))


def _symmetrized(raw, partner):
    other = torch.where(partner >= 0, raw[partner.clamp(min=0)], torch.zeros_like(raw))
    return 0.5 * (raw + other.conj())


def frozen_commit_twin(state: FrozenState, rawC, rawT, pC, pT) -> None:
    """The same step in torch ops, in place on ``state``."""
    C, T, dist2, conv_tol, ctl = state
    go = ctl[1] == 0
    sC, sT = _symmetrized(rawC, pC), _symmetrized(rawT, pT)
    nC = sC * (1.0 / sC.abs().max())
    nT = sT * (1.0 / sT.abs().max())
    d2 = ((nC - C).abs() ** 2).sum() + ((nT - T).abs() ** 2).sum()
    C.copy_(torch.where(go, nC, C))
    T.copy_(torch.where(go, nT, T))
    dist2.copy_(torch.where(go, d2, dist2))
    it = ctl[0] + go.to(torch.int32)
    done = torch.where(go, ~((it < ctl[3]) & (d2.double() > conv_tol[0] * conv_tol[0])), ~go)
    ctl[0] = it
    ctl[1] = done.to(torch.int32)


def frozen_commit(state: FrozenState, rawC, rawT, pC, pT) -> None:
    """Symmetrize the move's raw ``C'``, ``T'`` with their transpose partners,
    scale each by ``1 / max|.|``, form ``dist2`` to the committed state,
    commit, ``i += 1`` and ``done = not (i < max_iter and dist2 > conv_tol^2)``;
    nothing happens once ``done`` is set."""
    for name, new, old in (("C", rawC, state.C), ("T", rawT, state.T), ("pC", pC, state.C),
                           ("pT", pT, state.T)):
        if new.shape != old.shape:
            raise ValueError(f"frozen_commit: {name} shape {tuple(new.shape)} != "
                             f"{tuple(old.shape)}")
    if not route("frozen_commit", state.C, state.T, state.dist2, rawC, rawT):
        return frozen_commit_twin(state, rawC, rawT, pC, pT)
    for name, t, dtype in (("pC", pC, torch.int64), ("pT", pT, torch.int64),
                           ("ctl", state.ctl, torch.int32), ("conv_tol", state.conv_tol,
                                                             torch.float64)):
        if t.device != rawC.device or t.dtype != dtype:
            raise ValueError(f"frozen_commit: {name} must be {dtype} on {rawC.device}")
    require_contiguous("frozen_commit", C=state.C, T=state.T, rawC=rawC, rawT=rawT, pC=pC, pT=pT)
    lib = library()
    nC, nT = rawC.numel(), rawT.numel()
    sym = torch.empty(nC + nT, dtype=rawC.dtype, device=rawC.device)
    part = torch.empty(lib.cdll.tpeps_frozen_commit_partials(), dtype=rawC.dtype,
                       device=rawC.device)
    with torch.cuda.device(rawC.device):
        err = getattr(lib.cdll, f"tpeps_frozen_commit_{suffix(rawC)}")(
            state.C.data_ptr(), state.T.data_ptr(), state.dist2.data_ptr(),
            state.conv_tol.data_ptr(), state.ctl.data_ptr(), sym.data_ptr(), part.data_ptr(),
            rawC.data_ptr(), rawT.data_ptr(), pC.data_ptr(), pT.data_ptr(), nC, nT,
            stream_of(rawC))
    lib.check(err, "frozen_commit")
    LAUNCHES["frozen_commit"] += 1
