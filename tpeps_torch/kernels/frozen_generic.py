"""K10 (``csrc/frozen_generic.cu``) and its twins: the generic-cell frozen
abelian loop (tpeps/ctm/generic_abelian/frozen.py:make_converge_frozen_generic)
on the card.

* ``generic_epilogue``: the end of a frozen directional move: each raw output
  (two corners and one edge per site) scaled by ``1 / max|.|`` (``_normalized``,
  :35-37) and written into its slot of the flat environment.
* ``sweep_commit``: one step of the sweep loop (:179-192): ``dist2`` over every
  C and T (``_env_dist2``, :149-153), the commit, ``i += 1`` and the loop test,
  state in a :class:`SweepState`.
* ``generic_epilogue_vjp``: the backward of ``generic_epilogue`` inside the
  implicit adjoint (:198-243), the scale detached or differentiated with the
  JAX package's split over tied maxima.

The environment is one flat buffer (every C, then every T, each in its frozen
block layout); a move's raw outputs come as one flat buffer described by a
:class:`SegmentTable`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import LAUNCHES, barrier_counters, require_contiguous, route, stream_of, suffix
from .build import library
from .frozen import scale_vjp_twin


class SegmentTable(NamedTuple):
    """A move's raw outputs in one flat buffer: per output (segment) its raw
    offset, env offset, length, and the range of its blocks in a numbering
    across the raw buffer (``seg`` int64 ``(nseg, 5)`` on the device, ``host``
    the same in numpy); ``blk`` the block index of every raw element (int32)."""

    seg: torch.Tensor
    host: np.ndarray
    blk: torch.Tensor
    nblk: int
    numel: int


def segment_table(outputs, device) -> SegmentTable:
    """The table of raw outputs laid out one after another: ``outputs`` a list of
    ``(env offset, block sizes)``, one per output."""
    rows, sizes, src, b0 = [], [], 0, 0
    for dst, bsz in outputs:
        bsz = np.asarray(bsz, dtype=np.int64)
        n = int(bsz.sum())
        rows.append((src, int(dst), n, b0, b0 + len(bsz)))
        sizes.append(bsz)
        src += n
        b0 += len(bsz)
    host = np.array(rows, dtype=np.int64).reshape(-1, 5)
    sizes = np.concatenate(sizes) if sizes else np.zeros(0, dtype=np.int64)
    blk = np.repeat(np.arange(b0, dtype=np.int32), sizes)
    return SegmentTable(torch.from_numpy(host).to(device), host,
                        torch.from_numpy(blk).to(device), b0, src)


class SweepState(NamedTuple):
    """The sweep loop's carry: the committed env ``S`` (flat), ``dist2`` (1
    element), ``conv_tol`` (1 element, float64), ``ctl`` int32 ``[i, done,
    arrival counter, max_iter]``."""

    S: torch.Tensor
    dist2: torch.Tensor
    conv_tol: torch.Tensor
    ctl: torch.Tensor


def sweep_state(X, max_iter: int, conv_tol: float) -> SweepState:
    """The first carry: a copy of the flat env, ``dist2 = inf``, ``i = 0``, the
    limits, ``done`` when ``max_iter <= 0``."""
    n = min(max(int(max_iter), 0), 2**31 - 1)
    dev = X.device
    return SweepState(X.clone(), torch.full((1,), math.inf, dtype=X.dtype, device=dev),
                      torch.full((1,), conv_tol, dtype=torch.float64, device=dev),
                      torch.tensor([0, int(n == 0), 0, n], dtype=torch.int32, device=dev))


def _check(name, raw, seg: SegmentTable, env):
    if raw.dim() != 1 or raw.numel() != seg.numel:
        raise ValueError(f"{name}: raw has {raw.numel()} elements, the table {seg.numel}")
    if len(seg.host) and int((seg.host[:, 1] + seg.host[:, 2]).max()) > env.numel():
        raise ValueError(f"{name}: a segment ends past the env's {env.numel()} elements")


def generic_epilogue_twin(raw, seg: SegmentTable, env) -> None:
    """The same step in torch ops, in place on ``env``."""
    for so, do, n, _, _ in seg.host.tolist():
        x = raw[so:so + n]
        env[do:do + n] = x * (1.0 / x.abs().max())


def generic_epilogue(raw, seg: SegmentTable, env) -> None:
    """Per segment of the flat ``raw`` (:class:`SegmentTable`) ``m = max|x|``
    and ``env[slot] = x * (1 / m)``, in place on ``env``: one cooperative
    launch for every 64 segments (a directional move has three a site)."""
    _check("generic_epilogue", raw, seg, env)
    if not route("generic_epilogue", raw, env):
        return generic_epilogue_twin(raw, seg, env)
    if seg.seg.device != raw.device:
        raise ValueError(f"generic_epilogue: the table must be on {raw.device}")
    require_contiguous("generic_epilogue", raw=raw, env=env)
    lib = library()
    bar = barrier_counters(raw.device, "generic_epilogue",
                           lib.cdll.tpeps_generic_epilogue_bar_words())
    with torch.cuda.device(raw.device):
        err = getattr(lib.cdll, f"tpeps_generic_epilogue_{suffix(raw)}")(
            raw.data_ptr(), seg.seg.data_ptr(), len(seg.host), bar.data_ptr(), env.data_ptr(),
            stream_of(raw))
    lib.check(err, "generic_epilogue")
    LAUNCHES["generic_epilogue"] += 1


def sweep_commit_twin(state: SweepState, W) -> None:
    """The same step in torch ops, in place on ``state``."""
    S, dist2, conv_tol, ctl = state
    go = ctl[1] == 0
    d2 = ((W - S).abs() ** 2).sum()
    S.copy_(torch.where(go, W, S))
    dist2.copy_(torch.where(go, d2, dist2))
    it = ctl[0] + go.to(torch.int32)
    done = torch.where(go, ~((it < ctl[3]) & (d2.double() > conv_tol[0] * conv_tol[0])), ~go)
    ctl[0] = it
    ctl[1] = done.to(torch.int32)


def sweep_commit(state: SweepState, W) -> None:
    """``dist2 = sum |W - S|^2`` over the flat env, ``S = W``, ``i += 1`` and
    ``done = not (i < max_iter and dist2 > conv_tol^2)``; nothing happens once
    ``done`` is set."""
    if W.shape != state.S.shape:
        raise ValueError(f"sweep_commit: W shape {tuple(W.shape)} != {tuple(state.S.shape)}")
    if not route("sweep_commit", state.S, state.dist2, W):
        return sweep_commit_twin(state, W)
    for name, t, dtype in (("ctl", state.ctl, torch.int32),
                           ("conv_tol", state.conv_tol, torch.float64)):
        if t.device != W.device or t.dtype != dtype:
            raise ValueError(f"sweep_commit: {name} must be {dtype} on {W.device}")
    require_contiguous("sweep_commit", S=state.S, W=W)
    lib = library()
    part = torch.empty(lib.cdll.tpeps_generic_epilogue_partials(), dtype=W.dtype,
                       device=W.device)
    with torch.cuda.device(W.device):
        err = getattr(lib.cdll, f"tpeps_sweep_commit_{suffix(W)}")(
            state.S.data_ptr(), W.data_ptr(), W.numel(), state.dist2.data_ptr(),
            state.conv_tol.data_ptr(), state.ctl.data_ptr(), part.data_ptr(), stream_of(W))
    lib.check(err, "sweep_commit")
    LAUNCHES["sweep_commit"] += 1


def generic_epilogue_vjp_twin(raw, gW, seg: SegmentTable, sg_norm: bool = False):
    out = torch.empty_like(raw)
    for so, do, n, b0, b1 in seg.host.tolist():
        out[so:so + n] = scale_vjp_twin(raw[so:so + n], gW[do:do + n], seg.blk[so:so + n] - b0,
                                        b1 - b0, sg_norm)
    return out


def generic_epilogue_vjp(raw, gW, seg: SegmentTable, sg_norm: bool = False):
    """Cotangent of the flat ``raw`` for the cotangent ``gW`` of the env that
    :func:`generic_epilogue` writes: per segment ``g/m``, minus ``(sum g.x /
    m^2) w sign(x)`` with the scale differentiated (``w`` the JAX package's
    split over tied maxima: 1 over the blocks whose max ties ``m``, then over
    the tied elements of each such block); ``g`` read from the segment's env
    slot.  One cooperative launch for every 64 segments; a NaN in a segment
    makes that segment's cotangent NaN, as ``max`` does.  Real dtypes only."""
    _check("generic_epilogue_vjp", raw, seg, gW)
    if raw.is_complex() or gW.is_complex():
        raise TypeError("generic_epilogue_vjp takes real tensors")
    if not route("generic_epilogue_vjp", raw, gW):
        return generic_epilogue_vjp_twin(raw, gW, seg, sg_norm)
    for name, t in (("seg", seg.seg), ("blk", seg.blk)):
        if t.device != raw.device:
            raise ValueError(f"generic_epilogue_vjp: {name} must be on {raw.device}")
    require_contiguous("generic_epilogue_vjp", raw=raw, gW=gW)
    lib = library()
    out = torch.empty_like(raw)
    part = torch.empty(lib.cdll.tpeps_generic_epilogue_vjp_partials(), dtype=raw.dtype,
                       device=raw.device)
    # the tie counts, zeroed by the kernel
    cnt = torch.empty(max(seg.nblk, 1), dtype=torch.int32, device=raw.device)
    bar = barrier_counters(raw.device, "generic_epilogue_vjp",
                           lib.cdll.tpeps_generic_epilogue_vjp_bar_words())
    with torch.cuda.device(raw.device):
        err = getattr(lib.cdll, f"tpeps_generic_epilogue_vjp_{suffix(raw)}")(
            raw.data_ptr(), gW.data_ptr(), seg.seg.data_ptr(), len(seg.host), seg.blk.data_ptr(),
            part.data_ptr(), cnt.data_ptr(), bar.data_ptr(), int(bool(sg_norm)), out.data_ptr(),
            stream_of(raw))
    lib.check(err, "generic_epilogue_vjp")
    LAUNCHES["generic_epilogue_vjp"] += 1
    return out
