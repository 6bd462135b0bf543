"""K9 epilogue (``csrc/frozen_commit.cu``) and its twin: the end of a frozen
C4v abelian move and one step of ``run_frozen``'s ``while_loop``
(tpeps/ctm/c4v_abelian/frozen.py:73-77, 141-149), on the card; and the two
kernels of ``converge_frozen``'s implicit adjoint (:160-233):
``frozen_epilogue_vjp`` (the epilogue's backward, the scale differentiated
or detached) and ``adjoint_commit`` (one step of the Neumann adjoint's
``while_loop``, state in an :class:`AdjointState`).

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

from . import LAUNCHES, barrier_counters, require_contiguous, route, stream_of, suffix
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
    part = torch.empty(lib.cdll.tpeps_frozen_commit_partials(), dtype=rawC.dtype,
                       device=rawC.device)
    bar = barrier_counters(rawC.device, "frozen_commit",
                           lib.cdll.tpeps_frozen_commit_bar_words())
    with torch.cuda.device(rawC.device):
        err = getattr(lib.cdll, f"tpeps_frozen_commit_{suffix(rawC)}")(
            state.C.data_ptr(), state.T.data_ptr(), state.dist2.data_ptr(),
            state.conv_tol.data_ptr(), state.ctl.data_ptr(), part.data_ptr(), bar.data_ptr(),
            rawC.data_ptr(), rawT.data_ptr(), pC.data_ptr(), pT.data_ptr(), rawC.numel(),
            rawT.numel(), stream_of(rawC))
    lib.check(err, "frozen_commit")
    LAUNCHES["frozen_commit"] += 1


def tie_weights(z, m, blk, nblk: int):
    """The JAX package's split of ``d max|z| / dz`` (a max per block, then a
    max over the blocks, each splitting evenly among ties): per element
    ``1 / (n_tied_blocks * n_tied_in_its_block)`` where ``|z| = m``, else 0.
    ``blk``: per element its block's index (int32) among ``nblk``."""
    tie = z.abs() == m
    cnt = torch.zeros(nblk, dtype=z.dtype, device=z.device).index_add_(
        0, blk[tie].long(), torch.ones_like(z[tie]))
    ntb = (cnt > 0).sum().to(z.dtype)
    return torch.where(tie, 1.0 / (ntb * cnt[blk.long()]), torch.zeros_like(z))


def scale_vjp_twin(z, g, blk, nblk: int, sg_norm: bool):
    """Cotangent of ``z`` for the cotangent ``g`` of ``y = z * (1 / max|z|)``:
    ``g/m``, minus ``(sum g.z / m^2) w sign(z)`` with the scale differentiated
    (``w`` from :func:`tie_weights`)."""
    m = z.abs().max()
    inv = 1.0 / m
    zb = g * inv
    if sg_norm:
        return zb
    coef = (g * z).sum() * inv * inv
    return zb - (coef * tie_weights(z, m, blk, nblk)) * torch.sign(z)


def frozen_epilogue_vjp_twin(rawC, rawT, pC, pT, gC, gT, bC, bT, nbC, nbT, sg_norm=False):
    out = []
    for raw, p, g, b, nb in ((rawC, pC, gC, bC, nbC), (rawT, pT, gT, bT, nbT)):
        zb = scale_vjp_twin(_symmetrized(raw, p), g, b, nb, sg_norm)
        out.append(0.5 * (zb + torch.where(p >= 0, zb[p.clamp(min=0)], torch.zeros_like(zb))))
    return tuple(out)


def frozen_epilogue_vjp(rawC, rawT, pC, pT, gC, gT, bC, bT, nbC: int, nbT: int,
                        sg_norm: bool = False):
    """Cotangents of the raw ``C'``, ``T'`` for the cotangents ``gC``, ``gT``
    of the epilogue ``y = z * (1 / max|z|)``, ``z`` the symmetrization of the
    raw move with its transpose partners (``pC``, ``pT`` as for
    :func:`frozen_commit`): ``zbar = g/m - (sum g.z / m^2) w sign(z)``, ``w``
    the JAX package's split over the ties (:func:`tie_weights`; ``bC``,
    ``bT`` the elements' block indices (int32) among ``nbC``, ``nbT`` blocks),
    the second term dropped when ``sg_norm`` (the scale detached), then
    ``xbar = sym(zbar)``; one cooperative launch.  A NaN in a symmetrized
    tensor makes its whole cotangent NaN, as ``max`` does.  Real dtypes
    only.  Returns ``(xC, xT)``."""
    for name, t, ref in (("rawT", rawT, rawT), ("pC", pC, rawC), ("pT", pT, rawT),
                         ("gC", gC, rawC), ("gT", gT, rawT), ("bC", bC, rawC), ("bT", bT, rawT)):
        if t.shape != ref.shape:
            raise ValueError(f"frozen_epilogue_vjp: {name} shape {tuple(t.shape)}")
    if rawC.is_complex() or rawT.is_complex():
        raise TypeError("frozen_epilogue_vjp takes real tensors")
    if not route("frozen_epilogue_vjp", rawC, rawT, gC, gT):
        return frozen_epilogue_vjp_twin(rawC, rawT, pC, pT, gC, gT, bC, bT, nbC, nbT, sg_norm)
    for name, t, dtype in (("pC", pC, torch.int64), ("pT", pT, torch.int64),
                           ("bC", bC, torch.int32), ("bT", bT, torch.int32)):
        if t.device != rawC.device or t.dtype != dtype:
            raise ValueError(f"frozen_epilogue_vjp: {name} must be {dtype} on {rawC.device}")
    require_contiguous("frozen_epilogue_vjp", rawC=rawC, rawT=rawT, pC=pC, pT=pT, gC=gC, gT=gT,
                       bC=bC, bT=bT)
    lib = library()
    xC, xT = torch.empty_like(rawC), torch.empty_like(rawT)
    part = torch.empty(lib.cdll.tpeps_frozen_epilogue_vjp_partials(), dtype=rawC.dtype,
                       device=rawC.device)
    # the tie counts, zeroed by the kernel
    cnt = torch.empty(max(nbC + nbT, 1), dtype=torch.int32, device=rawC.device)
    bar = barrier_counters(rawC.device, "frozen_epilogue_vjp",
                           lib.cdll.tpeps_frozen_epilogue_vjp_bar_words())
    with torch.cuda.device(rawC.device):
        err = getattr(lib.cdll, f"tpeps_frozen_epilogue_vjp_{suffix(rawC)}")(
            rawC.data_ptr(), rawT.data_ptr(), pC.data_ptr(), pT.data_ptr(), gC.data_ptr(),
            gT.data_ptr(), bC.data_ptr(), bT.data_ptr(), cnt.data_ptr(), bar.data_ptr(), nbC,
            nbT, xC.data_ptr(), xT.data_ptr(), part.data_ptr(), rawC.numel(), rawT.numel(),
            int(bool(sg_norm)), stream_of(rawC))
    lib.check(err, "frozen_epilogue_vjp")
    LAUNCHES["frozen_epilogue_vjp"] += 1
    return xC, xT


class AdjointState(NamedTuple):
    """The Neumann adjoint's carry: ``da`` the accumulated cotangent of the
    site (flat), ``scal`` float64 ``[delta, |ybar|^2, tol^2]``, ``ctl`` int32
    ``[i, done, arrival counter, max_iter, grew, diverged]``."""

    da: torch.Tensor
    scal: torch.Tensor
    ctl: torch.Tensor


def adjoint_state(a, gC, gT, max_iter: int, tol: float) -> AdjointState:
    """The ``while_loop``'s first carry: ``da = 0``, ``delta = |ybar|^2`` of the
    cotangents ``gC``, ``gT``, ``i = grew = 0`` and ``done`` when JAX's
    condition already fails (``max_iter <= 0`` or a zero cotangent)."""
    dev = gC.device
    cn = ((gC.abs() ** 2).sum() + (gT.abs() ** 2).sum()).to(torch.float64)
    tol2 = float(tol) ** 2
    n = min(max(int(max_iter), 0), 2**31 - 1)
    go = (n > 0) & (cn > tol2 * cn) & (cn < 1.0e4 * cn)
    ctl = torch.zeros(6, dtype=torch.int32, device=dev)
    ctl[1] = (~go).to(torch.int32)
    ctl[3] = n
    scal = torch.stack([cn, cn, torch.full_like(cn, tol2)])
    return AdjointState(torch.zeros_like(a), scal, ctl)


def adjoint_commit_twin(state: AdjointState, da_i, uC, uT) -> None:
    """The same step in torch ops, in place on ``state``."""
    da, scal, ctl = state
    go = ctl[1] == 0
    dn = ((uC.abs() ** 2).sum() + (uT.abs() ** 2).sum()).to(torch.float64)
    it = ctl[0] + 1
    grew = torch.where(dn > scal[0], ctl[4] + 1, torch.zeros_like(ctl[4]))
    cn, tol2 = scal[1], scal[2]
    cont = (it < ctl[3]) & (dn > tol2 * cn) & (grew < 4) & (dn < 1.0e4 * cn)
    div = ((grew >= 4) | (dn >= 1.0e4 * cn)) & (dn > tol2 * cn)
    da.copy_(torch.where(go, da + da_i, da))
    scal[0] = torch.where(go, dn, scal[0])
    new = torch.stack([it, (~cont).to(torch.int32), ctl[2], ctl[3], grew, div.to(torch.int32)])
    ctl.copy_(torch.where(go, new.to(torch.int32), ctl))


def adjoint_commit(state: AdjointState, da_i, uC, uT) -> None:
    """One step of the Neumann adjoint, in place on ``state``: ``da += da_i``,
    ``delta = |uC|^2 + |uT|^2``, ``grew``, ``i += 1``, ``done = not (i <
    max_iter and delta > tol^2 |ybar|^2 and grew < 4 and delta < 1e4
    |ybar|^2)`` and ``diverged``; nothing happens once ``done`` is set."""
    if da_i.shape != state.da.shape:
        raise ValueError(f"adjoint_commit: da_i shape {tuple(da_i.shape)} != "
                         f"{tuple(state.da.shape)}")
    if not route("adjoint_commit", state.da, da_i, uC, uT):
        return adjoint_commit_twin(state, da_i, uC, uT)
    for name, t, dtype in (("scal", state.scal, torch.float64), ("ctl", state.ctl, torch.int32)):
        if t.device != da_i.device or t.dtype != dtype or t.numel() != (3 if name == "scal"
                                                                         else 6):
            raise ValueError(f"adjoint_commit: {name} must be {dtype} on {da_i.device}")
    require_contiguous("adjoint_commit", da=state.da, da_i=da_i, uC=uC, uT=uT)
    lib = library()
    part = torch.empty(lib.cdll.tpeps_adjoint_commit_partials(), dtype=da_i.dtype,
                       device=da_i.device)
    with torch.cuda.device(da_i.device):
        err = getattr(lib.cdll, f"tpeps_adjoint_commit_{suffix(da_i)}")(
            state.da.data_ptr(), da_i.data_ptr(), da_i.numel(), uC.data_ptr(), uC.numel(),
            uT.data_ptr(), uT.numel(), state.scal.data_ptr(), state.ctl.data_ptr(),
            part.data_ptr(), stream_of(da_i))
    lib.check(err, "adjoint_commit")
    LAUNCHES["adjoint_commit"] += 1
