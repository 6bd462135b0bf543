"""Frozen-structure C4v abelian CTMRG and its implicit gradient
(counterpart of tpeps/ctm/c4v_abelian/frozen.py).

With the per-sector chi profile frozen (``keep``), every block structure of
the move is fixed, so every plan of it is built once and reused: each move
is the corner's ``block_gemm``s, the gather of its sector matrices, the
sector eigh/SVDs (cuSOLVER), the scatter of the isometry, the ``block_gemm``s
of C' and T' written straight into the frozen block sets of C and T, and
one ``frozen_commit`` (K9: symmetrize, normalize, distance, commit, loop
test).  cuSOLVER does not capture into a CUDA graph here, so the loop stays
on the host and reads the 4-byte ``done`` once a move.

``converge_frozen`` differentiates implicitly, as the JAX package's
``_make_converge_frozen``: the backward builds the graph of one
``move_frozen`` at the fixed point (its epilogue's backward is
the ``frozen_epilogue_vjp`` kernel) and iterates the Neumann adjoint
``u <- (d move/d env)^T u + ybar`` with ``torch.autograd.grad`` on that
graph, one ``adjoint_commit`` (accumulate, |u|^2, JAX's divergence guard and
loop test on the card) and one 4-byte read of ``done`` per iteration.

The frozen gauge fixing ties (ROADMAP Queue 3), so the forward loop never
reaches an elementwise fixed point where a tie flips signs between moves:
``move(x*) = R * x*`` for a +-1 pattern ``R``.  The backward therefore
linearizes ``R * move``, whose fixed point ``x*`` is (``R`` from one more
move after the loop, detached); where ``R = 1`` this is JAX's backward.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...kernels.frozen import (adjoint_commit, adjoint_state, frozen_commit,
                               frozen_epilogue_vjp, frozen_state)
from ...sym.frozen import eigh_blockwise_fixed, reindex_like
from ...sym.tensor import AbelianTensor, PLANS, Struct, make_struct
from ..generic_abelian.components import c2x2_lu
from .env import ENV_C4V_ABELIAN, flip_signature

C_PARTNER, T_PARTNER = (1, 0), (3, 1, 2, 0)


def _move_raw(a, C, T, keep, ad_decomp_reg=1.0e-12, out_like=True, timers=None):
    """The frozen move up to its epilogue: ``(C', T')`` unsymmetrized and
    unnormalized, laid out in the block sets of ``C`` and ``T`` (when
    ``out_like``; else as produced)."""
    def phase(name):
        return timers.phase(name, a.device) if timers is not None else nullcontext()

    with phase("corner"):
        M = c2x2_lu(C, T, T.transpose((0, 3, 1, 2)), a)
    with phase("decomposition"):
        P, _W = eigh_blockwise_fixed(M, (0, 1, 2), (3, 4, 5), keep, ad_decomp_reg=ad_decomp_reg)
    with phase("absorb"):
        nC = P.conj().tensordot(M, ((0, 1, 2), (0, 1, 2)))
        nC = nC.tensordot(flip_signature(P), ((1, 2, 3), (0, 1, 2)),
                          out_like=C if out_like else None)
        Tf = flip_signature(T)
        af = flip_signature(a)
        z = P.tensordot(Tf, ((0,), (0,)))
        z = z.tensordot(af, ((0, 3), (1, 2)))
        z = z.tensordot(af.conj(), ((0, 2, 4), (1, 2, 0)))
        nT = z.tensordot(P, ((1, 2, 4), (0, 1, 2)), out_like=T if out_like else None)
    return nC, nT


def partner_index(struct: Struct, axes, device) -> torch.Tensor:
    """Per element of ``struct``'s flat layout, the flat index of the element
    that ``transpose(axes)`` puts there (-1 where that block is absent).
    ``axes`` must be an involution (C's (1, 0), T's (3, 1, 2, 0))."""

    def build():
        out = np.full(struct.numel, -1, dtype=np.int64)
        for b, (k, off, size) in enumerate(zip(struct.keys, struct.offsets, struct.sizes)):
            pb = struct.index.get(tuple(k[i] for i in axes))
            if pb is None:
                continue
            src = np.arange(int(struct.sizes[pb])).reshape(struct.shapes[pb]).transpose(axes)
            out[off:off + size] = struct.offsets[pb] + src.reshape(-1)
        return out

    host = PLANS.get_or(("partner", struct, tuple(axes)), build)
    return PLANS.get_or(("partner_dev", struct, tuple(axes), str(device)),
                        lambda: torch.from_numpy(host).to(device))


def block_index(struct: Struct, device) -> torch.Tensor:
    """Per element of ``struct``'s flat layout, the index of its block (int32)."""
    return PLANS.get_or(("block_index", struct, str(device)), lambda: torch.from_numpy(
        np.repeat(np.arange(len(struct.keys), dtype=np.int32), struct.sizes)).to(device))


class _Epilogue(torch.autograd.Function):
    """The move's epilogue on the flat raw ``C'``, ``T'``: forward
    ``frozen_commit`` on a scratch state, backward ``frozen_epilogue_vjp``
    (the max-abs scales differentiated, or detached with ``sg_norm``)."""

    @staticmethod
    def forward(ctx, rawC, rawT, pC, pT, bC, bT, nb, sg_norm):
        rawC, rawT = rawC.detach(), rawT.detach()
        st = frozen_state(torch.zeros_like(rawC), torch.zeros_like(rawT), 1, 0.0)
        frozen_commit(st, rawC, rawT, pC, pT)
        ctx.save_for_backward(rawC, rawT, pC, pT, bC, bT)
        ctx.nb, ctx.sg_norm = nb, sg_norm
        return st.C, st.T

    @staticmethod
    @once_differentiable
    def backward(ctx, gC, gT):
        rawC, rawT, pC, pT, bC, bT = ctx.saved_tensors
        gC = torch.zeros_like(rawC) if gC is None else gC.detach().contiguous()
        gT = torch.zeros_like(rawT) if gT is None else gT.detach().contiguous()
        xC, xT = frozen_epilogue_vjp(rawC, rawT, pC, pT, gC, gT, bC, bT, *ctx.nb, ctx.sg_norm)
        return xC, xT, None, None, None, None, None, None


def move_frozen(a, C, T, keep, ad_decomp_reg: float = 1.0e-12, sg_norm: bool = True):
    """One C4v move at the frozen sector profile ``keep``: the same corner
    and sublattice bookkeeping as ``ctm_move_sl``, truncation by
    ``eigh_blockwise_fixed``, symmetrized, normalized and reindexed onto the
    block sets of ``C`` and ``T`` (by ``frozen_commit`` on a scratch state).
    ``C`` and ``T`` must hold every block the move produces
    (:func:`close_structure`).  Differentiable in ``a``, ``C`` and ``T``;
    ``sg_norm`` detaches the max-abs scales (the JAX package's default; the
    implicit adjoint's move differentiates them, ``sg_norm=False``)."""
    nC, nT = _move_raw(a, C, T, dict(keep), ad_decomp_reg)
    yC, yT = _Epilogue.apply(nC.data, nT.data, partner_index(C.struct, C_PARTNER, C.device),
                             partner_index(T.struct, T_PARTNER, T.device),
                             block_index(C.struct, C.device), block_index(T.struct, T.device),
                             (len(C.struct.keys), len(T.struct.keys)), sg_norm)
    return AbelianTensor._flat(C, C.struct, yC), AbelianTensor._flat(T, T.struct, yT)


def _grown(t: AbelianTensor, extra: AbelianTensor) -> AbelianTensor:
    """``t`` on the union of its blocks and ``extra``'s (zeros for the new ones)."""
    keys = list(t.struct.keys) + [k for k in extra.struct.keys if k not in t.struct.index]
    shapes = list(t.struct.shapes) + [extra.struct.shapes[extra.struct.index[k]]
                                      for k in keys[len(t.struct.keys):]]
    ref = AbelianTensor._flat(t, make_struct(t.struct.rank, t.struct.nsym, keys, shapes),
                              torch.empty(0, device="meta"))
    return reindex_like(t, ref)


def close_structure(a, C, T, keep, n_max: int = 6):
    """Grow the (C, T) block sets until they hold every block the frozen move
    produces, so that the move maps the sets into themselves.  The output
    block sets follow from the input ones alone: the move runs on ``meta``
    tensors (plans, no data, no launch), as the JAX package runs it under
    ``jax.eval_shape``; the symmetrization's block set is the union of the
    raw output's and its transpose partner's.  No arithmetic runs on a meta
    tensor (its first use imports torch's meta kernels, seconds).  Missing
    blocks are filled with zeros."""
    keep = dict(keep)
    with torch.no_grad():
        return _close(a.to("meta"), C, T, keep, n_max)


def _close(am, C, T, keep, n_max):
    for _ in range(n_max):
        Cm, Tm = C.to("meta"), T.to("meta")
        nC, nT = _move_raw(am, Cm, Tm, keep, out_like=False)
        nC, nT = (nC, nC.transpose(C_PARTNER)), (nT, nT.transpose(T_PARTNER))
        if all(set(x.struct.keys) <= set(C.struct.keys) for x in nC) and \
                all(set(x.struct.keys) <= set(T.struct.keys) for x in nT):
            return C, T
        C, T = _grown(_grown(C, nC[0]), nC[1]), _grown(_grown(T, nT[0]), nT[1])
    raise RuntimeError("abelian env structure failed to close under the move")


def run_frozen(a, C, T, keep, max_iter: int = 200, conv_tol: float = 1.0e-10,
               ad_decomp_reg: float = 1.0e-12, timers=None):
    """Iterate the frozen move to the elementwise fixed point: the loop test
    on the card (``frozen_commit``), one 4-byte read of ``done`` per move.

    :param keep: frozen chi profile, ``{charge: dim}`` or ``((charge, dim), ...)``
    :param timers: optional :class:`~tpeps_torch.profiling.PhaseTimers`; gets
        the phases "corner", "decomposition", "absorb" and "commit" per move
    :return: ``(C*, T*, n_iter, dist2)``
    """
    kd = dict(keep)
    pC = partner_index(C.struct, C_PARTNER, C.device)
    pT = partner_index(T.struct, T_PARTNER, T.device)
    st = frozen_state(C.data, T.data, max_iter, conv_tol)
    Cs, Ts = AbelianTensor._flat(C, C.struct, st.C), AbelianTensor._flat(T, T.struct, st.T)
    while not bool(st.ctl[1]):
        nC, nT = _move_raw(a, Cs, Ts, kd, ad_decomp_reg, timers=timers)
        with timers.phase("commit", a.device) if timers is not None else nullcontext():
            frozen_commit(st, nC.data, nT.data, pC, pT)
    return (AbelianTensor._flat(C, C.struct, st.C.clone()),
            AbelianTensor._flat(T, T.struct, st.T.clone()), int(st.ctl[0]), float(st.dist2))


def freeze_from_env(env: ENV_C4V_ABELIAN):
    """The frozen chi profile of a (dynamically) converged env: the sector
    table of the corner's first leg, as a hashable tuple."""
    return tuple(sorted(env.C.legs[0].charges))


ALIGN_REL = 1.0e-12  # entries below this times the tensor's max keep R = 1
# the implicit adjoint's default limits (the JAX package's): iterations and |u| / |ybar|
ADJOINT_MAX_ITER, ADJOINT_TOL = 100, 1.0e-8


def sign_alignment(a, C, T, keep, ad_decomp_reg: float = 1.0e-12):
    """``(R_C, R_T)``: per element ``sign(move(x)) * sign(x)`` of one more
    frozen move from ``(C, T)``, 1 where ``|x|`` is below ``ALIGN_REL`` times
    the tensor's max (detached); ``None`` for a tensor where it is 1
    throughout."""
    with torch.no_grad():
        mC, mT = move_frozen(a, C, T, keep, ad_decomp_reg, sg_norm=False)
        out = []
        for x, y in ((C.data, mC.data), (T.data, mT.data)):
            r = torch.where(x.abs() < ALIGN_REL * x.abs().max(), torch.ones_like(x),
                            torch.sign(y) * torch.sign(x))
            out.append(None if bool((r == 1).all()) else r)
    return tuple(out)


class _ConvergeClosed(torch.autograd.Function):
    """``(C*, T*)`` of the frozen fixed point from a closed ``(C0, T0)``, with
    the implicit adjoint as backward (``a``'s flat buffer is the one input
    that takes a gradient)."""

    @staticmethod
    def forward(ctx, a_data, a, C0, T0, keep, opts, stats):
        a = AbelianTensor._flat(a, a.struct, a_data.detach())
        t0 = time.perf_counter()
        Cf, Tf, n, d2 = run_frozen(a, C0, T0, keep, max_iter=opts["max_iter"],
                                   conv_tol=opts["conv_tol"], ad_decomp_reg=opts["ad_decomp_reg"])
        R = sign_alignment(a, Cf, Tf, keep, opts["ad_decomp_reg"])
        ctx.a, ctx.keep, ctx.opts, ctx.stats, ctx.R = a, keep, opts, stats, R
        ctx.Cf, ctx.Tf = Cf, Tf
        if stats is not None:
            stats.update(forward_moves=n, forward_dist2=d2,
                         sign_aligned=[r is not None for r in R],
                         forward_seconds=time.perf_counter() - t0)
        return Cf.data, Tf.data

    @staticmethod
    @once_differentiable
    def backward(ctx, gC, gT):
        a, Cf, Tf, opts, stats = ctx.a, ctx.Cf, ctx.Tf, ctx.opts, ctx.stats
        t0 = time.perf_counter()
        gC = torch.zeros_like(Cf.data) if gC is None else gC.detach().contiguous()
        gT = torch.zeros_like(Tf.data) if gT is None else gT.detach().contiguous()
        leaves = [x.data.detach().requires_grad_() for x in (a, Cf, Tf)]
        with torch.enable_grad():
            yC, yT = move_frozen(*(AbelianTensor._flat(x, x.struct, v)
                                   for x, v in zip((a, Cf, Tf), leaves)),
                                 ctx.keep, opts["ad_decomp_reg"], sg_norm=False)
            ys = [y.data if r is None else y.data * r for y, r in zip((yC, yT), ctx.R)]
        st = adjoint_state(leaves[0].detach(), gC, gT, opts["adjoint_max_iter"],
                           opts["adjoint_tol"])
        u = (gC, gT)
        while not bool(st.ctl[1]):
            g = torch.autograd.grad(ys, leaves, grad_outputs=u, retain_graph=True,
                                    allow_unused=True)
            g = [torch.zeros_like(x) if gi is None else gi.contiguous()
                 for gi, x in zip(g, leaves)]
            adjoint_commit(st, g[0], g[1], g[2])
            u = (g[1], g[2])
        i, diverged = (int(x) for x in st.ctl[[0, 5]].tolist())
        if diverged:
            print(f"tpeps_torch: frozen abelian CTMRG adjoint diverging (iter {i}, "
                  f"|u|^2={float(st.scal[0])}); gradient truncated", flush=True)
        if stats is not None:
            stats.update(adjoint_iters=i, adjoint_diverged=bool(diverged),
                         adjoint_delta=float(st.scal[0]),
                         adjoint_seconds=time.perf_counter() - t0)
        return st.da, None, None, None, None, None, None


def converge_closed(a, C, T, keep, max_iter: int = 200, conv_tol: float = 1.0e-10,
                    ad_decomp_reg: float = 1.0e-12, adjoint_max_iter: int = ADJOINT_MAX_ITER,
                    adjoint_tol: float = ADJOINT_TOL, stats=None):
    """The converged ``(C*, T*)`` from a closed warm start ``(C, T)`` (the
    output of :func:`close_structure`), differentiable in ``a`` by the
    implicit adjoint (the JAX package's ``_make_converge_frozen(...)(a, C,
    T)``): ``C`` and ``T`` take no gradient.

    :param adjoint_max_iter: the adjoint's iteration limit
    :param adjoint_tol: the adjoint stops once ``|u| <= adjoint_tol |ybar|``
    :param stats: optional dict; gets the forward's move count, distance and
        host seconds (the alignment move included), whether ``R != 1`` for C
        and T, and after a backward the adjoint's iterations, whether it
        diverged, its last ``|u|^2`` and its host seconds (graph built,
        iterations, one read of ``done`` each)
    """
    opts = dict(max_iter=max_iter, conv_tol=conv_tol, ad_decomp_reg=ad_decomp_reg,
                adjoint_max_iter=adjoint_max_iter, adjoint_tol=adjoint_tol)
    keep = dict(keep)
    if not (torch.is_grad_enabled() and a.data.requires_grad):
        Cf, Tf, n, d2 = run_frozen(a, C, T, keep, max_iter=max_iter, conv_tol=conv_tol,
                                   ad_decomp_reg=ad_decomp_reg)
        if stats is not None:
            stats.update(forward_moves=n, forward_dist2=d2)
        return Cf, Tf
    cd, td = _ConvergeClosed.apply(a.data, a, C, T, keep, opts, stats)
    return AbelianTensor._flat(C, C.struct, cd), AbelianTensor._flat(T, T.struct, td)


def converge_frozen(a, env: ENV_C4V_ABELIAN, keep=None, max_iter: int = 200,
                    conv_tol: float = 1.0e-10, ad_decomp_reg: float = 1.0e-12,
                    adjoint_max_iter: int = ADJOINT_MAX_ITER, adjoint_tol: float = ADJOINT_TOL):
    """Converged environment from a warm (dynamic) env at a frozen profile:
    ``close_structure`` then :func:`converge_closed`; gradients flow into
    ``a`` through the implicit adjoint."""
    if keep is None:
        keep = freeze_from_env(env)
    C, T = close_structure(a, env.C, env.T, dict(keep))
    Cf, Tf = converge_closed(a, C, T, keep, max_iter=max_iter, conv_tol=conv_tol,
                             ad_decomp_reg=ad_decomp_reg, adjoint_max_iter=adjoint_max_iter,
                             adjoint_tol=adjoint_tol)
    return ENV_C4V_ABELIAN(env.chi, Cf, Tf)
