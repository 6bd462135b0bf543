"""Frozen-structure generic abelian CTMRG and its implicit gradient
(counterpart of tpeps/ctm/generic_abelian/frozen.py).

With the per-(direction, site) projector sector profiles frozen after a
dynamic run, every block structure of a sweep is fixed, so every plan is
built once and reused.  The environment is one flat buffer (every C, then
every T, each in its frozen block set: :class:`FrozenLayout`).  A directional
move builds each site's halves and ``M = R^T Rt`` (K8), the frozen sector SVD
(``svd_blockwise_fixed``, cuSOLVER), the projectors, and the absorption
(K8), whose outputs are laid out in their env slots' block sets; one
``generic_epilogue`` (K10) normalizes them into the env.  A sweep ends with
one ``sweep_commit`` (K10: distance, commit, loop test) and a 4-byte read of
``done``: cuSOLVER does not capture into a CUDA graph here, so the loop stays
on the host.

``converge_frozen_generic`` differentiates implicitly, as the JAX package's
``make_converge_frozen_generic``: the backward iterates the Neumann adjoint
``u <- (d sweep/d env)^T u + ybar`` over the sweep linearized at the fixed
point with the scales differentiated.  A sweep's graph would not fit on the
card at D=8, so its VJP is a reverse chain of the directional moves' VJPs:
the forward runs one more sweep from the fixed point and stores the env
before each move, and each iteration rebuilds one move's graph at a time
from them; the epilogue's backward is ``generic_epilogue_vjp`` (K10); one
``adjoint_commit`` (K9) and one 4-byte read per iteration.  Where the gauge
fixing's ties flip signs from sweep to sweep (``sweep(x*) = R x*``), the
backward linearizes ``R * sweep`` (``R`` from that extra sweep, detached),
as the C4v engine does; where the loop ends on its distance (an elementwise
fixed point to ``conv_tol``), ``R = 1``.
"""

from __future__ import annotations

import time
import warnings
from contextlib import nullcontext

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...kernels.frozen import adjoint_commit, adjoint_state
from ...kernels.frozen_generic import (generic_epilogue, generic_epilogue_vjp, segment_table,
                                       sweep_commit, sweep_state)
from ...sym.frozen import svd_blockwise_fixed
from ...sym.tensor import AbelianTensor
from ..c4v_abelian.frozen import ADJOINT_MAX_ITER, ADJOINT_TOL, ALIGN_REL, _grown
from .components import HALVES
from .ctmrg import _ABSORB, sweep_directions, target_slots
from .env import ENV_ABELIAN
from .projectors import ctm_get_projectors, projectors_from_svd

MOVE_SEQ = ((0, -1), (-1, 0), (0, 1), (1, 0))


def _phase(timers, name, device):
    return timers.phase(name, device) if timers is not None else nullcontext()


def _projectors_fixed(direction, c, state, env, keep, ad_decomp_reg, timers=None):
    """(P, Pt) at a frozen per-sector profile."""
    dev = state.sites[c].device
    with _phase(timers, "halves", dev):
        R, Rt = HALVES[direction](c, state, env)
        M = R.tensordot(Rt, ((0, 1, 2), (0, 1, 2)))
    with _phase(timers, "decomposition", dev):
        U, S, V = svd_blockwise_fixed(M, (0, 1, 2), (3, 4, 5), keep, ad_decomp_reg=ad_decomp_reg)
    with _phase(timers, "absorb", dev):
        return projectors_from_svd(R, Rt, U, S, V)


def freeze_profiles(state, env: ENV_ABELIAN, chi: int, svd_reltol=1.0e-8, eps_multiplet=1.0e-8):
    """Per-(direction, site) projector sector profiles of an environment: one
    dynamic projector construction per slot, recording the new leg's charge
    table.  Returns ``((direction, coord, ((q, d), ...)), ...)``."""
    prof = []
    for direction in MOVE_SEQ:
        for c in sorted(state.sites):
            P, _ = ctm_get_projectors(direction, c, state, env, chi, svd_reltol=svd_reltol,
                                      eps_multiplet=eps_multiplet)
            prof.append((direction, c, tuple(sorted(P.legs[-1].charges))))
    return tuple(prof)


def _prof_dict(profiles):
    return {(d, c): dict(kp) for d, c, kp in profiles}


def _move_raw(direction, state, env, keeps, ad_decomp_reg=1.0e-12, out_like=True, timers=None):
    """A frozen directional move up to its epilogue: per site, in
    :func:`target_slots` order, the raw ``(nC1, nC2, nT)``, laid out in the
    block sets of their env slots (when ``out_like``; else as produced)."""
    P, Pt = {}, {}
    for c in state.sites:
        P[c], Pt[c] = _projectors_fixed(direction, c, state, env, keeps[(direction, c)],
                                        ad_decomp_reg, timers)
    absorb = _ABSORB[direction]
    out = []
    for c, k1, k2, kt in target_slots(direction, state):
        like = dict(nC1=env.C[k1], nC2=env.C[k2], nT=env.T[kt]) if out_like else None
        with _phase(timers, "absorb", state.sites[c].device):
            out.extend(absorb(c, state, env, P, Pt, like))
    return out


class FrozenLayout:
    """The flat layout of a closed environment: the keys ``("C", k)`` in sorted
    order, then ``("T", k)``, each tensor's block set at its offset; the
    segment tables of the directional moves' outputs (cached)."""

    def __init__(self, state, env: ENV_ABELIAN):
        self.state = state
        self.keys = [("C", k) for k in sorted(env.C)] + [("T", k) for k in sorted(env.T)]
        self.like = {gk: (env.C if gk[0] == "C" else env.T)[gk[1]] for gk in self.keys}
        sizes = [self.like[gk].struct.numel for gk in self.keys]
        off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.offset = {gk: int(o) for gk, o in zip(self.keys, off)}
        self.numel = int(off[-1])
        self.numel_C = int(sum(s for gk, s in zip(self.keys, sizes) if gk[0] == "C"))
        self._seg = {}

    def flat(self, env: ENV_ABELIAN) -> torch.Tensor:
        """The env's tensors concatenated (differentiable)."""
        return torch.cat([(env.C if g == "C" else env.T)[k].data for g, k in self.keys])

    def env(self, X) -> ENV_ABELIAN:
        """The env over the flat ``X``: every tensor a view."""
        out = ENV_ABELIAN(None)
        for gk in self.keys:
            t = self.like[gk]
            o = self.offset[gk]
            (out.C if gk[0] == "C" else out.T)[gk[1]] = AbelianTensor._flat(
                t, t.struct, X[o:o + t.struct.numel])
        return out

    def segments(self, direction, device):
        """The :class:`~tpeps_torch.kernels.frozen_generic.SegmentTable` of a
        directional move's outputs (:func:`_move_raw` order)."""
        key = (tuple(direction), str(device))
        if key not in self._seg:
            outs = []
            for _, k1, k2, kt in target_slots(direction, self.state):
                for gk in (("C", k1), ("C", k2), ("T", kt)):
                    outs.append((self.offset[gk], self.like[gk].struct.sizes))
            self._seg[key] = segment_table(outs, device)
        return self._seg[key]


class _Epilogue(torch.autograd.Function):
    """A move's epilogue on the flat env: forward ``generic_epilogue`` into a
    copy of ``X``, backward ``generic_epilogue_vjp`` (the written slots take
    no gradient from ``X``)."""

    @staticmethod
    def forward(ctx, raw, X, seg, sg_norm):
        raw = raw.detach()
        out = X.detach().clone()
        generic_epilogue(raw, seg, out)
        ctx.save_for_backward(raw)
        ctx.seg, ctx.sg_norm = seg, sg_norm
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (raw,) = ctx.saved_tensors
        g = g.contiguous()
        graw = generic_epilogue_vjp(raw, g, ctx.seg, ctx.sg_norm)
        gX = g.clone()
        for _, do, n, _, _ in ctx.seg.host.tolist():
            gX[do:do + n] = 0
        return graw, gX, None, None


def move_frozen_flat(direction, state, layout: FrozenLayout, X, keeps, ad_decomp_reg=1.0e-12,
                     sg_norm=True):
    """One frozen directional move on the flat env ``X``; differentiable in
    the state's sites and ``X``."""
    raws = _move_raw(direction, state, layout.env(X), keeps, ad_decomp_reg)
    raw = torch.cat([r.data for r in raws])
    return _Epilogue.apply(raw, X, layout.segments(direction, X.device), sg_norm)


def ctm_move_frozen(direction, state, env: ENV_ABELIAN, keeps, ad_decomp_reg: float = 1.0e-12,
                    sg_norm: bool = True):
    """One frozen directional move for every site (the JAX package's
    ``ctm_move_frozen``): each output normalized by its own max and written
    onto the input env's block set, which must hold every block the move
    produces (:func:`close_structure_generic`).  ``sg_norm`` detaches the
    scales."""
    layout = FrozenLayout(state, env)
    X = move_frozen_flat(direction, state, layout, layout.flat(env), keeps, ad_decomp_reg,
                         sg_norm)
    return layout.env(X)


def _sweeps(state, layout, X0, keeps, dirs, max_iter, conv_tol, ad_decomp_reg, timers=None):
    """The sweep loop from the flat ``X0``: ``(S, n_sweeps, dist2)``."""
    st = sweep_state(X0.detach(), max_iter, conv_tol)
    W = X0.detach().clone()
    W_env = layout.env(W)
    while not bool(st.ctl[1]):
        for d in dirs:
            raws = _move_raw(d, state, W_env, keeps, ad_decomp_reg, timers=timers)
            with _phase(timers, "epilogue", W.device):
                generic_epilogue(torch.cat([r.data for r in raws]), layout.segments(d, W.device),
                                 W)
        with _phase(timers, "epilogue", W.device):
            sweep_commit(st, W)
    return st.S, int(st.ctl[0]), float(st.dist2)


def run_frozen_generic(state, env: ENV_ABELIAN, keeps, move_seq=MOVE_SEQ, max_iter: int = 100,
                       conv_tol: float = 1.0e-9, ad_decomp_reg: float = 1.0e-12, timers=None):
    """Frozen sweeps to the elementwise fixed point from a closed env: each
    directional move's outputs go into the working env by
    ``generic_epilogue``; each sweep ends with ``sweep_commit`` and one 4-byte
    read of ``done``.

    :param timers: optional :class:`~tpeps_torch.profiling.PhaseTimers`; gets
        the phases "halves", "decomposition", "absorb" and "epilogue"
    :return: ``(env*, n_sweeps, dist2)``
    """
    layout = FrozenLayout(state, env)
    S, n, d2 = _sweeps(state, layout, layout.flat(env), dict(keeps),
                       sweep_directions(state, move_seq), max_iter, conv_tol, ad_decomp_reg,
                       timers)
    return layout.env(S), n, d2


def _triples(raws):
    return zip(*[iter(raws)] * 3)


def _prime_sweep(state, env: ENV_ABELIAN, keeps, dirs, ad_decomp_reg):
    """One sweep of frozen moves whose outputs replace their slots as
    produced (normalized, block sets and chi legs those of the profiles)."""
    for d in dirs:
        raws = _move_raw(d, state, env, keeps, ad_decomp_reg, out_like=False)
        out = env.clone()
        for (_, k1, k2, kt), (r1, r2, rt) in zip(target_slots(d, state), _triples(raws)):
            for grp, k, r in ((out.C, k1, r1), (out.C, k2, r2), (out.T, kt, rt)):
                grp[k] = r * (1.0 / r.max_abs())
        env = out
    return env


def close_structure_generic(state, env: ENV_ABELIAN, keeps, move_seq=MOVE_SEQ, n_max: int = 8,
                            ad_decomp_reg: float = 1.0e-12):
    """The warm start of the frozen sweep: ``env`` with its block sets grown
    until a frozen sweep maps them into themselves.  The sweep runs on
    ``meta`` tensors (plans, no data, no launch), as the JAX package runs it
    under ``jax.eval_shape``; missing blocks are filled with zeros.  The JAX
    package's frozen move instead drops what falls outside the input sets
    (after it entered the scales), so a warning says when a set grows.

    Where the profiles give another chi leg than ``env`` holds (a dynamic run
    stopped before its profile settled, where the JAX package's loop cannot
    run), frozen sweeps with free block sets first carry ``env`` to the
    profiles' legs, with a warning."""
    keeps = dict(keeps)
    dirs = sweep_directions(state, move_seq)
    with torch.no_grad():
        sites_m = {c: a.to("meta") for c, a in state.sites.items()}
        st_m = type(state)(state.sym, sites_m, state.vertexToSite, state.lX, state.lY)
        C, T = dict(env.C), dict(env.T)
        grown, primed = False, 0
        for _ in range(n_max):
            grew = off_profile = False
            cur = ENV_ABELIAN(env.chi, {k: t.to("meta") for k, t in C.items()},
                              {k: t.to("meta") for k, t in T.items()})
            for d in dirs:
                raws = _move_raw(d, st_m, cur, keeps, out_like=False)
                nxt = cur.clone()
                for (_, k1, k2, kt), (r1, r2, rt) in zip(target_slots(d, st_m), _triples(raws)):
                    for grp, full, k, r in ((nxt.C, C, k1, r1), (nxt.C, C, k2, r2),
                                            (nxt.T, T, kt, rt)):
                        off_profile |= r.legs != full[k].legs
                        if not off_profile and not set(r.struct.keys) <= set(full[k].struct.keys):
                            full[k] = _grown(full[k], r)
                            grew = True
                        grp[k] = full[k].to("meta")
                if off_profile:
                    break
                cur = nxt
            if off_profile:
                e = _prime_sweep(state, ENV_ABELIAN(env.chi, C, T), keeps, dirs, ad_decomp_reg)
                C, T = dict(e.C), dict(e.T)
                primed += 1
                continue
            if not grew:
                if primed:
                    warnings.warn(f"close_structure_generic: the environment's chi legs were "
                                  f"not the frozen profiles'; {primed} frozen sweep(s) carried "
                                  "it there (ROADMAP, Queue 3)")
                if grown:
                    warnings.warn("close_structure_generic grew the environment's block sets: "
                                  "the frozen sweep differs from the JAX package's here "
                                  "(ROADMAP, Queue 3)")
                return ENV_ABELIAN(env.chi, C, T)
            grown = True
    raise RuntimeError("generic abelian env structure failed to close")


def _sign_alignment(x, y, layout, conv_tol):
    """``sign(y) * sign(x)`` per element, 1 where ``|x|`` is below ``ALIGN_REL``
    or ``conv_tol`` times its tensor's max (the signs the iteration leaves
    undetermined); None where it is 1 throughout."""
    r = torch.ones_like(x)
    rel = max(ALIGN_REL, conv_tol)
    for gk in layout.keys:
        o, n = layout.offset[gk], layout.like[gk].struct.numel
        xs, ys = x[o:o + n], y[o:o + n]
        if n:
            r[o:o + n] = torch.where(xs.abs() < rel * xs.abs().max(), torch.ones_like(xs),
                                     torch.sign(ys) * torch.sign(xs))
    return None if bool((r == 1).all()) else r


class _Sites:
    """The state's site tensors over one flat buffer (the parameters of the
    adjoint), in ``state.sites`` order."""

    def __init__(self, state):
        self.state = state
        self.coords = list(state.sites)
        sizes = [state.sites[c].struct.numel for c in self.coords]
        self.off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def flat(self):
        return torch.cat([self.state.sites[c].data for c in self.coords])

    def state_of(self, a):
        s = self.state
        sites = {c: AbelianTensor._flat(s.sites[c], s.sites[c].struct,
                                        a[self.off[i]:self.off[i + 1]])
                 for i, c in enumerate(self.coords)}
        return type(s)(s.sym, sites, s.vertexToSite, s.lX, s.lY)


class _ConvergeClosed(torch.autograd.Function):
    """The flat env of the frozen fixed point from a closed warm start, with
    the implicit adjoint as backward (the sites' flat buffer is the one input
    that takes a gradient)."""

    @staticmethod
    def forward(ctx, a_data, sites, layout, X0, keeps, dirs, opts, stats):
        a_data = a_data.detach()
        state = sites.state_of(a_data)
        t0 = time.perf_counter()
        Xf, n, d2 = _sweeps(state, layout, X0, keeps, dirs, opts["max_iter"], opts["conv_tol"],
                            opts["ad_decomp_reg"])
        # one more sweep from the fixed point: the env before each move (where
        # the backward rebuilds that move's graph) and, without an
        # elementwise fixed point, R from its end
        xs = [Xf]
        for d in dirs:
            xs.append(move_frozen_flat(d, state, layout, xs[-1], keeps, opts["ad_decomp_reg"],
                                       False))
        R = None
        if d2 > opts["conv_tol"] ** 2:
            R = _sign_alignment(Xf, xs[-1], layout, opts["conv_tol"])
        ctx.sites, ctx.layout, ctx.keeps, ctx.dirs, ctx.opts = sites, layout, keeps, dirs, opts
        ctx.stats, ctx.R, ctx.a, ctx.xs = stats, R, a_data, xs[:-1]
        if stats is not None:
            stats.update(forward_sweeps=n, forward_dist2=d2, sign_aligned=R is not None,
                         forward_seconds=time.perf_counter() - t0)
        return Xf

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        sites, layout, keeps, dirs, opts = ctx.sites, ctx.layout, ctx.keeps, ctx.dirs, ctx.opts
        t0 = time.perf_counter()
        g = g.detach().contiguous()
        a = ctx.a
        reg = opts["ad_decomp_reg"]
        nC = layout.numel_C
        st = adjoint_state(a, g[:nC], g[nC:], opts["adjoint_max_iter"], opts["adjoint_tol"])
        u = g
        while not bool(st.ctl[1]):
            v = u if ctx.R is None else u * ctx.R
            da = torch.zeros_like(a)
            for d, x in reversed(list(zip(dirs, ctx.xs))):  # one move's graph at a time
                leaves = (a.clone().requires_grad_(), x.clone().requires_grad_())
                with torch.enable_grad():
                    y = move_frozen_flat(d, sites.state_of(leaves[0]), layout, leaves[1], keeps,
                                         reg, False)
                ga, v = torch.autograd.grad(y, leaves, v, allow_unused=True)
                if ga is not None:
                    da += ga
                v = torch.zeros_like(g) if v is None else v.contiguous()
            adjoint_commit(st, da, v[:nC], v[nC:])
            u = v
        i, diverged = (int(x) for x in st.ctl[[0, 5]].tolist())
        if diverged:
            print(f"tpeps_torch: frozen generic abelian adjoint diverging (iter {i}, "
                  f"|u|^2={float(st.scal[0])}); gradient truncated", flush=True)
        if ctx.stats is not None:
            ctx.stats.update(adjoint_iters=i, adjoint_diverged=bool(diverged),
                             adjoint_delta=float(st.scal[0]),
                             adjoint_seconds=time.perf_counter() - t0)
        return st.da, None, None, None, None, None, None, None


def make_converge_frozen_generic(state, chi, profiles, move_seq, max_iter, conv_tol,
                                 ad_decomp_reg, adjoint_max_iter=ADJOINT_MAX_ITER,
                                 adjoint_tol=ADJOINT_TOL):
    """The converged generic abelian environment as a function of the sites
    (the JAX package's custom-VJP ``converge``): ``converge(sites, env,
    stats=None) -> ENV_ABELIAN`` from a closed warm start ``env``
    (:func:`close_structure_generic`), differentiable in the sites' blocks by
    the implicit adjoint; ``state`` gives the cell's geometry.

    ``stats``: optional dict; gets the forward's sweeps and distance and its
    host seconds (the extra sweep that stores the backward's envs
    included), whether ``R != 1``, and after a backward the adjoint's iterations, whether it diverged, its last
    ``|u|^2`` and its host seconds.
    """
    keeps = _prof_dict(profiles)
    dirs = sweep_directions(state, move_seq)
    opts = dict(max_iter=max_iter, conv_tol=conv_tol, ad_decomp_reg=ad_decomp_reg,
                adjoint_max_iter=adjoint_max_iter, adjoint_tol=adjoint_tol)
    layouts = {}

    def converge(sites, env: ENV_ABELIAN, stats=None):
        st = type(state)(state.sym, sites, state.vertexToSite, state.lX, state.lY)
        sig = tuple((g, k, (env.C if g == "C" else env.T)[k].struct)
                    for g in "CT" for k in sorted(env.C if g == "C" else env.T))
        layout = layouts.get(sig)
        if layout is None:
            layouts.clear()
            layout = layouts[sig] = FrozenLayout(st, env)
        sp = _Sites(st)
        a_data = sp.flat()
        X0 = layout.flat(env).detach()
        if not (torch.is_grad_enabled() and a_data.requires_grad):
            Xf, n, d2 = _sweeps(st, layout, X0, keeps, dirs, max_iter, conv_tol, ad_decomp_reg)
            if stats is not None:
                stats.update(forward_sweeps=n, forward_dist2=d2)
            return layout.env(Xf.clone())
        Xf = _ConvergeClosed.apply(a_data, sp, layout, X0, keeps, dirs, opts, stats)
        return layout.env(Xf)

    return converge


def converge_frozen_generic(state, env: ENV_ABELIAN, profiles=None, move_seq=MOVE_SEQ,
                            max_iter: int = 100, conv_tol: float = 1.0e-9,
                            ad_decomp_reg: float = 1.0e-12,
                            adjoint_max_iter: int = ADJOINT_MAX_ITER,
                            adjoint_tol: float = ADJOINT_TOL):
    """Converged generic abelian environment from a warm (dynamic) env:
    profiles (``freeze_profiles`` by default), ``close_structure_generic``,
    the frozen fixed point; gradients flow into the state's site blocks."""
    if profiles is None:
        profiles = freeze_profiles(state, env, env.chi)
    env = close_structure_generic(state, env, _prof_dict(profiles), move_seq)
    fn = make_converge_frozen_generic(state, env.chi, profiles, move_seq, max_iter, conv_tol,
                                      ad_decomp_reg, adjoint_max_iter, adjoint_tol)
    return fn(dict(state.sites), env)
