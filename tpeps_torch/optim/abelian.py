"""Gradient optimization of a 1-site C4v abelian (U(1)/Z2) iPEPS
(counterpart of ``optimize_c4v_abelian`` in tpeps/optim/abelian.py).

Per epoch the context is refreshed without a graph: the dynamic C4v abelian
CTMRG from ``init_env`` (its global cut finds the per-sector chi profile),
the profile frozen, and the warm ``(C, T)`` closed under the frozen move.
The L-BFGS closure then differentiates the frozen fixed point by its
implicit adjoint (:func:`tpeps_torch.ctm.c4v_abelian.frozen.converge_closed`)
and evaluates the energy on the bipartite view.  The variational parameters
are the site's flat block buffer, so :func:`optimize_state` takes them as one
tensor.  ``optimize_generic_abelian`` waits for the generic abelian engine.
"""

from __future__ import annotations

import warnings

import torch

from ..ctm.c4v_abelian import ctmrg as ctmrg_c4v
from ..ctm.c4v_abelian import env as env_c4v
from ..ctm.c4v_abelian.frozen import close_structure, converge_closed, freeze_from_env
from ..ipeps.ipeps_abelian import IPEPS_ABELIAN, make_c4v_symm_A1_abelian
from ..sym.tensor import AbelianTensor
from .driver import optimize_state


def c4v_abelian_losses(state, energy_f, cfg, site_of_params=None, symmetrize=True,
                       grad_stats=None):
    """The pieces of :func:`optimize_c4v_abelian`'s closure: ``(params0,
    loss_ctx_fn, loss_fn, sym_site)`` with ``loss_ctx_fn(params) -> ctx`` (run
    without a graph), ``loss_fn(params, ctx) -> loss`` (differentiable) and
    ``sym_site(params) -> AbelianTensor`` (see there for the arguments)."""
    chi = cfg.main.chi
    sym = state.sym
    ctm_cfg = cfg.ctm
    site0 = state.site((0, 0))
    warned = [False]

    if site_of_params is None:
        def site_of_params(params):
            return AbelianTensor._flat(site0, site0.struct, params)

    def sym_site(params):
        a = site_of_params(params)
        return make_c4v_symm_A1_abelian(a) if symmetrize else a

    def loss_ctx_fn(params):
        """The epoch's context: dynamic CTMRG without a graph, the frozen
        profile, the closed warm start."""
        a = sym_site(params)
        a = a * (1.0 / a.norm())
        st = IPEPS_ABELIAN(sym, {(0, 0): a})
        env, _ = ctmrg_c4v.run(st, env_c4v.init_env(st, chi), ctm_cfg)
        keep = freeze_from_env(env)
        C0, T0 = close_structure(a, env.C, env.T, dict(keep))
        if not warned[0] and (C0.struct is not env.C.struct or T0.struct is not env.T.struct):
            warnings.warn("close_structure grew the environment's block sets: the frozen "
                          "move differs from the JAX package's here (ROADMAP, Queue 3)")
            warned[0] = True
        return keep, C0, T0

    def loss_fn(params, ctx):
        keep, C0, T0 = ctx
        A = sym_site(params)
        A = A * (1.0 / A.norm())
        stats = None
        if grad_stats is not None and torch.is_grad_enabled():
            stats = {}
            grad_stats.append(stats)
        Cf, Tf = converge_closed(A, C0, T0, keep, max_iter=ctm_cfg.ctm_max_iter,
                                 conv_tol=ctm_cfg.ctm_conv_tol,
                                 ad_decomp_reg=ctm_cfg.ad_decomp_reg, stats=stats)
        st_bp, eg = env_c4v.as_generic(IPEPS_ABELIAN(sym, {(0, 0): A}),
                                       env_c4v.ENV_C4V_ABELIAN(chi, Cf, Tf))
        return energy_f(st_bp, eg)

    return site0.data.detach().clone(), loss_ctx_fn, loss_fn, sym_site


def optimize_c4v_abelian(state, energy_f, cfg, obs_fn=None, best_state_writer=None,
                         opt_resume=None, params0=None, site_of_params=None, symmetrize=True,
                         grad_stats=None):
    """Optimize a 1-site C4v abelian state.

    :param state: :class:`IPEPS_ABELIAN` with the uniform +1 signature (C4v
        convention); its flat block buffer is the variational parameters
    :param energy_f: ``(state_bp, env_generic) -> scalar`` on the
        :func:`~tpeps_torch.ctm.c4v_abelian.env.as_generic` bipartite view
    :param cfg: :class:`tpeps_torch.config.Config`
    :param params0: optional parameters replacing the site's buffer (requires
        ``site_of_params``)
    :param site_of_params: optional differentiable ``params -> AbelianTensor``;
        by default the site's structure over the flat ``params``
    :param symmetrize: apply the A1 projector to the site inside the loss
    :param grad_stats: optional list; each gradient evaluation appends the
        dict that ``converge_closed`` fills (forward moves and distance,
        ``R != 1``, adjoint iterations and divergence)
    :return: ``(best_state, history)``

    The backtracking line search (``--OPTARGS_line_search backtracking``)
    evaluates the same loss without a graph from the epoch's context (the
    JAX function passes no line-search closure).  If ``close_structure``
    grows a block set, a warning says so once: the port then differs from
    the JAX package, whose ``close_structure`` keeps the sets (ROADMAP).
    """
    p0, loss_ctx_fn, loss_fn, sym_site = c4v_abelian_losses(
        state, energy_f, cfg, site_of_params, symmetrize, grad_stats)
    ctx_now = [None]

    def epoch_ctx(params):
        ctx_now[0] = loss_ctx_fn(params)
        return ctx_now[0]

    def loss_fn_linesearch(params):
        return loss_fn(params, ctx_now[0])

    best, history = optimize_state(
        p0 if params0 is None else params0, loss_fn, cfg=cfg, loss_ctx_fn=epoch_ctx,
        loss_fn_linesearch=loss_fn_linesearch, obs_fn=obs_fn,
        best_state_writer=best_state_writer, opt_resume=opt_resume)
    with torch.no_grad():
        a_best = sym_site(best)
        a_best = a_best * (1.0 / a_best.norm())
    if isinstance(history, dict):
        history["best_params"] = best
    return IPEPS_ABELIAN(state.sym, {(0, 0): a_best}), history
