"""Shared wiring of one-site C4v ground-state optimization (counterpart of
examples/optim_common_c4v.py): read-or-random C4v site -> loss closure
(symmetrize -> init_env -> converge_env -> energy) -> optimize_state ->
final observables from the best stored state.

The loss differentiates the reference-layout fixed point
(:func:`tpeps_torch.ctm.c4v.ctmrg.converge_env`).  The no-grad
environments converge with :func:`tpeps_torch.ctm.c4v.ctmrg.run_fixed_point`,
as the JAX script's do: the line search with
``--OPTARGS_line_search_svd_method`` (SYMEIG when DEFAULT), the per-epoch
observables and the final energy with SYMEIG.
"""

from __future__ import annotations

import torch

from ..ctm.c4v.ctmrg import converge_env, run_fixed_point
from ..ctm.c4v.env import init_env
from ..ipeps.ipeps_c4v import IPEPS_C4V, extend_bond_dim_c4v, read_ipeps_c4v, symmetrize_c4v
from ..optim.driver import optimize_state


def initial_site_c4v(cfg, phys_dim: int):
    """Initial C4v site tensor from ``--instate`` or random (uniform in
    [0, 1) from a ``torch.Generator`` seeded with ``--seed``), normalized,
    on ``cfg.global_args.torch_device``."""
    dev = cfg.global_args.torch_device
    gen = torch.Generator(device=dev).manual_seed(cfg.main.seed)
    if cfg.main.instate is not None:
        state = read_ipeps_c4v(cfg.main.instate, device=dev)
        if cfg.main.bond_dim > max(state.get_aux_bond_dims()):
            state = extend_bond_dim_c4v(state, cfg.main.bond_dim)
        state.add_noise(cfg.main.instate_noise, generator=gen)
        return state.site() / torch.linalg.vector_norm(state.site())
    if cfg.main.ipeps_init_type == "RANDOM":
        D = cfg.main.bond_dim
        A0 = torch.rand((phys_dim, D, D, D, D), generator=gen,
                        dtype=cfg.global_args.real_dtype, device=dev)
        return (A0 / torch.linalg.vector_norm(A0)).to(cfg.global_args.torch_dtype)
    raise ValueError("Missing trial state: provide --instate or --ipeps_init_type RANDOM")


def converge_c4v(cfg, a, projector_method=None):
    """Converged C4v environment without a graph, with ``projector_method``
    (``run_fixed_point``'s SYMEIG when None)."""
    env0 = init_env(a, cfg.main.chi, cfg.ctm.ctm_env_init_type)
    kwargs = {} if projector_method is None else {"projector_method": projector_method}
    env, *_ = run_fixed_point(a, env0, max_iter=cfg.ctm.ctm_max_iter,
                              conv_tol=cfg.ctm.ctm_conv_tol, **kwargs)
    return env


def optimize_c4v(cfg, model, energy_f, A0, obs_extra=None, grad_stats=None):
    """Run the canonical C4v optimization loop.

    :param energy_f: ``(a, env) -> scalar`` (differentiable)
    :param obs_extra: optional callback ``(a, env, epoch)`` run after the
        per-epoch observable line
    :param grad_stats: optional list; each gradient evaluation appends the
        dict that :func:`converge_env` fills (forward moves, adjoint
        iterations, divergence guard, seconds)
    :return: ``(final_energy, final_a, final_env, history)``
    """
    chi = cfg.main.chi
    ctm_cfg = cfg.ctm

    def loss_fn(p):
        a = symmetrize_c4v(p, normalize=True)
        env0 = init_env(a.detach(), chi, ctm_cfg.ctm_env_init_type)
        stats = None
        if grad_stats is not None:
            stats = {}
            grad_stats.append(stats)
        env = converge_env(a, env0, ctm_cfg, stats=stats)
        return energy_f(a, env)

    # the line search may use a cheaper projector (reference
    # OPTARGS_line_search_svd_method)
    ls_proj = (cfg.opt.line_search_svd_method
               if cfg.opt.line_search_svd_method != "DEFAULT" else None)

    def loss_fn_ng(p):
        a = symmetrize_c4v(p, normalize=True)
        return energy_f(a, converge_c4v(cfg, a, projector_method=ls_proj))

    outfile = cfg.main.out_prefix + "_state.json"

    def best_writer(p, loss):
        IPEPS_C4V(symmetrize_c4v(p, normalize=True)).write_to_file(outfile)

    def obs_fn(p, ctx):
        a = symmetrize_c4v(p, normalize=True)
        env = converge_c4v(cfg, a)
        obs_values, obs_labels = model.eval_obs(a, env)
        if ctx["epoch"] == 0:
            print(", ".join(["epoch", "energy"] + obs_labels))
        print(", ".join([str(ctx["epoch"]), f"{ctx['loss']}"] + [str(v) for v in obs_values]))
        if obs_extra is not None:
            obs_extra(a, env, ctx["epoch"])

    _, history = optimize_state(
        A0, loss_fn, cfg=cfg, loss_fn_linesearch=loss_fn_ng, obs_fn=obs_fn,
        best_state_writer=best_writer, checkpoint_file=cfg.main.out_prefix + "_checkpoint.p",
        opt_resume=cfg.main.opt_resume,
    )

    a = read_ipeps_c4v(outfile, device=cfg.global_args.torch_device).site()
    env = converge_c4v(cfg, a)
    with torch.no_grad():
        e_fin = float(energy_f(a, env))
    obs_values, _ = model.eval_obs(a, env)
    print(", ".join([f"{cfg.main.opt_max_iter}", f"{e_fin}"] + [str(v) for v in obs_values]))
    print(f"FINAL {e_fin}")
    return e_fin, a, env, history


def ctmrg_c4v(cfg, model, energy_f, A0=None):
    """Converged CTMRG and the observables of a stored or random C4v state.

    :return: ``(energy, a, env, obs_values, obs_labels)``
    """
    a = initial_site_c4v(cfg, model.phys_dim) if A0 is None else A0
    a = symmetrize_c4v(a, normalize=True)
    env = converge_c4v(cfg, a)
    with torch.no_grad():
        e = float(energy_f(a, env))
    obs_values, obs_labels = model.eval_obs(a, env)
    print(", ".join(["epoch", "energy"] + obs_labels))
    print(", ".join(["FINAL", f"{e}"] + [str(v) for v in obs_values]))
    return e, a, env, obs_values, obs_labels
