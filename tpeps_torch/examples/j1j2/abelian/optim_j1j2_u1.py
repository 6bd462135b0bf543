"""Gradient optimization of a U(1) bipartite 2-site iPEPS for the J1-J2 model,
on PyTorch (counterpart of examples/j1j2/abelian/optim_j1j2_u1.py): per epoch
a dynamic generic abelian CTMRG without a graph fixes the per-(direction,
site) chi profiles, and the gradient comes from the implicit adjoint of the
frozen sweep's fixed point.

    python -m tpeps_torch.examples.j1j2.abelian.optim_j1j2_u1 \\
        --instate <abelian_2site_state.json> --chi 24 --j2 0.0 \\
        --instate_noise 0.1 --opt_max_iter 30

It takes the JAX script's flags; ``--instate`` is required and
``--CTMARGS_ctm_max_iter`` counts sweeps (dynamic and frozen).  The noise
comes from a ``torch.Generator`` seeded with ``--seed`` (site after site in
sorted order), so it differs from the JAX script's.  The best state goes to
``<out_prefix>_state.json`` in the abelian JSON format that both packages
read; the ``FINAL`` line is measured with the dynamic engine.  The run is on
the card unless ``--GLOBALARGS_device cpu``.
"""

from __future__ import annotations

import sys

import torch

from tpeps_torch.config import configure, get_args_parser
from tpeps_torch.ctm.generic_abelian import ctmrg as ctmrg_g
from tpeps_torch.ctm.generic_abelian import env as env_g
from tpeps_torch.ipeps.ipeps_abelian import IPEPS_ABELIAN, add_noise_abelian, bipartite
from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
from tpeps_torch.optim.abelian import optimize_generic_abelian
from tpeps_torch.sym.io import read_ipeps_abelian, write_ipeps_abelian


def make_parser():
    parser = get_args_parser()
    parser.add_argument("--j1", type=float, default=1.0, help="nearest-neighbour coupling")
    parser.add_argument("--j2", type=float, default=0.0, help="next nearest-neighbour coupling")
    return parser


def main(argv=None, grad_stats=None):
    """Run the example; returns ``(final energy, history)``.

    :param grad_stats: optional list; gets one dict per gradient evaluation
        (see :func:`~tpeps_torch.optim.abelian.optimize_generic_abelian`)
    """
    args, unknown_args = make_parser().parse_known_args(argv)
    if unknown_args:
        raise SystemExit(f"args not recognized: {unknown_args}")
    cfg = configure(args)
    if cfg.main.instate is None:
        raise ValueError("--instate is required (as in the reference example)")
    device = cfg.global_args.torch_device
    model = J1J2_ABELIAN(j1=args.j1, j2=args.j2, dtype=cfg.global_args.torch_dtype,
                         device=device)
    state = read_ipeps_abelian(cfg.main.instate, vertexToSite=bipartite, device=device)
    if cfg.main.instate_noise:
        gen = torch.Generator(device=device).manual_seed(cfg.main.seed)
        sites = {}
        for c in sorted(state.sites):
            a = add_noise_abelian(state.sites[c], gen, cfg.main.instate_noise)
            sites[c] = a * (1.0 / float(a.norm()))
        state = IPEPS_ABELIAN(state.sym, sites, vertexToSite=bipartite, lX=state.lX,
                              lY=state.lY)

    def obs_fn(params, ctx):
        print(f"epoch {ctx['epoch']}: e = {ctx['loss']:.12f}", flush=True)

    def best_state_writer(params, loss):
        write_ipeps_abelian(state.set_parameters(params), cfg.main.out_prefix + "_state.json")

    best_state, history = optimize_generic_abelian(
        state, model.energy_per_site, cfg, obs_fn=obs_fn, best_state_writer=best_state_writer,
        grad_stats=grad_stats)

    # the final measurement through the dynamic engine
    with torch.no_grad():
        env, _ = ctmrg_g.run(best_state, env_g.init_env(best_state, cfg.main.chi), cfg.ctm)
        e = float(model.energy_per_site(best_state, env))
    obs_values, obs_labels = model.eval_obs(best_state, env)
    print(", ".join(["epoch", "energy"] + obs_labels))
    print(", ".join(["FINAL", f"{e}"] + [str(v) for v in obs_values]))
    return e, history


if __name__ == "__main__":
    main(sys.argv[1:])
