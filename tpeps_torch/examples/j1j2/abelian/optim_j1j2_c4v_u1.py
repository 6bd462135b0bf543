"""Gradient optimization of a U(1) C4v iPEPS for the J1-J2 model, on PyTorch
(counterpart of examples/j1j2/abelian/optim_j1j2_c4v_u1.py): per epoch a
dynamic CTMRG without a graph fixes the per-sector chi profile, and the
gradient comes from the implicit adjoint of the frozen fixed point.

    python -m tpeps_torch.examples.j1j2.abelian.optim_j1j2_c4v_u1 \\
        --instate <abelian_c4v_state.json> --chi 27 --j2 0.0 \\
        --instate_noise 0.1 --opt_max_iter 50

It takes the JAX script's flags; ``--instate`` is required.  The noise comes
from a ``torch.Generator`` seeded with ``--seed``, so it differs from the JAX
script's.  The best state goes to ``<out_prefix>_state.json`` in the abelian
JSON format that both packages read; the ``FINAL`` line is measured with the
dynamic engine.  The run is on the card unless ``--GLOBALARGS_device cpu``.
"""

from __future__ import annotations

import sys

import torch

from tpeps_torch.config import configure, get_args_parser
from tpeps_torch.ctm.c4v_abelian import ctmrg as ctmrg_c4v
from tpeps_torch.ctm.c4v_abelian import env as env_c4v
from tpeps_torch.ipeps.ipeps_abelian import (IPEPS_ABELIAN, add_noise_abelian,
                                             make_c4v_symm_A1_abelian)
from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
from tpeps_torch.optim.abelian import optimize_c4v_abelian
from tpeps_torch.sym.io import read_ipeps_abelian, write_ipeps_abelian
from tpeps_torch.sym.tensor import AbelianTensor


def make_parser():
    parser = get_args_parser()
    parser.add_argument("--j1", type=float, default=1.0, help="nearest-neighbour coupling")
    parser.add_argument("--j2", type=float, default=0.0, help="next nearest-neighbour coupling")
    return parser


def main(argv=None, grad_stats=None):
    """Run the example; returns ``(final energy, history)``.

    :param grad_stats: optional list; gets one dict per gradient evaluation
        (see :func:`~tpeps_torch.optim.abelian.optimize_c4v_abelian`)
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
    state = read_ipeps_abelian(cfg.main.instate, device=device)
    a = state.site((0, 0))
    if cfg.main.instate_noise:
        gen = torch.Generator(device=device).manual_seed(cfg.main.seed)
        a = add_noise_abelian(a, gen, cfg.main.instate_noise)
    a = make_c4v_symm_A1_abelian(a)
    a = a * (1.0 / float(a.norm()))
    state = IPEPS_ABELIAN(state.sym, {(0, 0): a})

    def obs_fn(params, ctx):
        print(f"epoch {ctx['epoch']}: e = {ctx['loss']:.12f}", flush=True)

    def best_state_writer(params, loss):
        site = make_c4v_symm_A1_abelian(AbelianTensor._flat(a, a.struct, params))
        write_ipeps_abelian(IPEPS_ABELIAN(state.sym, {(0, 0): site}),
                            cfg.main.out_prefix + "_state.json")

    best_state, history = optimize_c4v_abelian(
        state, model.energy_per_site, cfg, obs_fn=obs_fn, best_state_writer=best_state_writer,
        grad_stats=grad_stats)

    # the final measurement through the dynamic engine, independent of the
    # frozen profile used during the optimization
    with torch.no_grad():
        env, _ = ctmrg_c4v.run(best_state, env_c4v.init_env(best_state, cfg.main.chi), cfg.ctm)
        st_bp, eg = env_c4v.as_generic(best_state, env)
        e = float(model.energy_per_site(st_bp, eg))
    obs_values, obs_labels = model.eval_obs(st_bp, eg)
    print(", ".join(["epoch", "energy"] + obs_labels))
    print(", ".join(["FINAL", f"{e}"] + [str(v) for v in obs_values]))
    return e, history


if __name__ == "__main__":
    main(sys.argv[1:])
