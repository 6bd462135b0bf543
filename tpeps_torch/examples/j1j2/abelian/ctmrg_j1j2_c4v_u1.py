"""Observables of a stored U(1) C4v iPEPS through the C4v abelian CTMRG, on
PyTorch (counterpart of examples/j1j2/abelian/ctmrg_j1j2_c4v_u1.py): load a
1-site C4v block-sparse U(1) state, converge the single-(C, T) environment,
print the energy and the observables.

    python -m tpeps_torch.examples.j1j2.abelian.ctmrg_j1j2_c4v_u1 \\
        --instate <abelian_c4v_state.json> --chi 36 --j2 0.1

It takes the JAX script's flags.  The run is on the card unless
``--GLOBALARGS_device cpu``.  A random state file comes from
:func:`tpeps_torch.ipeps.ipeps_abelian.random_c4v_abelian` and
:func:`tpeps_torch.sym.io.write_ipeps_abelian` (README).
"""

from __future__ import annotations

import sys

from tpeps_torch.config import configure, get_args_parser
from tpeps_torch.ctm.c4v_abelian import ctmrg as ctmrg_c4v
from tpeps_torch.ctm.c4v_abelian import env as env_c4v
from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
from tpeps_torch.sym.io import read_ipeps_abelian


def make_parser():
    parser = get_args_parser()
    parser.add_argument("--j1", type=float, default=1.0, help="nearest-neighbour coupling")
    parser.add_argument("--j2", type=float, default=0.0, help="next nearest-neighbour coupling")
    return parser


def main(argv=None, stats=None):
    """Run the example; returns ``(energy, obs_values, obs_labels)``.

    :param stats: optional list; gets one dict per CTMRG move (its chi profile)
    """
    args, unknown_args = make_parser().parse_known_args(argv)
    if unknown_args:
        raise SystemExit(f"args not recognized: {unknown_args}")
    cfg = configure(args)
    device = cfg.global_args.torch_device
    model = J1J2_ABELIAN(j1=args.j1, j2=args.j2, dtype=cfg.global_args.torch_dtype,
                         device=device)
    state = read_ipeps_abelian(cfg.main.instate, device=device)
    print(state)

    env = env_c4v.init_env(state, cfg.main.chi)
    env, history = ctmrg_c4v.run(state, env, cfg.ctm, stats=stats)

    state_bp, env_g = env_c4v.as_generic(state, env)
    e = float(model.energy_per_site(state_bp, env_g))
    obs_values, obs_labels = model.eval_obs(state_bp, env_g)
    print(", ".join(["epoch", "energy"] + obs_labels))
    print(", ".join(["FINAL", f"{e}"] + [str(v) for v in obs_values]))
    return e, obs_values, obs_labels


if __name__ == "__main__":
    main(sys.argv[1:])
