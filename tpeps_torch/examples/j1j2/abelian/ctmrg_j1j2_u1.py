"""Observables of a stored U(1) J1-J2 iPEPS of a generic unit cell through the
generic abelian CTMRG, on PyTorch (counterpart of
examples/j1j2/abelian/ctmrg_j1j2_u1.py): load a block-sparse U(1) state with a
tiling, converge its environment, print the energy and the observables.

    python -m tpeps_torch.examples.j1j2.abelian.ctmrg_j1j2_u1 \\
        --instate <abelian_state.json> --chi 32 --tiling BIPARTITE

It takes the JAX script's flags; ``--CTMARGS_ctm_max_iter`` counts sweeps.
The run is on the card unless ``--GLOBALARGS_device cpu``.
"""

from __future__ import annotations

import sys

from tpeps_torch.config import configure, get_args_parser
from tpeps_torch.ctm.generic_abelian.ctmrg import run
from tpeps_torch.ctm.generic_abelian.env import init_env
from tpeps_torch.ipeps.ipeps_abelian import bipartite
from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
from tpeps_torch.sym.io import read_ipeps_abelian


def lattice_to_site_fn(tiling):
    """The tilings of the JAX script: BIPARTITE, 2SITE, 4SITE."""
    if tiling == "BIPARTITE":
        return bipartite
    if tiling == "2SITE":
        def f(coord):
            return ((coord[0] + abs(coord[0]) * 2) % 2, 0)
    elif tiling == "4SITE":
        def f(coord):
            return ((coord[0] + abs(coord[0]) * 2) % 2, (coord[1] + abs(coord[1]) * 2) % 2)
    else:
        raise ValueError(f"Invalid tiling: {tiling}")
    return f


def make_parser():
    parser = get_args_parser()
    parser.add_argument("--j1", type=float, default=1.0, help="nearest-neighbour coupling")
    parser.add_argument("--j2", type=float, default=0.0, help="next nearest-neighbour coupling")
    parser.add_argument("--tiling", default="BIPARTITE", help="BIPARTITE, 2SITE or 4SITE")
    return parser


def main(argv=None, stats=None):
    """Run the example; returns ``(energy, obs_values, obs_labels)``.

    :param stats: optional list; gets one dict per CTMRG sweep (seconds, chi
        profiles)
    """
    args, unknown_args = make_parser().parse_known_args(argv)
    if unknown_args:
        raise SystemExit(f"args not recognized: {unknown_args}")
    cfg = configure(args)
    device = cfg.global_args.torch_device
    model = J1J2_ABELIAN(j1=args.j1, j2=args.j2, dtype=cfg.global_args.torch_dtype,
                         device=device)
    state = read_ipeps_abelian(cfg.main.instate, vertexToSite=lattice_to_site_fn(args.tiling),
                               device=device)
    print(state)

    env = init_env(state, cfg.main.chi)
    env, history = run(state, env, cfg.ctm, stats=stats)

    e = float(model.energy_per_site(state, env))
    obs_values, obs_labels = model.eval_obs(state, env)
    print(", ".join(["epoch", "energy"] + obs_labels))
    print(", ".join(["FINAL", f"{e}"] + [str(v) for v in obs_values]))
    return e, obs_values, obs_labels


if __name__ == "__main__":
    main(sys.argv[1:])
