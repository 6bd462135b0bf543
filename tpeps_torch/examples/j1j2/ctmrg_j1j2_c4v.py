"""Observables of a stored or random J1-J2 C4v iPEPS through C4v CTMRG on
PyTorch (counterpart of examples/j1j2/ctmrg_j1j2_c4v.py):

    python -m tpeps_torch.examples.j1j2.ctmrg_j1j2_c4v --instate state.json \\
        --bond_dim 2 --chi 16 --j2 0.3 --corrf_r 4 --top_n 4

It converges the one-site environment (SYMEIG), prints the energy and the
observables, the spin-spin correlations ``SS r=1..corrf_r+1`` when
``--corrf_r`` > 1 and the ``--top_n`` leading eigenvalues of the width-1
transfer operator (normalized, re and im) when ``--top_n`` > 0.  It takes
the JAX script's flags and runs on the card unless ``--GLOBALARGS_device
cpu``.
"""

from __future__ import annotations

import sys

from tpeps_torch.config import configure, get_args_parser
from tpeps_torch.ctm.c4v.transferops import get_Top_spec_c4v
from tpeps_torch.examples.optim_common_c4v import ctmrg_c4v, initial_site_c4v
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE


def make_parser():
    parser = get_args_parser()
    parser.add_argument("--j1", type=float, default=1.0, help="nearest-neighbour coupling")
    parser.add_argument("--j2", type=float, default=0.0, help="next nearest-neighbour coupling")
    parser.add_argument("--j3", type=float, default=0.0,
                        help="next-to-next nearest-neighbour coupling")
    parser.add_argument("--hz_stag", type=float, default=0.0, help="staggered mag. field")
    parser.add_argument("--delta_zz", type=float, default=1.0, help="easy-axis NN anisotropy")
    parser.add_argument("--corrf_r", type=int, default=1,
                        help="largest distance of the spin-spin correlations")
    parser.add_argument("--top_n", type=int, default=0,
                        help="number of transfer-operator eigenvalues")
    return parser


def main(argv=None):
    """:return: ``(energy, obs_values, obs_labels, out)`` with ``out`` the
    correlations (``"ss"``, r = 1..corrf_r+1) and the spectrum (``"top"``, an
    (n, 2) array) when asked for"""
    args, unknown_args = make_parser().parse_known_args(argv)
    if unknown_args:
        raise SystemExit(f"args not recognized: {unknown_args}")
    cfg = configure(args)
    model = J1J2_C4V_BIPARTITE(j1=args.j1, j2=args.j2, j3=args.j3, hz_stag=args.hz_stag,
                               delta_zz=args.delta_zz, dtype=cfg.global_args.torch_dtype,
                               device=cfg.global_args.torch_device)
    A0 = initial_site_c4v(cfg, model.phys_dim)
    e, a, env, obs_values, obs_labels = ctmrg_c4v(cfg, model, model.energy_1x1_lowmem, A0)
    out = {}
    if args.corrf_r > 1:
        out["ss"] = model.eval_corrf_SS(a, env, args.corrf_r)["ss"].cpu()
        for i, v in enumerate(out["ss"].tolist()):
            print(f"SS r={i + 1} {v}")
    if args.top_n > 0:
        out["top"] = get_Top_spec_c4v(args.top_n, a, env)
        for i, (re, im) in enumerate(out["top"]):
            print(f"{i} {float(re)} {float(im)}")
    return e, obs_values, obs_labels, out


if __name__ == "__main__":
    main(sys.argv[1:])
