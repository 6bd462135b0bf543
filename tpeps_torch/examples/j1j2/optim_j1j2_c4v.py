"""Ground-state optimization of the J1-J2 model with a 1-site C4v iPEPS on
PyTorch (counterpart of examples/j1j2/optim_j1j2_c4v.py, README Ex. 1):

    python -m tpeps_torch.examples.j1j2.optim_j1j2_c4v --bond_dim 2 --chi 16 \\
        --j2 0.3 --seed 123 --opt_max_iter 100

It takes the JAX script's flags.  The run is on the card unless
``--GLOBALARGS_device cpu``.  Gradients cross the CTMRG loop by implicit
differentiation of the fixed point (default) or a checkpointed window of
moves (``--CTMARGS_grad_mode scan``); ``--CTMARGS_projector_svd_method
POWER`` puts the projector of the differentiated fixed point on the K3/K6
kernels, ``--OPTARGS_line_search_svd_method POWER`` that of the line
search; observables converge with SYMEIG.  With ``--top_freq N`` > 0, every
N-th epoch also prints ``TOP {"re": [...], "im": [...]}``, the ``--top_n``
leading eigenvalues of the width-1 transfer operator.  A random start comes
from a ``torch.Generator``, so it differs from the JAX script's for the same
seed.
"""

from __future__ import annotations

import json
import logging
import sys

from tpeps_torch.config import configure, get_args_parser
from tpeps_torch.ctm.c4v.transferops import get_Top_spec_c4v
from tpeps_torch.examples.optim_common_c4v import initial_site_c4v, optimize_c4v
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE


def make_parser():
    parser = get_args_parser()
    parser.add_argument("--j1", type=float, default=1.0, help="nearest-neighbour coupling")
    parser.add_argument("--j2", type=float, default=0.0, help="next nearest-neighbour coupling")
    parser.add_argument("--j3", type=float, default=0.0,
                        help="next-to-next nearest-neighbour coupling")
    parser.add_argument("--hz_stag", type=float, default=0.0, help="staggered mag. field")
    parser.add_argument("--delta_zz", type=float, default=1.0, help="easy-axis NN anisotropy")
    parser.add_argument("--top_freq", type=int, default=-1,
                        help="print the transfer-operator spectrum every top_freq epochs "
                        "(none when <= 0)")
    parser.add_argument("--top_n", type=int, default=2,
                        help="number of transfer-operator eigenvalues")
    return parser


def main(argv=None):
    args, unknown_args = make_parser().parse_known_args(argv)
    if unknown_args:
        raise SystemExit(f"args not recognized: {unknown_args}")
    cfg = configure(args)
    logging.basicConfig(level=logging.INFO,
                        filename=cfg.main.out_prefix + ".log"
                        if cfg.main.out_prefix != "output" else None)
    model = J1J2_C4V_BIPARTITE(j1=args.j1, j2=args.j2, j3=args.j3, hz_stag=args.hz_stag,
                               delta_zz=args.delta_zz, dtype=cfg.global_args.torch_dtype,
                               device=cfg.global_args.torch_device)
    A0 = initial_site_c4v(cfg, model.phys_dim)

    def top_spec(a, env, epoch):
        if args.top_freq > 0 and epoch % args.top_freq == 0:
            l = get_Top_spec_c4v(args.top_n, a, env)
            print("TOP " + json.dumps({"re": [float(x) for x in l[:, 0]],
                                       "im": [float(x) for x in l[:, 1]]}))

    return optimize_c4v(cfg, model, model.energy_1x1_lowmem, A0, obs_extra=top_spec)


if __name__ == "__main__":
    main(sys.argv[1:])
