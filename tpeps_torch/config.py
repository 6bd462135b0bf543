"""Configuration of tpeps_torch: the port's own copy of tpeps/config.py.

Each argument group is an immutable ``dataclass`` passed explicitly; the
CLI keeps the JAX package's flag names (``--CTMARGS_ctm_max_iter``,
``--GLOBALARGS_dtype``, ``--OPTARGS_lr``, bool flags as ``--X``/``--no_X``)
so the example scripts take the same command lines.  Dtypes are torch
dtypes; ``--GLOBALARGS_device`` picks the device, the card by default.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field, fields

import torch

_DTYPE_MAP = {
    "float64": torch.float64,
    "float32": torch.float32,
    "complex128": torch.complex128,
    "complex64": torch.complex64,
}

_REAL_OF = {
    "float64": "float64",
    "float32": "float32",
    "complex128": "float64",
    "complex64": "float32",
}


@dataclass(frozen=True)
class MainArgs:
    """Run-level arguments (reference config.py:164-199)."""

    instate: str | None = None
    out_prefix: str = "output"
    bond_dim: int = 1
    chi: int = 128
    opt_max_iter: int = 100
    seed: int = 0
    instate_noise: float = 0.0
    ipeps_init_type: str = "RANDOM"
    opt_resume: str | None = None
    opt_resume_override_params: bool = False
    omp_cores: int = 1


@dataclass(frozen=True)
class GlobalArgs:
    """Global dtype/device args (reference config.py:201-231).

    ``device`` is a torch device string; "" means the card ("cuda").
    """

    dtype: str = "float64"
    device: str = ""
    tensor_io_format: str = "legacy"

    @property
    def torch_dtype(self):
        return _DTYPE_MAP[self.dtype]

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device or "cuda")

    @property
    def real_dtype(self):
        return _DTYPE_MAP[_REAL_OF[self.dtype]]

    @property
    def is_complex(self) -> bool:
        return self.dtype.startswith("complex")


@dataclass(frozen=True)
class PepsArgs:
    """iPEPS construction args (reference config.py:233-244)."""

    build_dl: bool = True
    build_dl_open: bool = False
    quasi_gauge_max_iter: int = 10**6
    quasi_gauge_tol: float = 1.0e-8


@dataclass(frozen=True)
class CtmArgs:
    """CTMRG algorithm args (reference config.py:246-415).

    Differences from the reference (kept from tpeps):

    * ``fwd_checkpoint_*`` five-level checkpoint flags collapse into
      ``fwd_checkpoint_move`` (checkpointing the whole move — the
      reference's recommended setting) plus the ``grad_mode`` selector
      below.
    * ``grad_mode`` selects how reverse-mode AD crosses the CTMRG loop:
      - "implicit": implicit differentiation of the converged fixed
        point (adjoint solved by Neumann iteration; constant memory),
      - "scan": differentiate through a fixed window of
        ``grad_tail_iter`` checkpointed moves applied after a no-grad
        convergence run (truncated backprop-through-CTMRG).
    """

    ctm_max_iter: int = 50
    ctm_warmup_iter: int = -1
    ctm_env_init_type: str = "CTMRG"
    ctm_conv_tol: float = 1.0e-8
    ctm_absorb_normalization: str = "inf"
    projector_method: str = "4X4"  # generic-stack enlarged-corner scheme (only 4X4)
    # C4v projector decomposition: DEFAULT/SYMEIG (dense symmetric eig),
    # POWER (warm-started subspace iteration on the K3/K6 kernels) or QR.
    # Plumbed by ctm.c4v.ctmrg.converge_env.
    projector_svd_method: str = "DEFAULT"
    n_power: int = 2  # POWER: subspace-iteration steps per move
    projector_svd_reltol: float = 1.0e-8
    projector_eps_multiplet: float = 1.0e-8
    projector_multiplet_abstol: float = 1.0e-14
    projector_rsvd_niter: int = 2
    ad_decomp_reg: float = 1.0e-12
    ctm_move_sequence: tuple = ((0, -1), (-1, 0), (0, 1), (1, 0))
    ctm_force_dl: bool = False
    # FPCM acceleration (reference config.py:376-379; consumed by
    # tpeps/ctm/c4v/fpcm.py:fpcm_move_sl): standard moves for
    # fpcm_init_iter iterations, then an FPCM move every fpcm_freq
    # iterations (-1 = never)
    fpcm_init_iter: int = 1
    fpcm_freq: int = -1
    fpcm_isogauge_tol: float = 1.0e-14
    fpcm_fpt_tol: float = 1.0e-8
    fwd_checkpoint_move: bool = True
    ctm_conv_check: str = "spec"  # "spec" | "rdm2x1" (c4v)
    grad_mode: str = "implicit"  # "implicit" | "scan"
    grad_tail_iter: int = 20
    grad_adjoint_max_iter: int = 100
    grad_adjoint_tol: float = 1.0e-8
    # VJP-only gap regularizer FLOOR applied inside the implicit
    # adjoints (forward values unaffected): raise to ~1e-4 for states
    # with exact spectral multiplets (SU(2)/U(1) degeneracies), where
    # the default accuracy-first value lets the Neumann adjoint diverge
    # (the guard then truncates the gradient)
    grad_adjoint_decomp_reg: float = 1.0e-6
    verbosity_initialization: int = 0
    verbosity_ctm_convergence: int = 0
    verbosity_projectors: int = 0
    verbosity_ctm_move: int = 0
    verbosity_rdm: int = 0


@dataclass(frozen=True)
class OptArgs:
    """Optimizer args (reference config.py:417-505)."""

    opt_type: str = "LBFGS"  # "LBFGS" | "SGD" (reference ad_optim_sgd_mod.py)
    lr: float = 1.0
    momentum: float = 0.0
    tolerance_grad: float = 1e-5
    tolerance_change: float = 1e-9
    opt_ctm_reinit: bool = True
    env_sens_scale: float = 10.0
    env_sens_regauge: bool = False  # regauge on EnvError (reference config.py:488)
    line_search: str = "default"  # "default"(strong_wolfe) | "backtracking"
    line_search_ctm_reinit: bool = True
    line_search_svd_method: str = "DEFAULT"
    line_search_tol: float = 1.0e-8
    fd_eps: float = 1.0e-4
    fd_ctm_reinit: bool = True
    history_size: int = 100
    max_iter_per_epoch: int = 1
    verbosity_opt_epoch: int = 1
    opt_logging: bool = True
    opt_log_grad: bool = False


@dataclass(frozen=True)
class Config:
    """Bundle of all argument groups, threaded explicitly through APIs."""

    main: MainArgs = field(default_factory=MainArgs)
    global_args: GlobalArgs = field(default_factory=GlobalArgs)
    peps: PepsArgs = field(default_factory=PepsArgs)
    ctm: CtmArgs = field(default_factory=CtmArgs)
    opt: OptArgs = field(default_factory=OptArgs)


_PREFIXED = (
    ("GLOBALARGS_", GlobalArgs),
    ("PEPSARGS_", PepsArgs),
    ("CTMARGS_", CtmArgs),
    ("OPTARGS_", OptArgs),
)


def _add_dataclass_args(parser: argparse.ArgumentParser, prefix: str, cls) -> None:
    """Auto-generate flags from dataclass fields (reference config.py:36-79)."""
    for f in fields(cls):
        name = prefix + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = f.default_factory()  # type: ignore[misc]
        if f.type in ("bool", bool) or isinstance(default, bool):
            # bool attrs become --X / --no_X (reference config.py:60-66)
            group = parser.add_mutually_exclusive_group(required=False)
            group.add_argument("--" + name, dest=name, action="store_true")
            group.add_argument("--no_" + name, dest=name, action="store_false")
            parser.set_defaults(**{name: default})
        elif isinstance(default, tuple):
            continue  # move sequences etc. are not CLI-settable
        else:
            argtype = type(default) if default is not None else str
            parser.add_argument("--" + name, type=argtype, default=default)


def get_args_parser() -> argparse.ArgumentParser:
    """CLI parser mirroring reference config.py:36-79 flag names."""
    parser = argparse.ArgumentParser(
        description="tpeps_torch — iPEPS optimization on PyTorch/CUDA", allow_abbrev=False
    )
    for f in fields(MainArgs):
        default = f.default if f.default is not dataclasses.MISSING else None
        if isinstance(default, bool):
            group = parser.add_mutually_exclusive_group(required=False)
            group.add_argument("--" + f.name, dest=f.name, action="store_true")
            group.add_argument("--no_" + f.name, dest=f.name, action="store_false")
            parser.set_defaults(**{f.name: default})
        else:
            argtype = type(default) if default is not None else str
            parser.add_argument("--" + f.name, type=argtype, default=default)
    for prefix, cls in _PREFIXED:
        _add_dataclass_args(parser, prefix, cls)
    return parser


def configure(parsed_args) -> Config:
    """Build an immutable Config from parsed CLI args (reference config.py:81-129)."""
    ns = vars(parsed_args)

    def collect(prefix, cls):
        kwargs = {}
        for f in fields(cls):
            key = prefix + f.name
            if key in ns and ns[key] is not None:
                kwargs[f.name] = ns[key]
        return cls(**kwargs)

    main_kwargs = {f.name: ns[f.name] for f in fields(MainArgs) if f.name in ns}
    return Config(
        main=MainArgs(**main_kwargs),
        global_args=collect("GLOBALARGS_", GlobalArgs),
        peps=collect("PEPSARGS_", PepsArgs),
        ctm=collect("CTMARGS_", CtmArgs),
        opt=collect("OPTARGS_", OptArgs),
    )
