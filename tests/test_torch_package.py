"""Package-level contracts of tpeps_torch on the CPU: it never imports JAX,
the CPU path never launches a kernel, the kernel wrappers are forward-only
and never hand a non-CPU tensor to their twin."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpeps_torch
from tpeps_torch import kernels
from tpeps_torch.ctm.c4v.env import init_env
from tpeps_torch.ctm.c4v.move_factored import run_ctmrg
from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
from tpeps_torch.kernels.cholqr import gram, gram_ridge, trsm_right_lower, trsm_right_lower_h
from tpeps_torch.kernels.corner import corner_apply
from tpeps_torch.kernels.epilogue import t_epilogue
from tpeps_torch.kernels.layer import layer_contract
from tpeps_torch.kernels.ctm_loop import LoopState, ctm_commit
from tpeps_torch.kernels.ozaki import ozaki_gemm, ozaki_split
from tpeps_torch.kernels.eigh_small import eigh_small
from tpeps_torch.kernels.polar import polar_unitary, polar_vjp
from tpeps_torch.kernels.blocksparse import GemmTable, PermuteTable, block_gemm, block_permute
from tpeps_torch.kernels.frozen import (AdjointState, FrozenState, adjoint_commit, frozen_commit,
                                        frozen_epilogue_vjp)
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE

REPO = Path(__file__).resolve().parent.parent


def test_import_never_pulls_in_jax():
    mods = [m.name for m in pkgutil.walk_packages(tpeps_torch.__path__, "tpeps_torch.")]
    assert "tpeps_torch.ctm.c4v.move_factored" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpeps'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_cpu_slice_launches_no_kernel():
    kernels.reset_launch_counts()
    x = np.random.RandomState(0).rand(2, 2, 2, 2, 2) - 0.5
    a = symmetrize_c4v(torch.from_numpy(x), normalize=True)
    env, n, dist, _ = run_ctmrg(a, init_env(a, 8, "CTMRG"), max_iter=5)
    e = J1J2_C4V_BIPARTITE(j2=0.3, device="cpu").energy_1x1_lowmem(a, env)
    assert np.isfinite(float(e)) and n == 5
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def _wrapper_calls(make):
    """Each kernel wrapper with inputs built by ``make(shape)``."""
    W, X, Y = make((4, 6)), make((6, 5)), make((4, 5))
    P, L = make((12, 4)), make((4, 4))
    nT = make((2, 3, 3))
    planes = torch.zeros((2, 4, 32), dtype=torch.int8, device=W.device)
    ctl = torch.zeros(4, dtype=torch.int32, device=W.device)
    state = LoopState(L, make((2, 2, 4, 4)), P, make((4, 4)), make((4,)), make((1,)),
                      make((1,)), ctl)
    ptable = PermuteTable([0], [0], [[2, 3]], [[1, 2]], [[3, 1]])
    gtable = GemmTable([0], [2], [3], [0, 1], [0], [0], [4], [1])
    fstate = FrozenState(make((6,)), make((8,)), make((1,)), make((1,)), ctl)
    pidx = torch.zeros(6, dtype=torch.int64, device=W.device)
    pidx8 = torch.zeros(8, dtype=torch.int64, device=W.device)
    astate = AdjointState(make((4,)), make((3,)), torch.zeros(6, dtype=torch.int32,
                                                               device=W.device))
    return {
        "layer_contract": lambda: layer_contract(W, X, Y, n_k=1),
        "corner_apply": lambda: corner_apply(make((12, 12)), P),
        "gram_ridge": lambda: gram_ridge(P, 1e-12),
        "gram": lambda: gram(P, make((12, 4))),
        "trsm_right_lower_h": lambda: trsm_right_lower_h(L, P),
        "trsm_right_lower": lambda: trsm_right_lower(L, P),
        "t_epilogue": lambda: t_epilogue(nT),
        "polar_unitary": lambda: polar_unitary(L),
        "polar_vjp": lambda: polar_vjp(L, make((4, 4))),
        "eigh_small": lambda: eigh_small(L),
        "ozaki_split": lambda: ozaki_split(X, 2, 7, axis=0),
        "ozaki_gemm": lambda: ozaki_gemm(planes, make((4,)), planes, make((4,))),
        "ctm_commit": lambda: ctm_commit(state, make((4, 4)), make((2, 2, 4, 4)), make((12, 4)),
                                         make((4, 4)), make((4,))),
        "block_permute": lambda: block_permute(make((6,)), make((6,)), ptable),
        "block_gemm": lambda: block_gemm(make((8,)), make((12,)), make((6,)), gtable),
        "frozen_commit": lambda: frozen_commit(fstate, make((6,)), make((8,)), pidx,
                                               torch.zeros(8, dtype=torch.int64,
                                                           device=W.device)),
        "frozen_epilogue_vjp": lambda: frozen_epilogue_vjp(make((6,)), make((8,)), pidx, pidx8,
                                                           make((6,)), make((8,))),
        "adjoint_commit": lambda: adjoint_commit(astate, make((4,)), make((6,)), make((8,))),
        "block_permute_grad": lambda: block_permute(make((6,)), make((6,)), ptable.inverse()),
        "block_gemm_grad": lambda: block_gemm(make((6,)), make((12,)), make((8,)),
                                              gtable.grad_tables()[0]),
    }


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_wrapper_raises_on_requires_grad(name):
    make = lambda shape: torch.rand(shape, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        _wrapper_calls(make)[name]()


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_wrapper_never_sends_other_devices_to_the_twin(name):
    make = lambda shape: torch.empty(shape, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        _wrapper_calls(make)[name]()


def test_layer_contract_rejects_mismatched_views():
    W = torch.rand(4, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="free axes"):
        layer_contract(W, torch.rand(6, 5, dtype=torch.float64),
                       torch.empty(4, 3, dtype=torch.float64), n_k=1)
    with pytest.raises(ValueError, match="does not match"):
        layer_contract(W, torch.rand(5, 5, dtype=torch.float64),
                       torch.empty(4, 5, dtype=torch.float64), n_k=1)


def test_layer_contract_twin_writes_through_strided_views():
    rng = np.random.RandomState(0)
    W = torch.from_numpy(rng.rand(6, 4))
    X = torch.from_numpy(rng.rand(3, 4, 5))  # stored (n0, k, n1)
    out = torch.zeros(5, 6, 3, dtype=torch.float64)  # stored (n1, p, n0)
    layer_contract(W, X.permute(1, 0, 2), out.permute(1, 2, 0), n_k=1)
    ref = np.einsum("pk,akb->bpa", W.numpy(), X.numpy())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-14)
    layer_contract(W, X.permute(1, 0, 2), out.permute(1, 2, 0), n_k=1, accumulate=True)
    np.testing.assert_allclose(out.numpy(), 2 * ref, rtol=0, atol=1e-14)


def test_convert_round_trip_is_exact():
    from tpeps_torch.io.convert import to_numpy, to_torch

    rng = np.random.RandomState(2)
    a, C, T = rng.rand(2, 2, 2, 2, 2), rng.rand(4, 4), rng.rand(4, 4, 4)
    at, env = to_torch(a, (C, T), device="cpu")
    assert at.dtype == env.C.dtype == env.T.dtype == torch.float64
    a2, (C2, T2) = to_numpy(at, env)
    for x, y in ((a, a2), (C, C2), (T, T2)):
        np.testing.assert_array_equal(x, y)
    assert to_torch(a, device="cpu", dtype=torch.float32).dtype == torch.float32
