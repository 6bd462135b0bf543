"""The port's optimizer, driver, configuration and entry points against tpeps
on the CPU (float64, D=2, chi=8).

Tolerances, each stated at its test: the first loss and gradient of the
canonical optimization equal the JAX package's to 1e-8 (relative for the
gradient: two fixed points converged to 1e-10, adjoints to 1e-8); the
optimization reaches the Neel-like plateau below -0.6 as the JAX
package's does; state files read back bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from tpeps.config import Config as J_Config
from tpeps.config import CtmArgs as J_CtmArgs
from tpeps.config import MainArgs as J_MainArgs
from tpeps.config import OptArgs as J_OptArgs
from tpeps.config import get_args_parser as j_get_args_parser
from tpeps.ctm.c4v.ctmrg import converge_env as j_converge_env
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ipeps.ipeps_c4v import read_ipeps_c4v as j_read_ipeps_c4v
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch.config import get_args_parser
from tpeps_torch.ctm.c4v.ctmrg import converge_env, run_fixed_point
from tpeps_torch.ctm.c4v.env import init_env
from tpeps_torch.io.convert import config_from_dict, to_torch
from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
from tpeps_torch.optim.driver import optimize_state
from tpeps_torch.optim.lbfgs import LBFGS
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CHI, D = 8, 2


def test_lbfgs_quadratic_and_rosenbrock():
    """Twins of tests/test_optim.py::TestLBFGS on the port's copy."""
    rng = np.random.RandomState(0)
    Q = rng.rand(10, 10)
    Q = Q @ Q.T + np.eye(10)
    b = rng.rand(10)
    opt = LBFGS(10, max_iter=50, line_search_fn="strong_wolfe", tolerance_grad=1e-12)
    x, loss, _, _ = opt.step_2c(np.zeros(10), lambda x: (0.5 * x @ Q @ x - b @ x, Q @ x - b))
    x_star = np.linalg.solve(Q, b)
    assert loss - (0.5 * x_star @ Q @ x_star - b @ x_star) < 1e-9

    f = lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2
    g = lambda x: np.array([-2 * (1 - x[0]) - 400 * x[0] * (x[1] - x[0] ** 2),
                            200 * (x[1] - x[0] ** 2)])
    opt = LBFGS(2, max_iter=200, line_search_fn="backtracking", tolerance_grad=1e-9,
                tolerance_change=1e-16)
    _, loss, _, _ = opt.step_2c(np.array([-1.0, 1.0]), lambda x: (f(x), g(x)), f)
    assert loss < 1e-8


def _canonical_cfgs():
    """tests/test_optim.py::TestOptimizeC4v's configuration for both packages."""
    jcfg = J_Config(
        main=J_MainArgs(opt_max_iter=12, chi=CHI, bond_dim=D),
        ctm=J_CtmArgs(ctm_max_iter=300, ctm_conv_tol=1e-10, grad_mode="implicit",
                      grad_adjoint_max_iter=200, grad_adjoint_tol=1e-8),
        opt=J_OptArgs(line_search="backtracking", max_iter_per_epoch=1),
    )
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, cfg


def test_config_carried_across():
    jcfg, cfg = _canonical_cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.global_args.torch_dtype == torch.float64
    assert cfg.global_args.torch_device == torch.device("cuda")
    with pytest.raises(KeyError):
        config_from_dict({"ctm": {"no_such_flag": 1}})


def test_cli_flags_match_tpeps():
    flags = lambda p: sorted(s for a in p._actions for s in a.option_strings)
    assert flags(get_args_parser()) == flags(j_get_args_parser())


def test_optimize_state_canonical():
    """Twin of tests/test_optim.py::TestOptimizeC4v: D=2, chi=8, j2=0,
    implicit gradient, backtracking L-BFGS.  The first loss and gradient (the
    first closure of epoch 0) equal ``jax.value_and_grad`` of the JAX loss
    to 1e-8; twelve epochs of the port's ``optimize_state`` reach below -0.6
    and lower the loss."""
    jcfg, cfg = _canonical_cfgs()
    A0 = np.random.RandomState(2).rand(2, D, D, D, D) - 0.5
    jmodel = J_J1J2(j1=1.0, j2=0.0)

    def loss_j(p):
        a = j_symmetrize(p, normalize=True)
        e0 = j_init_env(jax.lax.stop_gradient(a), CHI, "CTMRG")
        return jmodel.energy_1x1_lowmem(a, j_converge_env(a, e0, jcfg.ctm))

    vj, gj = jax.value_and_grad(loss_j)(jnp.asarray(A0))
    gj = np.asarray(gj)

    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.0, device=CPU)

    def loss_fn(p):
        a = symmetrize_c4v(p, normalize=True)
        e0 = init_env(a.detach(), CHI, "CTMRG")
        return model.energy_1x1_lowmem(a, converge_env(a, e0, cfg.ctm))

    def loss_ng(p):
        a = symmetrize_c4v(p, normalize=True)
        e, *_ = run_fixed_point(a, init_env(a, CHI, "CTMRG"), max_iter=300, conv_tol=1e-10)
        return model.energy_1x1_lowmem(a, e)

    first = []

    def loss_fn_recorded(p):
        loss = loss_fn(p)
        if not first:
            (g,) = torch.autograd.grad(loss, p, retain_graph=True)
            first.append((float(loss.detach()), g.numpy().copy()))
        return loss

    At = to_torch(A0, device=CPU)
    _, history = optimize_state(At, loss_fn_recorded, cfg=cfg, loss_fn_linesearch=loss_ng)
    v0, g0 = first[0]
    assert abs(v0 - float(vj)) < 1e-8
    assert np.abs(g0 - gj).max() < 1e-8 * np.abs(gj).max()
    with torch.no_grad():
        e_init = float(loss_ng(At))
    e_fin = history["loss"][-1]
    assert e_fin < e_init
    assert e_fin < -0.6, f"expected Heisenberg-like energy, got {e_fin}"


def test_example_entry_point_and_state_file(tmp_path, capsys):
    """The port's entry point (``python -m
    tpeps_torch.examples.j1j2.optim_j1j2_c4v``) on the CPU with the POWER
    projector (on the K3/K6 twins, gradient and line search; SYMEIG for the
    observables): two epochs, a finite final energy; the state file its
    best-state writer wrote reads back bit-identically in tpeps;
    ``--top_freq 0`` prints no transfer spectrum and changes nothing else,
    as in the JAX script."""
    from tpeps_torch.examples.j1j2 import optim_j1j2_c4v

    prefix = str(tmp_path / "run")
    argv = ["--GLOBALARGS_device", "cpu", "--bond_dim", "2", "--chi", "8", "--j2", "0.3",
            "--seed", "3", "--opt_max_iter", "2", "--out_prefix", prefix,
            "--CTMARGS_projector_svd_method", "POWER", "--CTMARGS_ctm_max_iter", "60",
            "--CTMARGS_ctm_conv_tol", "1e-9", "--CTMARGS_grad_adjoint_max_iter", "40",
            "--OPTARGS_line_search", "backtracking", "--OPTARGS_line_search_svd_method",
            "POWER"]
    e_fin, a, env, history = optim_j1j2_c4v.main(argv)
    assert np.isfinite(e_fin) and len(history["loss"]) == 2
    assert a.device == CPU and env.C.device == CPU
    site_j = np.asarray(j_read_ipeps_c4v(prefix + "_state.json").site())
    np.testing.assert_array_equal(a.numpy(), site_j)
    capsys.readouterr()
    e_top0, a_top0, _, _ = optim_j1j2_c4v.main(argv + ["--top_freq", "0"])
    assert "TOP" not in capsys.readouterr().out
    assert e_top0 == e_fin and torch.equal(a_top0, a)


def test_initial_site_from_instate(tmp_path):
    """``--instate`` with a larger ``--bond_dim``: the stored site zero-padded,
    uniform noise added from the seeded generator, normalized."""
    from tpeps_torch.examples.optim_common_c4v import initial_site_c4v
    from tpeps_torch.ipeps.ipeps_c4v import IPEPS_C4V

    site = torch.from_numpy(np.random.RandomState(6).rand(2, 2, 2, 2, 2))
    f = tmp_path / "in_state.json"
    IPEPS_C4V(site).write_to_file(f, symmetrize=False, fmt="1D")
    cfg = config_from_dict({"main": {"instate": str(f), "bond_dim": 3, "instate_noise": 0.0},
                            "global_args": {"device": "cpu"}})
    A = initial_site_c4v(cfg, 2)
    assert A.shape == (2, 3, 3, 3, 3)
    np.testing.assert_allclose(A[:, :2, :2, :2, :2].numpy(),
                               (site / torch.linalg.vector_norm(site)).numpy(), rtol=0, atol=1e-15)
    assert float(A[:, 2].abs().max()) == 0.0
    noisy = config_from_dict({"main": {"instate": str(f), "bond_dim": 2, "instate_noise": 0.1},
                              "global_args": {"device": "cpu"}})
    B = initial_site_c4v(noisy, 2)
    assert abs(float(torch.linalg.vector_norm(B)) - 1.0) < 1e-14
    assert not torch.allclose(B, site / torch.linalg.vector_norm(site))


def test_entry_points_default_to_the_card(tmp_path):
    """Constructors and readers given no device ask for CUDA: on a machine
    without a card they raise instead of building CPU tensors."""
    from tpeps_torch.ctm.c4v.env import init_random
    from tpeps_torch.groups.su2 import SU2, get_rot_op
    from tpeps_torch.ipeps.ipeps import IPEPS, write_ipeps
    from tpeps_torch.ipeps.ipeps_c4v import read_ipeps_c4v
    from tpeps_torch.linalg.power import cold_start_basis

    f = tmp_path / "s.json"
    write_ipeps(IPEPS({(0, 0): torch.rand(2, 2, 2, 2, 2, dtype=torch.float64)}, lX=1, lY=1), f)
    calls = [
        lambda: J1J2_C4V_BIPARTITE(j2=0.3),
        lambda: SU2(2).SZ(),
        lambda: get_rot_op(2),
        lambda: to_torch(np.zeros(3)),
        lambda: read_ipeps_c4v(f),
        lambda: cold_start_basis(8, 2),
        lambda: init_random(None, 4, 4, torch.float64),
    ]
    for call in calls:
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises((RuntimeError, AssertionError)):
            call()
