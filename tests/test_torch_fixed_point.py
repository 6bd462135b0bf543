"""The large-D C4v drivers of the port against tpeps on the CPU:
``run_fixed_point_factored`` (K5's chunked loop with the ``ctm_commit`` twin)
against ``run_fixed_point_tpu``, ``run_ctmrg(moves_per_sync=...)`` against
``run_ctmrg_tpu``, and ``run_ctmrg_mixed`` against ``run_ctmrg_tpu_mixed``.

The same numpy state goes to both packages, and the port starts from the
JAX package's environment carried across.  Tolerances: move counts equal,
distances and C, T 1e-10 for the fixed point (float64, summation order
only), energies 1e-9 for the drivers.
"""

import math

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.ctm.c4v import move_tpu as jm
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch import kernels
from tpeps_torch.ctm.c4v import move_factored as tm
from tpeps_torch.ctm.c4v import move_graph as mg
from tpeps_torch.ctm.c4v.ctmrg import run_fixed_point
from tpeps_torch.io.convert import to_torch
from tpeps_torch.kernels.ctm_loop import ctm_commit, loop_state
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

D, CHI = 2, 16


def _state(seed, D_=D, chi=CHI):
    x = np.random.RandomState(seed).rand(2, D_, D_, D_, D_) - 0.5
    aj = j_symmetrize(jnp.asarray(x), normalize=True)
    envj = j_init_env(aj, chi, "CTMRG")
    at, envt = to_torch(np.asarray(aj), (np.asarray(envj.C), np.asarray(envj.T)), device="cpu")
    return aj, envj, at, envt


@pytest.fixture(scope="module")
def seed0():
    return _state(0)


@pytest.mark.parametrize("conv_on,max_iter,conv_tol", [("spec", 60, 1e-9), ("env", 60, 1e-9),
                                                       ("spec", 30, 0.0)],
                         ids=["spec", "env", "max_iter_30"])
def test_run_fixed_point_factored_matches_jax(seed0, conv_on, max_iter, conv_tol):
    """Chunks of 4 moves: the count is exact even where max_iter (30) or the
    converged move is not a multiple of 4 (moves after the end are discarded)."""
    aj, envj, at, envt = seed0
    kernels.reset_launch_counts()
    envj2, nj, dj, Pj = jm.run_fixed_point_tpu(aj, envj, max_iter=max_iter, conv_tol=conv_tol,
                                               conv_on=conv_on)
    env, n, dist, P = mg.run_fixed_point_factored(at, envt, max_iter=max_iter,
                                                  conv_tol=conv_tol, conv_on=conv_on,
                                                  moves_per_sync=4)
    assert n == int(nj)
    assert abs(dist - float(dj)) < 1e-10
    np.testing.assert_allclose(env.C.numpy(), np.asarray(envj2.C), rtol=0, atol=1e-10)
    np.testing.assert_allclose(env.T.numpy(), np.asarray(envj2.T), rtol=0, atol=1e-10)
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), rtol=0, atol=1e-10)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # twins on the CPU


def _commit_case(max_iter=5):
    chi, Dd = 3, 2
    rng = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rng.rand(*s))
    st = loop_state(t(chi, chi), t(Dd, Dd, chi, chi), t(12, chi), max_iter, 1e-8)
    st.spec.copy_(torch.tensor([1.0, 0.5, 0.25], dtype=torch.float64))
    new = (t(chi, chi), t(Dd, Dd, chi, chi), t(12, chi), t(chi, chi))
    return st, new


def test_ctm_commit_twin_spec_distance():
    st, (C2, T2, P2, W2) = _commit_case()
    spec2 = torch.tensor([-1.0, 0.5, 0.0], dtype=torch.float64)
    ctm_commit(st, C2, T2, P2, W2, spec2)
    assert float(st.dist) == 0.25  # || |spec2| - spec_prev || = |0 - 0.25|
    assert st.ctl[:2].tolist() == [1, 0]
    for x, y in ((st.C, C2), (st.T, T2), (st.P, P2), (st.W, W2)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(st.spec.numpy(), [1.0, 0.5, 0.0])


def test_ctm_commit_twin_env_distance():
    st, (C2, T2, P2, W2) = _commit_case()
    want = max(float((C2 - st.C).abs().max()), float((T2 - st.T).abs().max()))
    ctm_commit(st, C2, T2, P2, W2, torch.ones(3, dtype=torch.float64), conv_on="env")
    assert float(st.dist) == want and st.ctl[:2].tolist() == [1, 0]


def test_ctm_commit_twin_non_finite_spectrum():
    """A non-finite spectrum gives dist = inf: the move is committed and the
    loop goes on (inf > conv_tol) until max_iter, as the while_loop does."""
    st, (C2, T2, P2, W2) = _commit_case()
    spec2 = torch.tensor([1.0, math.nan, 0.1], dtype=torch.float64)
    ctm_commit(st, C2, T2, P2, W2, spec2)
    assert math.isinf(float(st.dist)) and st.ctl[:2].tolist() == [1, 0]
    assert torch.equal(st.T, T2)


def test_ctm_commit_twin_max_iter_reached():
    st, (C2, T2, P2, W2) = _commit_case(max_iter=2)
    st.ctl[0] = 1
    ctm_commit(st, C2, T2, P2, W2, torch.ones(3, dtype=torch.float64))
    assert st.ctl[:2].tolist() == [2, 1]  # committed, then done
    assert torch.equal(st.C, C2)


def test_ctm_commit_twin_already_done():
    st, (C2, T2, P2, W2) = _commit_case()
    st.ctl[1] = 1
    before = [x.clone() for x in st]
    ctm_commit(st, C2, T2, P2, W2, torch.ones(3, dtype=torch.float64))
    for x, y in zip(st, before):
        assert torch.equal(x, y)  # the committed state is untouched


def test_ctm_commit_rejects_mismatched_shapes():
    st, (C2, T2, P2, W2) = _commit_case()
    with pytest.raises(ValueError, match="W shape"):
        ctm_commit(st, C2, T2, P2, W2[:2], torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="conv_on"):
        ctm_commit(st, C2, T2, P2, W2, torch.ones(3, dtype=torch.float64), conv_on="spectrum")


def test_moves_per_sync_matches_single_and_jax():
    """Twin of tests/test_power_parity.py::test_batched_moves_equivalent."""
    aj, envj, at, envt = _state(2)
    mj = J_J1J2(j1=1.0, j2=0.0)
    mt = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.0, device="cpu")
    env1, n1, _, _ = tm.run_ctmrg(at, envt, max_iter=80, conv_tol=1e-10, moves_per_sync=1)
    env4, n4, d4, _ = tm.run_ctmrg(at, envt, max_iter=80, conv_tol=1e-10, moves_per_sync=4)
    envj4, nj4, dj4, _ = jm.run_ctmrg_tpu(aj, envj, max_iter=80, conv_tol=1e-10,
                                          moves_per_sync=4)
    e1 = float(mt.energy_1x1_lowmem(at, env1))
    e4 = float(mt.energy_1x1_lowmem(at, env4))
    ej4 = float(mj.energy_1x1_lowmem(aj, envj4))
    assert abs(e1 - e4) < 1e-9, (e1, e4, n1, n4)
    assert abs(e4 - ej4) < 1e-9 and n4 == nj4 and n4 % 4 == 0, (e4, ej4, n4, nj4)
    assert abs(d4 - dj4) < 1e-10


def test_mixed_driver_matches_jax(seed0):
    """RandomState(0), D=2 chi=16, j2=0.3: the JAX package's pure-f64 driver
    reaches dist 7.2e-11 in 41 moves.  Compared: the final energy against
    that run (1e-9), the distance (< 1e-10), and the total move count against
    run_ctmrg_tpu_mixed's (the f32 phases may stop a move apart: within 2;
    equal on this state, 11 + 12 + 18 = 41)."""
    aj, envj, at, envt = seed0
    kw = dict(max_iter=200, conv_tol=1e-10, switch_tol=1e-5)
    env64, n64, d64, _ = jm.run_ctmrg_tpu(aj, envj, max_iter=200, conv_tol=1e-10)
    _, nmx, dmx = jm.run_ctmrg_tpu_mixed(aj, envj, **kw)
    stats = []
    env, n, dist = tm.run_ctmrg_mixed(at, envt, stats=stats, **kw)
    assert d64 < 1e-10 and dmx < 1e-10 and dist < 1e-10
    assert env.C.dtype == env.T.dtype == torch.float64
    assert [s["phase"] for s in stats] == ["f32", "f32 highest", "f64"]
    assert sum(s["moves"] for s in stats) == n
    assert abs(n - int(nmx)) <= 2, (n, nmx, [s["moves"] for s in stats])
    e64 = float(J_J1J2(j1=1.0, j2=0.3).energy_1x1_lowmem(aj, env64))
    e = float(J1J2_C4V_BIPARTITE(j1=1.0, j2=0.3, device="cpu").energy_1x1_lowmem(at, env))
    assert abs(e - e64) < 1e-9, (e, e64)


def test_matmul_precision_scope_restores():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with tm.matmul_precision_scope("highest"):
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        with tm.matmul_precision_scope(None):
            assert torch.backends.cuda.matmul.allow_tf32 is True
        with pytest.raises(ValueError, match="matmul_precision"):
            with tm.matmul_precision_scope("high"):
                pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_drivers_reject_bad_arguments(seed0):
    _, _, at, envt = seed0
    with pytest.raises(ValueError, match="moves_per_sync"):
        tm.run_ctmrg(at, envt, max_iter=4, moves_per_sync=0)
    with pytest.raises(ValueError, match="n_moves"):
        mg.MoveGraph(at, CHI, n_moves=0)


@pytest.mark.parametrize("limits", [[(30, 0.0), (60, 1e-9)], [(60, 1e-9), (30, 0.0)]],
                         ids=["cap_then_tol", "tol_then_cap"])
def test_move_graph_takes_limits_from_the_state(seed0, limits):
    """One MoveGraph, loaded twice with other loop limits (the limits live in
    the loop state, not in what a capture bakes in), ends as
    run_fixed_point_factored does at each."""
    _, _, at, envt = seed0
    g = mg.MoveGraph(at, CHI, n_moves=4)
    D_ = at.shape[1]
    for max_iter, conv_tol in limits:
        P0 = tm.cold_start_basis(CHI * D_ * D_, CHI, envt.C.dtype, envt.C.device)
        g.load(at, envt.C, tm.to_int_layout(envt.T, D_), P0, max_iter=max_iter,
               conv_tol=conv_tol)
        for _ in range(math.ceil(max_iter / 4)):
            g.run()
        ref, n_ref, d_ref, _ = mg.run_fixed_point_factored(at, envt, max_iter=max_iter,
                                                           conv_tol=conv_tol, moves_per_sync=4)
        assert int(g.state.ctl[0]) == n_ref and bool(g.state.ctl[1])
        assert float(g.state.dist) == d_ref
        assert torch.equal(g.state.C, ref.C)


@pytest.mark.slow
def test_power_factored_energy_parity_with_symeig():
    """Twin of tests/test_power_parity.py::test_power_tpu_path_energy_parity_with_symeig
    on the port: the factored POWER path (the graph-chunked loop) and the
    reference-layout SYMEIG path converge to one energy (1e-8)."""
    D4, chi4 = 4, 48
    _, _, at, envt = _state(0, D4, chi4)
    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.3, device="cpu")
    env_se, _, dist_se, _ = run_fixed_point(at, envt, max_iter=200, conv_tol=1e-10,
                                            projector_method="SYMEIG")
    assert float(dist_se) < 1e-6
    env_pw, _, dist_pw, _ = mg.run_fixed_point_factored(at, envt, max_iter=200,
                                                        conv_tol=1e-10)
    assert dist_pw < 1e-6
    e_se = float(model.energy_1x1_lowmem(at, env_se))
    e_pw = float(model.energy_1x1_lowmem(at, env_pw))
    assert abs(e_se - e_pw) < 1e-8, (e_se, e_pw)
