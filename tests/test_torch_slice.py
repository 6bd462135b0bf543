"""The forward C4v slice end to end: port against tpeps on the CPU.

symmetrize_c4v -> init_env("CTMRG") -> CTMRG with the factored move
(``run_ctmrg`` vs ``run_ctmrg_tpu``, conv_tol=1e-10) -> J1-J2 (j2=0.3)
``energy_1x1_lowmem`` and ``eval_obs``, at D=2 chi=16 and D=3 chi=18.
Both sides converge the same fixed point to 1e-10 in the corner spectra,
so energies agree to 1e-10 and observables to 1e-9.

From each package's own init the trajectories may differ by a gauge (the
corner eigenbasis of init_env is fixed only up to signs and rotations in
degenerate multiplets), so the iteration counts are compared on the run
that starts from the JAX package's environment carried across.
"""

import json

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ctm.c4v.move_tpu import run_ctmrg_tpu
from tpeps.ipeps.ipeps import IPEPS as J_IPEPS
from tpeps.ipeps.ipeps import write_ipeps as j_write_ipeps
from tpeps.ipeps.ipeps import read_ipeps as j_read_ipeps
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch.ctm.c4v.env import init_env
from tpeps_torch.ctm.c4v.move_factored import run_ctmrg
from tpeps_torch.io.convert import to_torch
from tpeps_torch.ipeps.ipeps import write_ipeps
from tpeps_torch.ipeps.ipeps_c4v import IPEPS_C4V, read_ipeps_c4v, symmetrize_c4v
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CASES = [(2, 16, 0), (3, 18, 3)]  # (D, chi, seed): seeds that converge in < 50 moves
IDS = [f"D{D}_chi{chi}" for D, chi, _ in CASES]
CONV_TOL, MAX_ITER = 1e-10, 100


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    D, chi, seed = request.param
    x = np.random.RandomState(seed).rand(2, D, D, D, D) - 0.5
    aj = j_symmetrize(jnp.asarray(x), normalize=True)
    env0j = j_init_env(aj, chi, "CTMRG")
    envj, nj, distj, _ = run_ctmrg_tpu(aj, env0j, max_iter=MAX_ITER, conv_tol=CONV_TOL)
    mj = J_J1J2(j1=1.0, j2=0.3)
    return dict(D=D, chi=chi, x=x, aj=aj, env0j=env0j, nj=nj, distj=distj,
                ej=float(mj.energy_1x1_lowmem(aj, envj)), obsj=mj.eval_obs(aj, envj))


def _check_observables(obs_t, obs_j):
    vals_t, labels_t = obs_t
    vals_j, labels_j = obs_j
    assert labels_t == labels_j
    for l, vt, vj in zip(labels_t, vals_t, vals_j):
        assert abs(complex(vt) - complex(vj)) < 1e-9, (l, vt, vj)


def test_slice_end_to_end(case):
    """Each package from its own state and init."""
    D, chi = case["D"], case["chi"]
    a = symmetrize_c4v(torch.from_numpy(case["x"]), normalize=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(case["aj"]), rtol=0, atol=1e-15)
    env0 = init_env(a, chi, "CTMRG")
    np.testing.assert_allclose(env0.C.numpy(), np.asarray(case["env0j"].C), rtol=0, atol=1e-12)
    env, n, dist, _ = run_ctmrg(a, env0, max_iter=MAX_ITER, conv_tol=CONV_TOL)
    assert dist < CONV_TOL and case["distj"] < CONV_TOL
    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.3, device="cpu")
    assert abs(float(model.energy_1x1_lowmem(a, env)) - case["ej"]) < 1e-10
    _check_observables(model.eval_obs(a, env), case["obsj"])


def test_slice_from_carried_env(case):
    """The port from the JAX package's state and environment."""
    a, env0 = to_torch(np.asarray(case["aj"]),
                       (np.asarray(case["env0j"].C), np.asarray(case["env0j"].T)), device="cpu")
    env, n, dist, _ = run_ctmrg(a, env0, max_iter=MAX_ITER, conv_tol=CONV_TOL)
    assert abs(n - case["nj"]) <= 1, (n, case["nj"])
    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.3, device="cpu")
    assert abs(float(model.energy_1x1_lowmem(a, env)) - case["ej"]) < 1e-10
    _check_observables(model.eval_obs(a, env), case["obsj"])


@pytest.mark.parametrize("fmt", ["legacy", "1D"])
def test_state_file_read_bit_identical(tmp_path, fmt):
    a = np.random.RandomState(5).rand(2, 3, 3, 3, 3) - 0.5
    f = tmp_path / "state.json"
    j_write_ipeps(J_IPEPS({(0, 0): jnp.asarray(a)}, lX=1, lY=1), f, fmt=fmt)
    site = read_ipeps_c4v(f, device="cpu").site()
    assert site.dtype == torch.float64
    np.testing.assert_array_equal(site.numpy(), a)
    # and back: the port's file reads bit-identically in the JAX package
    g = tmp_path / "state_port.json"
    write_ipeps(IPEPS_C4V(site), g, fmt=fmt)
    assert json.loads(g.read_text()) == json.loads(f.read_text())
    np.testing.assert_array_equal(np.asarray(j_read_ipeps(g).sites[(0, 0)]), a)


def test_init_env_prod_and_random():
    x = np.random.RandomState(1).rand(2, 2, 2, 2, 2) - 0.5
    aj = j_symmetrize(jnp.asarray(x), normalize=True)
    a = symmetrize_c4v(torch.from_numpy(x), normalize=True)
    ej, et = j_init_env(aj, 6, "PROD"), init_env(a, 6, "PROD")
    np.testing.assert_array_equal(et.C.numpy(), np.asarray(ej.C))
    # the leading transfer eigenvector is fixed up to its sign
    tj, tt = np.asarray(ej.T)[0, 0], et.T[0, 0].numpy()
    np.testing.assert_allclose(tt * np.sign(tt @ tj), tj, rtol=0, atol=1e-12)
    env = init_env(a, 6, "RANDOM", generator=torch.Generator().manual_seed(0))
    assert env.C.shape == (6, 6) and env.T.shape == (6, 6, 4) and env.chi == 6
    np.testing.assert_array_equal(env.C.numpy(), env.C.numpy().T)
    with pytest.raises(ValueError):
        init_env(a, 6, "RANDOM")


@pytest.mark.parametrize("terms", [dict(j2=0.3, j3=0.1), dict(j2=0.0, hz_stag=0.2, delta_zz=0.5)],
                         ids=["j3", "hz_stag_delta_zz"])
def test_model_terms_on_a_shared_env(terms):
    """Energy and observables with the terms the slice does not switch on
    (3x1 RDM, staggered field, anisotropy), on the same environment."""
    x = np.random.RandomState(4).rand(2, 2, 2, 2, 2) - 0.5
    aj = j_symmetrize(jnp.asarray(x), normalize=True)
    envj = j_init_env(aj, 8, "CTMRG")
    a, env = to_torch(np.asarray(aj), (np.asarray(envj.C), np.asarray(envj.T)), device="cpu")
    mj, mt = J_J1J2(j1=1.0, **terms), J1J2_C4V_BIPARTITE(j1=1.0, device="cpu", **terms)
    assert abs(float(mt.energy_1x1_lowmem(a, env)) - float(mj.energy_1x1_lowmem(aj, envj))) < 1e-12
    _check_observables(mt.eval_obs(a, env), mj.eval_obs(aj, envj))
