"""The port's fixed-point corner method and QR-projector move against the
JAX package on the CPU (twins of tests/test_fpcm_qr.py): after 4 warm-up
moves ``fpcm_move_sl`` gives the JAX package's standard (SYMEIG) fixed-point
energy within 1e-9; ``pull_through`` and ``isogauge_mps`` on JAX's fixed
point give JAX's within 1e-10 and 1e-8; U is an isometry within 1e-10.
JAX's own ``fpcm_move_sl`` is not called: it takes ~30 s here."""

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.ctm.c4v import fpcm as j_fpcm
from tpeps.ctm.c4v.ctmrg import run_fixed_point as j_run_fixed_point
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch.ctm.c4v.ctmrg import run_fixed_point
from tpeps_torch.ctm.c4v.env import EnvC4v, init_env
from tpeps_torch.ctm.c4v.fpcm import fpcm_move_sl, isogauge_mps, pull_through
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
D, CHI, N_WARM = 2, 16, 4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    """JAX's site, its standard fixed point and energy, and its 4 warm-up
    moves, as numpy."""
    rng = np.random.RandomState(0)
    a = j_symmetrize(jnp.asarray(rng.rand(2, D, D, D, D) - 0.5), normalize=True)
    env0 = j_init_env(a, CHI, "CTMRG")
    env_ref, n, _, _ = j_run_fixed_point(a, env0, max_iter=200, conv_tol=1e-11)
    e_ref = float(J_J1J2(j1=1.0, j2=0.3).energy_1x1_lowmem(a, env_ref))
    env_w, *_ = j_run_fixed_point(a, env0, max_iter=N_WARM, conv_tol=1e-30)
    return {"a": np.asarray(a), "ref": (np.asarray(env_ref.C), np.asarray(env_ref.T)),
            "warm": (np.asarray(env_w.C), np.asarray(env_w.T)), "e_ref": e_ref, "n_ref": int(n)}


@pytest.mark.parametrize("warmup", ["jax", "port"])
def test_fpcm_same_fixed_point_fewer_moves(setup, warmup):
    a = _t(setup["a"])
    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.3, device=CPU)
    if warmup == "jax":
        env_w = EnvC4v(*map(_t, setup["warm"]))
    else:
        env_w, *_ = run_fixed_point(a, init_env(a, CHI, "CTMRG"), max_iter=N_WARM,
                                    conv_tol=1e-30)
    env_fp = fpcm_move_sl(a, env_w)
    e_fp = float(model.energy_1x1_lowmem(a, env_fp))
    assert abs(e_fp - setup["e_ref"]) < 1e-9, (e_fp, setup["e_ref"])
    assert N_WARM < setup["n_ref"]


def test_qr_move_same_energy(setup):
    a = _t(setup["a"])
    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.3, device=CPU)
    env_qr, *_ = run_fixed_point(a, init_env(a, CHI, "CTMRG"), max_iter=300, conv_tol=1e-11,
                                 projector_method="QR")
    assert abs(float(model.energy_1x1_lowmem(a, env_qr)) - setup["e_ref"]) < 1e-9


def test_pull_through_matches_jax(setup):
    C, T = setup["ref"]
    P, U = pull_through(_t(C), _t(T))
    Pj, Uj = j_fpcm.pull_through(jnp.asarray(C), jnp.asarray(T))
    for x, ref in ((P, Pj), (U, Uj)):
        ref = np.asarray(ref)
        assert np.abs(x.numpy() - ref).max() < 1e-10 * np.abs(ref).max()


def test_pull_through_isometry(setup):
    C, T = setup["ref"]
    nC, U = isogauge_mps(_t(T), C0=_t(C))
    chi, D2 = U.shape[0], U.shape[2]
    Um = U.permute(0, 2, 1).reshape(chi * D2, chi)
    assert float((Um.mH @ Um - torch.eye(chi, dtype=Um.dtype)).abs().max()) < 1e-10
    P, _ = pull_through(nC, _t(T))
    assert float(torch.linalg.norm(nC - P)) < 1e-6
    nCj, Uj = j_fpcm.isogauge_mps(jnp.asarray(T), C0=jnp.asarray(C))
    for x, ref in ((nC, nCj), (U, Uj)):
        ref = np.asarray(ref)
        assert np.abs(x.numpy() - ref).max() < 1e-8 * np.abs(ref).max()
