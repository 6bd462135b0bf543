"""The port's observables entry point and the transfer spectra of its
optimization entry point, on the CPU.

``tpeps_torch.examples.j1j2.ctmrg_j1j2_c4v --GLOBALARGS_device cpu`` at D=2,
chi=16 on a written state against the JAX package's library calls on the
same file (``run_fixed_point``, ``energy_1x1_lowmem``, ``eval_corrf_SS``,
``get_Top_spec_c4v``; the JAX script itself reads pytest's argv at import):
each side converges its own environment to conv_tol 1e-12, so the energy and
the correlators agree within 1e-9 and the spectrum within 1e-8.
``optim_j1j2_c4v --top_freq 1`` prints a ``TOP`` line each epoch; with
``--top_freq 0`` it prints none and runs.
"""

import json

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.ctm.c4v.ctmrg import run_fixed_point as j_run_fixed_point
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ctm.c4v.transferops import get_Top_spec_c4v as j_top_spec
from tpeps.ipeps.ipeps_c4v import read_ipeps_c4v as j_read, symmetrize_c4v as j_symmetrize
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch.examples.j1j2 import ctmrg_j1j2_c4v, optim_j1j2_c4v
from tpeps_torch.ipeps.ipeps_c4v import IPEPS_C4V
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

D, CHI, J2, CORRF_R, TOP_N = 2, 16, 0.3, 3, 3


@pytest.fixture(scope="module")
def instate(tmp_path_factory):
    path = tmp_path_factory.mktemp("state") / "d2_state.json"
    a = np.random.RandomState(3).rand(2, D, D, D, D) - 0.5
    IPEPS_C4V(torch.from_numpy(a)).write_to_file(str(path))
    return str(path)


def test_ctmrg_j1j2_c4v_matches_jax(instate, capsys):
    e, obs, labels, out = ctmrg_j1j2_c4v.main([
        "--GLOBALARGS_device", "cpu", "--instate", instate, "--bond_dim", str(D),
        "--chi", str(CHI), "--j2", str(J2), "--CTMARGS_ctm_max_iter", "300",
        "--CTMARGS_ctm_conv_tol", "1e-12", "--corrf_r", str(CORRF_R), "--top_n", str(TOP_N)])
    printed = capsys.readouterr().out
    assert "FINAL" in printed and f"SS r={CORRF_R}" in printed

    site = j_read(instate).site()
    a = j_symmetrize(site / jnp.linalg.norm(site), normalize=True)
    env, *_ = j_run_fixed_point(a, j_init_env(a, CHI, "CTMRG"), max_iter=300, conv_tol=1e-12)
    model = J_J1J2(j1=1.0, j2=J2)
    assert abs(e - float(model.energy_1x1_lowmem(a, env))) < 1e-9
    jobs, jlabels = model.eval_obs(a, env)
    assert labels == jlabels
    np.testing.assert_allclose(np.array(obs, dtype=complex), np.array(jobs, dtype=complex),
                               rtol=0, atol=1e-9)
    ss = np.asarray(model.eval_corrf_SS(a, env, CORRF_R)["ss"])
    assert out["ss"].shape == ss.shape == (CORRF_R + 1,)
    assert np.abs(out["ss"].numpy() - ss).max() < 1e-9
    top = np.asarray(j_top_spec(TOP_N, a, env))
    assert np.abs(out["top"] - top).max() < 1e-8


@pytest.mark.parametrize("top_freq", [1, 0])
def test_optim_top_freq(tmp_path, capsys, top_freq):
    optim_j1j2_c4v.main([
        "--GLOBALARGS_device", "cpu", "--bond_dim", "2", "--chi", "8", "--opt_max_iter", "1",
        "--CTMARGS_projector_svd_method", "POWER", "--OPTARGS_line_search", "backtracking",
        "--OPTARGS_line_search_svd_method", "POWER", "--out_prefix", str(tmp_path / "opt"),
        "--top_freq", str(top_freq), "--top_n", str(TOP_N)])
    tops = [l for l in capsys.readouterr().out.splitlines() if l.startswith("TOP ")]
    if top_freq == 0:
        assert not tops
        return
    assert len(tops) == 1
    spec = json.loads(tops[0][4:])
    assert len(spec["re"]) == len(spec["im"]) == TOP_N
    assert abs(np.hypot(spec["re"][0], spec["im"][0]) - 1.0) < 1e-12
