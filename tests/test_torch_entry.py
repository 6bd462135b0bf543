"""The port's optimization entry point against the JAX package's on the CPU.

The same numpy site goes to ``examples/optim_common_c4v.py:optimize_c4v``
(JAX) and to ``tpeps_torch.examples.optim_common_c4v.optimize_c4v`` (the
port, kernels on their CPU twins), float64, D=2, chi=8: POWER projector for
the gradient and the line search, SYMEIG for the observables and the final
energy, in both.  Tolerance: the final energy and the best stored site to
1e-8 (two epochs of L-BFGS on gradients that agree to ~1e-10 relative).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.config import Config as J_Config
from tpeps.config import CtmArgs as J_CtmArgs
from tpeps.config import MainArgs as J_MainArgs
from tpeps.config import OptArgs as J_OptArgs
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch.examples.optim_common_c4v import converge_c4v, optimize_c4v
from tpeps_torch.io.convert import config_from_dict, to_torch
from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CHI, D, J2 = 8, 2, 0.3
ROOT = Path(__file__).resolve().parents[1]


def _jax_optim_common():
    spec = importlib.util.spec_from_file_location(
        "jax_optim_common_c4v", ROOT / "examples" / "optim_common_c4v.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfgs(prefix_j, prefix_t, epochs=2):
    jcfg = J_Config(
        main=J_MainArgs(opt_max_iter=epochs, chi=CHI, bond_dim=D, out_prefix=prefix_j),
        ctm=J_CtmArgs(projector_svd_method="POWER", ctm_max_iter=150, ctm_conv_tol=1e-11,
                      grad_mode="implicit", grad_adjoint_max_iter=200,
                      grad_adjoint_tol=1e-10),
        opt=J_OptArgs(line_search="backtracking", line_search_svd_method="POWER"),
    )
    d = dataclasses.asdict(jcfg)
    d["main"]["out_prefix"] = prefix_t
    d["global_args"]["device"] = "cpu"
    return jcfg, config_from_dict(d)


def test_optimize_c4v_matches_jax(tmp_path):
    jcfg, cfg = _cfgs(str(tmp_path / "jax"), str(tmp_path / "torch"))
    # RandomState(2), the canonical test's state: both packages' fixed points
    # agree elementwise (for some states init_env's eigenvector signs put
    # the two in different gauges, and the gradients then differ at ~1e-7)
    A0 = np.random.RandomState(2).rand(2, D, D, D, D) - 0.5
    A0 /= np.linalg.norm(A0)

    jmodel = J_J1J2(j1=1.0, j2=J2)
    e_j, a_j, _ = _jax_optim_common().optimize_c4v(
        jcfg, jmodel, jmodel.energy_1x1_lowmem, jnp.asarray(A0))

    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=J2, device=CPU)
    e_t, a_t, env_t, history = optimize_c4v(cfg, model, model.energy_1x1_lowmem,
                                            to_torch(A0, device=CPU))
    assert len(history["loss"]) == 2
    assert abs(e_t - e_j) < 1e-8, (e_t, e_j)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-8)
    assert env_t.C.device == CPU


def test_converge_c4v_defaults_to_symeig():
    """With no projector given, the no-grad environment is SYMEIG's (the
    observables' and the final energy's), whatever the configured
    projector, as in the JAX script."""
    _, cfg = _cfgs("", "")
    a = symmetrize_c4v(to_torch(np.random.RandomState(5).rand(2, D, D, D, D) - 0.5,
                                device=CPU), normalize=True)
    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=J2, device=CPU)
    e_default = float(model.energy_1x1_lowmem(a, converge_c4v(cfg, a)))
    e_symeig = float(model.energy_1x1_lowmem(a, converge_c4v(cfg, a, "SYMEIG")))
    e_power = float(model.energy_1x1_lowmem(a, converge_c4v(cfg, a, "POWER")))
    assert e_default == e_symeig
    assert abs(e_power - e_symeig) < 1e-8
