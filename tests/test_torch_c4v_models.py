"""The port's other C4v models against the JAX package's on the CPU: the
energies and ``eval_obs`` of ``ISING_C4V``, ``AKLTS2_C4V_BIPARTITE``, the
three ``JQ_C4V*`` and ``J1J2LAMBDA_C4V_BIPARTITE``, each from one
environment converged by the JAX package and handed to both as numpy arrays
(the d=2 models share one; the S=2 AKLT model and the 16-state plaquette
J-Q model have their own), within 1e-12 relative."""

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.ctm.c4v import env as j_env
from tpeps.ctm.c4v.ctmrg import run_fixed_point as j_run_fixed_point
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.models import akltS2 as j_aklt
from tpeps.models import ising as j_ising
from tpeps.models import j1j2lambda as j_lambda
from tpeps.models import jq as j_jq
from tpeps_torch.ctm.c4v.env import EnvC4v
from tpeps_torch.models import akltS2, ising, j1j2lambda, jq
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
TOL = 1e-12

# name -> (port model, JAX model, phys_dim, complex, energy methods)
MODELS = {
    "ising_nn": (lambda: ising.ISING_C4V(hx=0.7, device=CPU), lambda: j_ising.ISING_C4V(hx=0.7),
                 2, False, ("energy_1x1_nn", "energy_1x1_plaqette")),
    "ising_plaquette": (lambda: ising.ISING_C4V(hx=0.5, q=0.2, device=CPU),
                        lambda: j_ising.ISING_C4V(hx=0.5, q=0.2), 2, False,
                        ("energy_1x1_plaqette",)),
    "aklt": (lambda: akltS2.AKLTS2_C4V_BIPARTITE(device=CPU), j_aklt.AKLTS2_C4V_BIPARTITE, 5,
             False, ("energy_1x1",)),
    "jq": (lambda: jq.JQ_C4V(j1=0.4, q=1.0, device=CPU), lambda: j_jq.JQ_C4V(j1=0.4, q=1.0),
           2, False, ("energy_1x1",)),
    "jq_bipartite": (lambda: jq.JQ_C4V_BIPARTITE(j1=0.4, q=1.0, device=CPU),
                     lambda: j_jq.JQ_C4V_BIPARTITE(j1=0.4, q=1.0), 2, False, ("energy_1x1",)),
    "jq_plaquette": (lambda: jq.JQ_C4V_PLAQUETTE(j1=0.5, q=1.0, q_inter=0.3, device=CPU),
                     lambda: j_jq.JQ_C4V_PLAQUETTE(j1=0.5, q=1.0, q_inter=0.3), 16, False,
                     ("energy_1x1",)),
    "j1j2lambda": (lambda: j1j2lambda.J1J2LAMBDA_C4V_BIPARTITE(j2=0.3, j3=0.1, hz_stag=0.2,
                                                               lmbd=0.4, device=CPU),
                   lambda: j_lambda.J1J2LAMBDA_C4V_BIPARTITE(j2=0.3, j3=0.1, hz_stag=0.2,
                                                             lmbd=0.4),
                   2, True, ("energy_1x1",)),
}
ENVS = {2: (0, 2, 12), 5: (1, 2, 8), 16: (2, 2, 8)}  # phys_dim -> (seed, D, chi)


@pytest.fixture(scope="module")
def envs():
    """One JAX-converged environment per physical dimension, as numpy."""
    out = {}
    for d, (seed, D, chi) in ENVS.items():
        rng = np.random.RandomState(seed)
        a = j_symmetrize(jnp.asarray(rng.rand(d, D, D, D, D) - 0.5), normalize=True)
        env, *_ = j_run_fixed_point(a, j_env.init_env(a, chi, "CTMRG"), max_iter=200,
                                    conv_tol=1e-11)
        out[d] = (np.asarray(a), np.asarray(env.C), np.asarray(env.T))
    return out


def _inputs(envs, d, cplx):
    a, C, T = envs[d]
    if cplx:
        a, C, T = (x.astype(np.complex128) for x in (a, C, T))
    jx = (jnp.asarray(a), j_env.EnvC4v(jnp.asarray(C), jnp.asarray(T)))
    pt = (torch.from_numpy(a.copy()), EnvC4v(torch.from_numpy(C.copy()),
                                             torch.from_numpy(T.copy())))
    return jx, pt


def _close(x, ref):
    x, ref = complex(x), complex(ref)
    assert abs(x - ref) <= TOL * max(abs(ref), 1.0), (x, ref)


@pytest.mark.parametrize("name", list(MODELS))
def test_c4v_model_matches_jax(envs, name):
    make, make_j, d, cplx, energies = MODELS[name]
    model, jmodel = make(), make_j()
    assert model.phys_dim == jmodel.phys_dim == d
    (aj, ej), (at, et) = _inputs(envs, d, cplx)
    for f in energies:
        _close(getattr(model, f)(at, et), getattr(jmodel, f)(aj, ej))
    vals, labels = model.eval_obs(at, et)
    jvals, jlabels = jmodel.eval_obs(aj, ej)
    assert labels == jlabels
    for v, jv in zip(vals, jvals):
        _close(v, jv)
