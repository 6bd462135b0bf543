"""The C4v observables of the port against the JAX package's on the CPU:
the Krylov solvers, the correlation functions and transfer spectra, the
full RDM set and the J1-J2 energies and correlators
(``tpeps_torch.linalg.arnoldi``, ``ctm/c4v/{corrf,transferops,rdm,env}``,
``ctm/generic/{corrf,transferops}``, ``models/j1j2``).

Each environment is converged once by the JAX package (``run_fixed_point``)
and handed to both packages as numpy arrays, so neither side's convergence
enters a comparison.  Tolerances: single contractions, RDMs and energies
1e-12 relative to the largest entry; Arnoldi's leading eigenvalues and the
spectra 1e-10; C4v against the generic evaluators 1e-8; ``energy_1x1``
against ``energy_1x1_lowmem`` 1e-10.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.ctm.c4v import corrf as j_corrf
from tpeps.ctm.c4v import env as j_env
from tpeps.ctm.c4v import rdm as j_rdm
from tpeps.ctm.c4v import transferops as j_top
from tpeps.ctm.c4v.ctmrg import run_fixed_point as j_run_fixed_point
from tpeps.ctm.generic import corrf as j_gcorrf
from tpeps.ctm.generic import transferops as j_gtop
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.linalg import arnoldi as j_arnoldi
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch.ctm.c4v import corrf, rdm, transferops
from tpeps_torch.ctm.c4v.env import EnvC4v, compute_multiplets, env_c4v_to_generic
from tpeps_torch.ctm.generic import corrf as gcorrf
from tpeps_torch.ctm.generic.transferops import (get_EH_spec_Ttensor,
                                                 get_full_EH_spec_Ttensor, get_Top_spec)
from tpeps_torch.groups import su2
from tpeps_torch.linalg import arnoldi
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
J2 = 0.3


def close(x, ref, tol):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape, (x.shape, ref.shape)
    err = np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, f"relative max error {err:.3e} > {tol:.0e}"


def _converged(seed, D, chi, max_iter=200):
    """A C4v site and its environment converged by the JAX package, as numpy
    arrays and as both packages' inputs."""
    rng = np.random.RandomState(seed)
    a = np.asarray(j_symmetrize(jnp.asarray(rng.rand(2, D, D, D, D) - 0.5), normalize=True))
    env, *_ = j_run_fixed_point(jnp.asarray(a), j_env.init_env(jnp.asarray(a), chi, "CTMRG"),
                                max_iter=max_iter, conv_tol=1e-11)
    C, T = np.asarray(env.C), np.asarray(env.T)
    jx = (jnp.asarray(a), j_env.EnvC4v(jnp.asarray(C), jnp.asarray(T)))
    pt = (torch.from_numpy(a.copy()), EnvC4v(torch.from_numpy(C.copy()),
                                             torch.from_numpy(T.copy())))
    return jx, pt


@pytest.fixture(scope="module")
def d2():
    return _converged(0, 2, 16)


@pytest.fixture(scope="module")
def d3():
    return _converged(9, 3, 10)


def _ops(d=2):
    s2 = su2.SU2(d, dtype=torch.float64, device=CPU)
    sz, sp, sm = s2.SZ(), s2.SP(), s2.SM()
    return {"sz": sz, "sx": 0.5 * (sp + sm), "SS": s2.SS()}


# --- Arnoldi ---------------------------------------------------------------

def _matrix(kind, n=120):
    """A map with separated leading eigenvalues: hermitian for Lanczos, else
    a similarity transform of a decaying spectrum with a complex pair."""
    rng = np.random.RandomState(4)
    lam = 0.8 ** np.arange(n)
    if kind == "lanczos":
        Q, _ = np.linalg.qr(rng.rand(n, n) - 0.5)
        return (Q * (lam * np.where(np.arange(n) % 3 == 1, -1, 1))) @ Q.T
    S = rng.rand(n, n) - 0.5 + 3 * np.eye(n)
    M = np.diag(lam)
    M[2:4, 2:4] = [[lam[2], 0.3], [-0.3, lam[2]]]
    return S @ M @ np.linalg.inv(S)


@pytest.mark.parametrize("fn", ["arnoldi_eigs", "arnoldi_eigs_vecs", "lanczos_eigsh"])
def test_arnoldi_matches_jax(fn):
    M = _matrix("lanczos" if fn == "lanczos_eigsh" else "general")
    v0 = np.random.RandomState(1234).rand(M.shape[0]) - 0.5
    Mt, Mj = torch.from_numpy(M), jnp.asarray(M)
    got = getattr(arnoldi, fn)(lambda v: Mt @ v, torch.from_numpy(v0), 4, m=40)
    ref = getattr(j_arnoldi, fn)(lambda v: Mj @ v, jnp.asarray(v0), 4, m=40)
    if fn == "arnoldi_eigs_vecs":
        (got, X), (ref, Xr) = got, ref
        # Ritz vectors agree up to a phase
        ov = np.abs(np.einsum("ik,ik->k", X.conj(), np.asarray(Xr)))
        assert np.abs(ov - 1).max() < 1e-10, ov
        for k in range(4):
            res = M @ X[:, k] - got[k] * X[:, k]
            assert np.linalg.norm(res) < 1e-8 * abs(got[k])
    close(got, np.asarray(ref), 1e-10)
    w = np.linalg.eigvals(M)
    close(np.sort(np.abs(got))[::-1], np.sort(np.abs(w))[::-1][:4], 1e-10)


# --- transfer matrices and correlation functions ---------------------------

@pytest.mark.parametrize("op", [None, "sz"])
def test_apply_TM_1sO_and_edges(d2, op):
    (aj, ej), (at, et) = d2
    o = None if op is None else _ops()[op]
    E0t, E0j = corrf.get_edge(et), j_corrf.get_edge(ej)
    close(E0t, E0j, 1e-12)
    Et = corrf.apply_TM_1sO(at, et, E0t, op=o)
    Ej = j_corrf.apply_TM_1sO(aj, ej, E0j, op=None if o is None else jnp.asarray(o.numpy()))
    close(Et, Ej, 1e-12)
    close(corrf.apply_edge(et, Et), j_corrf.apply_edge(ej, Ej), 1e-12)


def test_apply_TM_two_site(d2):
    (aj, ej), (at, et) = d2
    SS = _ops()["SS"]
    E0t, E0j = corrf.get_edge(et), j_corrf.get_edge(ej)
    close(corrf.apply_TM_2sO(at, et, E0t, op2=SS),
          j_corrf.apply_TM_2sO(aj, ej, E0j, op2=jnp.asarray(SS.numpy())), 1e-12)
    W0t, W0j = corrf.get_edge2(et), j_corrf.get_edge2(ej)
    close(W0t, W0j, 1e-12)
    close(corrf.apply_TM_1sO_2(at, et, W0t, op2=SS),
          j_corrf.apply_TM_1sO_2(aj, ej, W0j, op2=jnp.asarray(SS.numpy())), 1e-12)


@pytest.mark.parametrize("fn", ["corrf_1sO1sO", "corrf_2sOH2sOH_E1", "corrf_2sOV2sOV_E2"])
def test_corrf_matches_jax(d2, fn):
    (aj, ej), (at, et) = d2
    ops = _ops()
    o1, o2 = (ops["sz"], ops["sx"]) if fn == "corrf_1sO1sO" else (ops["SS"], ops["SS"])
    o1j, o2j = jnp.asarray(o1.numpy()), jnp.asarray(o2.numpy())
    got = getattr(corrf, fn)(at, et, o1, lambda r: o2 if r % 2 else o1, 3)
    ref = getattr(j_corrf, fn)(aj, ej, o1j, lambda r: o2j if r % 2 else o1j, 3)
    close(got, ref, 1e-12)


@pytest.mark.parametrize("width", [1, 2])
def test_top_spec_matches_jax(d2, width):
    (aj, ej), (at, et) = d2
    f = "get_Top_spec_c4v" if width == 1 else "get_Top2_spec_c4v"
    got = getattr(transferops, f)(4, at, et)
    ref = np.asarray(getattr(j_top, f)(4, aj, ej))
    close(got, ref, 1e-10)
    assert abs(np.hypot(*got[0]) - 1.0) < 1e-12


def _duck(a, sites, site_of, C, T):
    """Duck-typed single-site state and environment over a generic
    environment, as the generic evaluators of either package read them."""
    st = SimpleNamespace(lX=1, lY=1, sites=sites, vertexToSite=site_of,
                         site=lambda coord=(0, 0): a)
    return st, SimpleNamespace(chi=C[(0, 0), (-1, -1)].shape[0], C=C, T=T)


def _generic(a, env):
    return _duck(a, *env_c4v_to_generic(a, env))


def test_eh_spec_c4v(d2):
    """Twin of the JAX test of the same name: the EH spectrum leads with 1,
    the generic-env expansion gives the C4v width-1 spectrum (1e-8), and the
    EH spectrum is JAX's (1e-10)."""
    (aj, ej), (at, et) = d2
    S = transferops.get_EH_spec_Ttensor_c4v(4, 3, at, et)
    w = S[:, 0] + 1j * S[:, 1]
    assert abs(abs(w[0]) - 1.0) < 1e-12
    assert np.all(np.abs(w[1:]) <= 1.0 + 1e-12)
    close(S, np.asarray(j_top.get_EH_spec_Ttensor_c4v(4, 3, aj, ej)), 1e-10)
    st, e = _generic(at, et)
    s_c4v = transferops.get_Top_spec_c4v(4, at, et)
    s_gen = get_Top_spec(4, (0, 0), (1, 0), st, e)
    assert np.abs(np.hypot(*s_c4v.T) - np.hypot(*s_gen.T)).max() < 1e-8


@pytest.mark.parametrize("direction", [(1, 0), (0, -1), (0, 1), (-1, 0)])
@pytest.mark.parametrize("kind", ["c4v", "random_T"])
def test_full_eh_spec_matches_jax(d2, kind, direction):
    """The dense EH spectrum at L=3 on the expanded 1x1 environment and on
    one whose T tensors are random (no symmetry hides a leg order): JAX's
    eigenvalues (1e-10) and, on the leading four, the magnitudes of the
    Krylov ``get_EH_spec_Ttensor`` (1e-8)."""
    (aj, ej), (at, et) = d2
    sites, site_of, C, T = env_c4v_to_generic(at, et)
    if kind == "random_T":
        rng = np.random.RandomState(5)
        T = {k: torch.from_numpy(rng.rand(*v.shape) - 0.3) for k, v in sorted(T.items())}
    st, e = _duck(at, sites, site_of, C, T)
    jsites, jsite_of, jC, _ = j_env.env_c4v_to_generic(aj, ej)
    stj, ejg = _duck(aj, jsites, jsite_of, jC, {k: jnp.asarray(v.numpy()) for k, v in T.items()})
    full = get_full_EH_spec_Ttensor(3, (0, 0), direction, st, e)
    ref = j_gtop.get_full_EH_spec_Ttensor(3, (0, 0), direction, stj, ejg)
    close(np.abs(full), np.abs(ref), 1e-10)
    close(np.sort_complex(full), np.sort_complex(ref), 1e-10)
    it = get_EH_spec_Ttensor(4, 3, (0, 0), direction, st, e)
    close(np.abs(full[:4]), np.hypot(*it.T), 1e-8)


def test_c4v_width2_transfer_spec(d2):
    """Twin of the JAX test: width-1 and width-2 spectra finite, the width-2
    one normalized and descending."""
    _, (at, et) = d2
    lam1 = np.hypot(*transferops.get_Top_spec_c4v(3, at, et).T)
    lam2 = np.hypot(*transferops.get_Top2_spec_c4v(3, at, et).T)
    assert np.all(np.isfinite(lam1)) and np.all(np.isfinite(lam2))
    assert abs(lam2[0] - 1.0) < 1e-10
    assert np.all(np.diff(lam2) < 1e-8)


def test_c4v_dimer_dimer_matches_generic(d2):
    """Twin of the JAX test: the C4v dimer-dimer correlators against the
    generic ones on the expanded 1x1 environment (1e-8)."""
    _, (at, et) = d2
    sites, site_of, C, T = env_c4v_to_generic(at, et)
    SS = _ops()["SS"]
    close(corrf.corrf_2sOH2sOH_E1(at, et, SS, lambda r: SS, 3),
          gcorrf.corrf_2sOH2sOH_E1((0, 0), (1, 0), sites, site_of, C, T, SS, lambda r: SS, 3),
          1e-8)
    close(corrf.corrf_2sOV2sOV_E2(at, et, SS, lambda r: SS, 3),
          gcorrf.corrf_2sOV2sOV_E2((0, 0), (1, 0), sites, site_of, C, T, SS, lambda r: SS, 3),
          1e-8)
    sz = _ops()["sz"]
    for direction in ((1, 0), (0, 1)):
        close(corrf.corrf_1sO1sO(at, et, sz, lambda r: sz, 3),
              gcorrf.corrf_1sO1sO((0, 0), direction, sites, site_of, C, T, sz, lambda r: sz, 3),
              1e-8)


def test_generic_corrf_matches_jax(d2):
    (aj, ej), (at, et) = d2
    sites, site_of, C, T = env_c4v_to_generic(at, et)
    jsites, jsite_of, jC, jT = j_env.env_c4v_to_generic(aj, ej)
    SS = _ops()["SS"]
    SSj = jnp.asarray(SS.numpy())
    for fn in ("corrf_2sOH2sOH_E1", "corrf_2sOV2sOV_E2"):
        close(getattr(gcorrf, fn)((0, 0), (1, 0), sites, site_of, C, T, SS, lambda r: SS, 2),
              getattr(j_gcorrf, fn)((0, 0), (1, 0), jsites, jsite_of, jC, jT, SSj,
                                    lambda r: SSj, 2), 1e-12)
    for direction in ((1, 0), (0, -1), (0, 1), (-1, 0)):
        close(gcorrf.get_edge((0, 0), direction, sites, site_of, C, T),
              j_gcorrf.get_edge((0, 0), direction, jsites, jsite_of, jC, jT), 1e-12)


def test_env_c4v_to_generic_and_multiplets(d2):
    (aj, ej), (at, et) = d2
    _, _, C, T = env_c4v_to_generic(at, et)
    _, _, jC, jT = j_env.env_c4v_to_generic(aj, ej)
    assert C.keys() == jC.keys() and T.keys() == jT.keys()
    for k in T:
        np.testing.assert_array_equal(T[k].numpy(), np.asarray(jT[k]))
    for k in C:
        np.testing.assert_array_equal(C[k].numpy(), np.asarray(jC[k]))
    D, m = compute_multiplets(et.C, 1e-6)
    Dj, mj = j_env.compute_multiplets(ej.C, 1e-6)
    close(D, np.asarray(Dj), 1e-12)
    assert m == mj and sum(m) == et.C.shape[0]


# --- RDMs and energies -----------------------------------------------------

RDMS = ["rdm1x1_sl", "rdm1x1", "rdm2x1", "rdm3x1", "rdm2x2", "rdm2x1_tiled",
        "rdm2x2_NN_tiled", "rdm2x2_NNN_tiled"]


@pytest.mark.parametrize("sym_pos_def", [False, True], ids=["plain", "psd"])
@pytest.mark.parametrize("name", RDMS)
def test_rdm_matches_jax(d2, name, sym_pos_def):
    (aj, ej), (at, et) = d2
    close(getattr(rdm, name)(at, et, sym_pos_def=sym_pos_def),
          getattr(j_rdm, name)(aj, ej, sym_pos_def=sym_pos_def), 1e-12)


@pytest.mark.parametrize("name", ["aux_rdm1x1", "ddA_rdm1x1"])
def test_aux_rdms_match_jax(d3, name):
    (aj, ej), (at, et) = d3
    if name == "aux_rdm1x1":
        close(rdm.aux_rdm1x1(et, 3), j_rdm.aux_rdm1x1(ej, 3), 1e-12)
    else:
        close(rdm.ddA_rdm1x1(at, et), j_rdm.ddA_rdm1x1(aj, ej), 1e-12)


@pytest.mark.parametrize("j3", [0.0, 0.1])
def test_energy_1x1_matches_jax(d2, j3):
    (aj, ej), (at, et) = d2
    model = J1J2_C4V_BIPARTITE(j2=J2, j3=j3, device=CPU)
    jmodel = J_J1J2(j2=J2, j3=j3)
    e = float(model.energy_1x1(at, et))
    close(e, float(jmodel.energy_1x1(aj, ej)), 1e-12)
    close(float(model.energy_1x1_tiled(at, et)), float(jmodel.energy_1x1_tiled(aj, ej)), 1e-12)
    assert abs(e - float(model.energy_1x1_lowmem(at, et))) < 1e-10


def test_aux_rdm1x1_properties(d3):
    """Twin of the JAX test: the aux RDM with the site's ket and bra layers,
    hermitized and normalized, is rdm1x1_sl."""
    _, (a, env) = d3
    rho = rdm.aux_rdm1x1(env, a.shape[1])
    num = torch.einsum("uldrULDR,suldr,zULDR->sz", rho, a, a.conj())
    num = 0.5 * (num + num.conj().T)
    rec = num / torch.trace(num)
    assert float((rec - rdm.rdm1x1_sl(a, env)).abs().max()) < 1e-13


def test_ddA_rdm1x1_is_norm_gradient(d3):
    """Twin of the JAX test, with torch autograd for ``jax.grad``: the frame
    with the ket gives the unnormalized rdm1x1, and the gradient of the
    norm closure is twice the frame."""
    _, (a, env) = d3
    dd = rdm.ddA_rdm1x1(a, env)
    rho_un = torch.einsum("zuldr,suldr->sz", dd, a)
    rho = rdm.rdm1x1(a, env)
    assert float((rho_un / torch.trace(rho_un) - rho / torch.trace(rho)).abs().max()) < 1e-10
    x = a.clone().requires_grad_(True)
    norm = torch.einsum("zuldr,zuldr->", rdm.ddA_rdm1x1(x, env), x)
    (g,) = torch.autograd.grad(norm, x)
    assert float((g / 2.0 - dd).abs().max()) < 1e-8


@pytest.mark.parametrize("kind", ["SS", "DD_H", "DD_V"])
def test_eval_corrf_matches_jax(d2, kind):
    (aj, ej), (at, et) = d2
    model, jmodel = J1J2_C4V_BIPARTITE(j2=J2, device=CPU), J_J1J2(j2=J2)
    got = getattr(model, f"eval_corrf_{kind}")(at, et, 3)
    ref = getattr(jmodel, f"eval_corrf_{kind}")(aj, ej, 3)
    assert got.keys() == ref.keys()
    for k in got:
        close(got[k], ref[k], 1e-12)
    if kind == "SS":
        obs, labels = model.eval_obs(at, et)
        assert abs(float(got["ss"][0]) - obs[labels.index("SS2x1")]) < 1e-12
