"""Parity of the port's factored C4v move (tpeps_torch.ctm.c4v.move_factored,
kernels K1-K4 through their CPU twins) with tpeps.ctm.c4v.move_tpu.

Inputs are built once with numpy (a C4v-symmetrized random state and the
JAX package's CTMRG-initialized environment, carried across with
``tpeps_torch.io.convert``) and fed to both packages.  Contractions agree
to 1e-12 relative (float64, summation order only); a full move from a cold
start agrees to 1e-12 in the spectrum and 1e-10 elementwise in C and T,
where the Procrustes alignment fixes the gauge.
"""

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.ctm.c4v import move_tpu as jm
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps_torch.ctm.c4v import move_factored as tm
from tpeps_torch.io.convert import to_torch
from tpeps_torch.kernels.epilogue import t_epilogue_twin
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CASES = [(2, 8), (3, 18)]
IDS = [f"D{D}_chi{chi}" for D, chi in CASES]


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    D, chi = request.param
    rng = np.random.RandomState(D)
    aj = j_symmetrize(jnp.asarray(rng.rand(2, D, D, D, D) - 0.5), normalize=True)
    envj = j_init_env(aj, chi, "CTMRG")
    at, envt = to_torch(np.asarray(aj), (np.asarray(envj.C), np.asarray(envj.T)), device="cpu")
    P = np.linalg.qr(rng.rand(chi * D * D, chi) - 0.5)[0]
    return dict(D=D, chi=chi, aj=aj, envj=envj, Tj=jm.to_tpu_layout(envj.T, D),
                at=at, envt=envt, Tt=tm.to_int_layout(envt.T, D), P=P)


def test_layout_round_trip(case):
    Tt = case["Tt"]
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(case["Tj"]))
    np.testing.assert_array_equal(tm.from_int_layout(Tt).numpy(), case["envt"].T.numpy())


@pytest.mark.parametrize("slice_phys", [False, True], ids=["full", "slice_phys"])
def test_k1_c2x2_factored(case, slice_phys):
    M6 = np.asarray(jm._c2x2_factored(case["aj"], case["envj"].C, case["Tj"],
                                      slice_phys=slice_phys))
    M2 = tm._c2x2_factored(case["at"], case["envt"].C, case["Tt"], slice_phys=slice_phys)
    # JAX M6[f,g,e,r,j,i] -> the port's M2[(j,e,f),(i,r,g)]
    M2j = M6.transpose(4, 2, 0, 5, 3, 1).reshape(M2.shape)
    assert _rel(M2.numpy(), M2j) < 1e-12


def test_k2_m_apply(case):
    D, chi = case["D"], case["chi"]
    M6 = jm._c2x2_factored(case["aj"], case["envj"].C, case["Tj"])
    Yj = np.asarray(jm._m_apply(M6, jnp.asarray(case["P"]), chi, D))
    M2 = tm._c2x2_factored(case["at"], case["envt"].C, case["Tt"])
    Yt = tm._m_apply(M2, torch.from_numpy(case["P"])).numpy()
    assert _rel(Yt, Yj) < 1e-12


@pytest.mark.parametrize("slice_phys", [False, True], ids=["full", "slice_phys"])
@pytest.mark.parametrize("norm", ["inf", "fro"])
def test_k4_absorb_and_epilogue(case, slice_phys, norm):
    chi = case["chi"]
    nT = jm._absorb_T_int(case["aj"], case["Tj"], jnp.asarray(case["P"]), chi, chi,
                          slice_phys=slice_phys)
    # the epilogue of ctm_move_sl_tpu (move_tpu.py:241-248)
    nT = 0.5 * (nT + jnp.conj(nT.transpose(0, 1, 3, 2)))
    scale = jnp.abs(nT).max() if norm == "inf" else jnp.linalg.norm(nT.ravel())
    nTj = np.asarray(nT / scale)
    nTt = tm.t_epilogue(tm._absorb_T_int(case["at"], case["Tt"], torch.from_numpy(case["P"]),
                                         chi, chi, slice_phys=slice_phys), norm).numpy()
    assert _rel(nTt, nTj) < 1e-12


@pytest.mark.parametrize("slice_phys", [False, True], ids=["full", "slice_phys"])
def test_k1_k4_double_layer_f32(case, slice_phys):
    """The fused double layer's twin in float32 at both call sites, against
    JAX's ``_c2x2_factored`` and ``_absorb_T_int`` on the same float32
    inputs: 1e-5 relative (float32's 6e-8 unit roundoff over sums of up to
    d D^4 = 162 terms and the chi products around them, summed in another
    order by each library)."""
    chi = case["chi"]
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    aj, Cj, Tj, Pj = (jnp.asarray(f32(x)) for x in (case["aj"], case["envj"].C, case["Tj"],
                                                      case["P"]))
    at, Ct, Tt, Pt = (torch.from_numpy(f32(x)) for x in (case["aj"], case["envj"].C,
                                                          case["Tj"], case["P"]))
    M6 = np.asarray(jm._c2x2_factored(aj, Cj, Tj, slice_phys=slice_phys))
    M2 = tm._c2x2_factored(at, Ct, Tt, slice_phys=slice_phys)
    assert M2.dtype == torch.float32
    assert _rel(M2.numpy(), M6.transpose(4, 2, 0, 5, 3, 1).reshape(M2.shape)) < 1e-5
    nTj = np.asarray(jm._absorb_T_int(aj, Tj, Pj, chi, chi, slice_phys=slice_phys))
    nTt = tm._absorb_T_int(at, Tt, Pt, chi, chi, slice_phys=slice_phys)
    assert nTt.dtype == torch.float32
    assert _rel(nTt.numpy(), nTj) < 1e-5


def test_full_move_from_cold_start(case):
    D, chi = case["D"], case["chi"]
    P0 = np.eye(chi * D * D, chi)
    Cj, Tj, specj, Pj = (np.asarray(x) for x in jm.ctm_move_sl_tpu(
        case["aj"], case["envj"].C, case["Tj"], jnp.asarray(P0)))
    Ct, Tt, spect, Pt = (x.numpy() for x in tm.ctm_move_sl_factored(
        case["at"], case["envt"].C, case["Tt"], torch.from_numpy(P0)))
    np.testing.assert_allclose(spect, specj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ct, Cj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Pt, Pj, rtol=0, atol=1e-10)


def test_full_move_complex_state():
    """A complex (A1 + iA2) state on the CPU twins: same move as tpeps."""
    D, chi = 2, 8
    rng = np.random.RandomState(0)
    x = (rng.rand(2, D, D, D, D) - 0.5) + 1j * (rng.rand(2, D, D, D, D) - 0.5)
    aj = j_symmetrize(jnp.asarray(x), normalize=True)
    envj = j_init_env(aj, chi, "CTMRG")
    at, envt = to_torch(np.asarray(aj), (np.asarray(envj.C), np.asarray(envj.T)),
                        device="cpu", dtype=torch.complex128)
    P0 = np.eye(chi * D * D, chi)
    Cj, Tj, specj, _ = (np.asarray(x) for x in jm.ctm_move_sl_tpu(
        aj, envj.C, jm.to_tpu_layout(envj.T, D), jnp.asarray(P0, dtype=jnp.complex128)))
    Ct, Tt, spect, _ = (x.numpy() for x in tm.ctm_move_sl_factored(
        at, envt.C, tm.to_int_layout(envt.T, D), torch.from_numpy(P0).to(torch.complex128)))
    np.testing.assert_allclose(spect, specj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ct, Cj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Tt, Tj, rtol=0, atol=1e-10)


def _jax_epilogue(nT, norm):
    """The epilogue lines of ``ctm_move_sl_tpu`` (move_tpu.py:239-248)."""
    nT = 0.5 * (nT + jnp.conj(nT.transpose(0, 1, 3, 2)))
    scale = jnp.abs(nT).max() if norm == "inf" else jnp.linalg.norm(nT.ravel())
    return nT / scale


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("m", [1, 17, 33])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("norm", ["inf", "fro"])
def test_k4_epilogue_twin_is_jax(norm, dtype, m, batch):
    """K4's twin (the kernel's reference on the card) against JAX's lines:
    the max normalisation bit for bit (the same elementwise operations and
    an exact max), the 2-norm to the summation order (1e-14 f64, 1e-6 f32
    relative)."""
    x = np.random.RandomState(31 * m + batch).uniform(-1, 1, (batch, 1, m, m)).astype(dtype)
    ref = np.asarray(_jax_epilogue(jnp.asarray(x), norm))
    out = t_epilogue_twin(torch.from_numpy(x), norm).numpy()
    assert out.dtype == ref.dtype
    if norm == "inf":
        np.testing.assert_array_equal(out, ref)
    else:
        assert _rel(out, ref) <= (1e-14 if dtype == np.float64 else 1e-6)
