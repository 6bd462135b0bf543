"""Parity of the port's forward linalg (tpeps_torch.linalg) with tpeps.

The same numpy inputs go to ``tpeps.linalg`` (JAX on the CPU, float64)
and to ``tpeps_torch.linalg`` (torch on the CPU, float64, where the
kernel wrappers run their plain twins).  Tolerance 1e-12: the two sides
run the same algorithm in float64 and differ only in summation order.
"""

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax.numpy as jnp

from tpeps.linalg import eigh as j_eigh
from tpeps.linalg import power as j_power
from tpeps_torch.linalg import eigh as t_eigh
from tpeps_torch.linalg import power as t_power
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12


def _tall(n, k, seed):
    return np.random.RandomState(seed).rand(n, k) - 0.5


def _orthonormal(n, k, seed):
    return np.linalg.qr(_tall(n, k, seed))[0]


def _with_doublets(seed=0):
    """Symmetric 12x12 matrix whose spectrum has exact doublets."""
    d = np.array([3.0, -2.0, -2.0, 1.5, 1.5, 1.0, 0.5, 0.5, 0.25, -0.1, -0.1, 0.05])
    U = _orthonormal(12, 12, seed)
    return (U * d) @ U.T


def _cold_start(n, k, seed):
    """The first k columns of a symmetric M with a fast-decaying spectrum of
    mixed signs: what the move's first CholeskyQR2 sees, M2 times
    cold_start_basis (identity columns)."""
    rs = np.random.RandomState(seed)
    U = np.linalg.qr(rs.rand(n, n) - 0.5)[0]
    lam = np.exp(-np.arange(n) / 1.5) * np.where(rs.rand(n) < 0.5, -1.0, 1.0)
    return ((U * lam) @ U.T)[:, :k]


def _graded(n, k, seed, cond):
    """A tall basis with singular values log-spaced from 1 to 1/cond."""
    rs = np.random.RandomState(seed)
    Q1 = np.linalg.qr(rs.rand(n, k) - 0.5)[0]
    Q2 = np.linalg.qr(rs.rand(k, k) - 0.5)[0]
    return (Q1 * np.logspace(0, -np.log10(cond), k)) @ Q2.T


@pytest.mark.parametrize("basis", ["cold_start", "ill_conditioned"])
def test_cholesky_qr2_on_ill_conditioned_bases(basis):
    """The port's CholeskyQR2 (its kernels' twins on the CPU) against JAX's
    on the bases whose first pass has an ill-conditioned L, the kinds the
    card's solves are held to in chip_smoke.py phase 2: the cold start (cond
    ~7e5) and a graded basis (cond 1e5).  Both run the same backward-stable
    algorithm, and a backward error of k u moves Q by up to cond(P) times
    it: Q agrees to k u cond(P); both are orthonormal to 1e-11 (the 1e-12
    ridge)."""
    n, k = 300, 18
    P = _cold_start(n, k, seed=5) if basis == "cold_start" else _graded(n, k, seed=6, cond=1e5)
    Qj = np.asarray(j_power.cholesky_qr2(jnp.asarray(P)))
    Qt = t_power.cholesky_qr2(torch.from_numpy(P)).numpy()
    tol = k * np.finfo(np.float64).eps / 2 * np.linalg.cond(P)
    assert np.abs(Qt - Qj).max() <= tol
    for Q in (Qt, Qj):
        assert np.abs(Q.T @ Q - np.eye(k)).max() <= 1e-11


def test_eigh_desc_on_exact_degenerate_pairs():
    """eigh_desc (the eigh_small path for a real k <= 169; its twin here)
    against JAX's on a spectrum of exact pairs, as the C4v double layer
    gives, and one quadruplet: eigenvalues to 1e-12, and the projector onto
    each multiplet to 1e-10 (inside a multiplet the eigenvectors are a free
    rotation)."""
    vals = np.array([2.0, -1.5, 1.1, 0.7, -0.6, 0.3, 0.2])
    d = np.concatenate([np.repeat(vals, 2), np.full(4, -0.05)])
    U = _orthonormal(18, 18, seed=7)
    A = (U * d) @ U.T
    A = 0.5 * (A + A.T)
    Dj, Uj = (np.asarray(x) for x in j_eigh.eigh_desc(jnp.asarray(A)))
    Dt, Ut = (x.numpy() for x in t_eigh.eigh_desc(torch.from_numpy(A)))
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=TOL)
    for lo, hi in [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 14), (14, 18)]:
        np.testing.assert_allclose(Ut[:, lo:hi] @ Ut[:, lo:hi].T, Uj[:, lo:hi] @ Uj[:, lo:hi].T,
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("zero_cols", [0, 3], ids=["full_rank", "zero_columns"])
def test_cholesky_qr2(zero_cols):
    P = _tall(60, 12, seed=1)
    P[:, 12 - zero_cols:] = 0.0  # the ridge keeps the Cholesky finite
    Qj = np.asarray(j_power.cholesky_qr2(jnp.asarray(P)))
    Qt = t_power.cholesky_qr2(torch.from_numpy(P)).numpy()
    assert np.isfinite(Qt).all()
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=TOL)


def test_eigh_desc_and_multiplet_mask_on_doublets():
    A = _with_doublets()
    Dj, Uj = (np.asarray(x) for x in j_eigh.eigh_desc(jnp.asarray(A)))
    Dt, Ut = (x.numpy() for x in t_eigh.eigh_desc(torch.from_numpy(A)))
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=TOL)
    # eigenvectors inside a doublet are a free rotation: compare the
    # spectral projector of every multiplet instead
    for lo, hi in [(0, 1), (1, 3), (3, 5), (5, 6), (6, 8), (8, 9), (9, 11), (11, 12)]:
        Pj = Uj[:, lo:hi] @ Uj[:, lo:hi].T
        Pt = Ut[:, lo:hi] @ Ut[:, lo:hi].T
        np.testing.assert_allclose(Pt, Pj, rtol=0, atol=1e-10)
    for chi in (2, 3, 4, 5, 7, 8, 10):  # cuts inside and between doublets
        mj = np.asarray(j_eigh.multiplet_mask(jnp.asarray(Dj), chi, eps_multiplet=1e-12))
        mt = t_eigh.multiplet_mask(torch.from_numpy(Dt), chi, eps_multiplet=1e-12)
        assert mt.dtype == torch.float64
        np.testing.assert_array_equal(mt.numpy(), mj)


def test_multiplet_mask_keeps_the_spectrum_dtype():
    D = torch.tensor([2.0, 1.0, 1.0, 0.5], dtype=torch.float32)
    assert t_eigh.multiplet_mask(D, 2).dtype == torch.float32


@pytest.mark.parametrize("n,dtype,kernel", [(12, torch.float64, True),
                                             (169, torch.float64, True),
                                             (170, torch.float64, False),
                                             (12, torch.complex128, False)],
                         ids=["real_small", "real_169", "real_170", "complex"])
def test_eigh_desc_takes_eigh_small_for_real_up_to_169(monkeypatch, n, dtype, kernel):
    """One decision, in linalg/eigh: a real matrix of size up to 169 goes to
    the eigh_small kernel's wrapper (its twin here, on the CPU), any other to
    torch.linalg.eigh; both give the descending-|D| decomposition."""
    calls, eigh_small = [], t_eigh.eigh_small
    monkeypatch.setattr(t_eigh, "eigh_small", lambda A: calls.append(A.shape) or eigh_small(A))
    rng = np.random.RandomState(3)
    A = rng.rand(n, n) - 0.5
    if dtype.is_complex:
        A = A + 1j * (rng.rand(n, n) - 0.5)
    A = torch.from_numpy(0.5 * (A + A.conj().T)).to(dtype)
    D, U = t_eigh.eigh_desc(A)
    assert calls == ([(n, n)] if kernel else [])
    assert torch.all(D.abs()[:-1] >= D.abs()[1:])
    err = ((U * D.to(dtype)) @ U.mH - A).abs().max()
    assert float(err) < 1e-12 * n


@pytest.mark.parametrize("chi", [4, 6])
def test_truncated_eigh_sym(chi):
    A = _with_doublets(seed=2)
    Dj, Uj = (np.asarray(x) for x in j_eigh.truncated_eigh_sym(jnp.asarray(A), chi))
    Dt, Ut = (x.numpy() for x in t_eigh.truncated_eigh_sym(torch.from_numpy(A), chi))
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=TOL)
    np.testing.assert_allclose(Ut @ Ut.T, Uj @ Uj.T, rtol=0, atol=1e-10)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "col_mask"])
def test_procrustes_align(masked):
    n, k = 40, 8
    P = _orthonormal(n, k, seed=3)
    P_ref = _orthonormal(n, k, seed=4)
    mask = np.ones(k)
    if masked:
        mask[-2:] = 0.0
        P = P * mask[None, :]
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    PWj, Wj = (np.asarray(x) for x in j_power.procrustes_align(jnp.asarray(P), jnp.asarray(P_ref), jm))
    PWt, Wt = (x.numpy() for x in t_power.procrustes_align(torch.from_numpy(P), torch.from_numpy(P_ref), tm))
    np.testing.assert_allclose(Wt, Wj, rtol=0, atol=TOL)
    np.testing.assert_allclose(PWt, PWj, rtol=0, atol=TOL)
    if masked:
        assert np.abs(PWt[:, -2:]).max() == 0.0


def test_polar_unitary_guard_on_singular_overlap():
    O = np.zeros((6, 6))
    O[:3, :3] = np.eye(3)
    Wj = np.asarray(j_power.polar_unitary(jnp.asarray(O)))
    Wt = t_power.polar_unitary(torch.from_numpy(O)).numpy()
    np.testing.assert_array_equal(Wt, np.eye(6))
    np.testing.assert_array_equal(Wt, Wj)
