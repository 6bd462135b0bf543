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
