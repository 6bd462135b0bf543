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
import jax
import jax.numpy as jnp

from tpeps.linalg import eigh as j_eigh
from tpeps.linalg import power as j_power
from tpeps_torch.linalg import eigh as t_eigh
from tpeps_torch.linalg import power as t_power
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12
_J_POLAR = jax.jit(j_power.polar_unitary)


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


# --- K6: the kernel's guarded Newton-Schulz iteration, modelled in plain torch


def _ns_polar_model(O, max_steps=None, stop=1e-8):
    """A plain-torch model of the card's ``polar_unitary`` (csrc/polar.cu):
    Newton-Schulz ``Y <- Y (3 I - Y^T Y) / 2`` from ``Y = O / sqrt(lam)``,
    ``lam = min(||H||_1, ||H||_F, 1 + ||H - I||_F) >= ||H||_2``, stopping
    after the step whose ``||Y^T Y - I||_F <= stop``; ``I`` when it did not
    converge within ``max_steps`` (the kernel's cap), met a non-finite
    value, or gave a non-finite ``W``.  Returns ``(W, steps)``."""
    from tpeps_torch.kernels.polar import MAX_STEPS

    max_steps = MAX_STEPS if max_steps is None else max_steps
    eye = torch.eye(O.shape[0], dtype=O.dtype)
    H = O.T @ O
    lam = min(float(H.abs().sum(0).max()), float(torch.linalg.norm(H)),
              1.0 + float(torch.linalg.norm(H - eye)))
    alpha = lam ** -0.5
    Y, G, beta = O, H, alpha * alpha
    for step in range(1, max_steps + 1):
        d2 = float(((beta * G - eye) ** 2).sum())
        if not np.isfinite(d2):
            break
        Y = Y @ (alpha * (1.5 * eye - 0.5 * beta * G))
        if d2 <= stop ** 2:
            return (Y if bool(torch.isfinite(Y).all()) else eye), step
        G, alpha, beta = Y.T @ Y, 1.0, 1.0
    return eye, step


_K6 = 16  # one shape: JAX's polar_unitary compiles once


def _j_polar(O):
    return np.asarray(_J_POLAR(jnp.asarray(O)))


def _svd_overlap(s, seed):
    """``U diag(s) V^T`` with U, V from a QR of seeded matrices, and ``U V^T``,
    its exact polar factor."""
    rs = np.random.RandomState(seed)
    U = np.linalg.qr(rs.rand(len(s), len(s)) - 0.5)[0]
    V = np.linalg.qr(rs.rand(len(s), len(s)) - 0.5)[0]
    return (U * s) @ V.T, U @ V.T


def _overlap(kind):
    rs = np.random.RandomState(11)
    if kind == "near_orthogonal":  # consecutive projectors late in a run
        return _svd_overlap(1.0 + 1e-6 * (rs.rand(_K6) - 0.5), seed=12)[0]
    if kind in ("dev_below_0.9", "dev_above_0.9"):  # ||O^T O - I||_F = 0.89 or 0.91
        dev = 0.89 if kind == "dev_below_0.9" else 0.91
        v = rs.rand(_K6) - 0.5
        return _svd_overlap(np.sqrt(1.0 + dev * v / np.linalg.norm(v)), seed=13)[0]
    # procrustes_align's masked overlap: identity rows for the masked columns
    P, P_ref = _orthonormal(60, _K6, seed=14), _orthonormal(60, _K6, seed=15)
    m = np.ones(_K6)
    m[-3:] = 0.0
    O = (P * m).T @ P_ref
    O = O * (m[:, None] * m[None, :]) + (1.0 - m)[:, None] * np.eye(_K6)
    return O + 1e-12 * np.eye(_K6)


@pytest.mark.parametrize("kind", ["near_orthogonal", "dev_below_0.9", "dev_above_0.9", "masked"])
def test_polar_model_and_twin_match_jax(kind):
    """The kernel's iteration (its model here) and the eigh-based twin give
    JAX's polar_unitary on the overlaps the path sees: near-orthogonal, with
    ||O^T O - I||_F on either side of the parent kernel's 0.9 branch point,
    and masked as procrustes_align builds it (1e-12: all are
    well-conditioned, so both methods reach the polar factor to rounding)."""
    from tpeps_torch.kernels.polar import polar_unitary_twin

    O = _overlap(kind)
    Wj = _j_polar(O)
    Wm, steps = _ns_polar_model(torch.from_numpy(O))
    assert not np.array_equal(Wj, np.eye(_K6))
    np.testing.assert_allclose(Wm.numpy(), Wj, rtol=0, atol=TOL)
    np.testing.assert_allclose(polar_unitary_twin(torch.from_numpy(O)).numpy(), Wj, rtol=0,
                               atol=TOL)
    assert steps <= (4 if kind == "near_orthogonal" else 12)


@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6, 1e8])
def test_polar_on_graded_overlaps(cond):
    """On ``O = U diag(s) V^T`` with sigma_max/sigma_min = cond the exact
    factor is ``U V^T``: the iteration works on O itself and reaches it
    within 1e-13 cond; the twin and JAX take an eigh of O^T O, which squares
    the condition, and reach it within 1e-15 cond^2."""
    from tpeps_torch.kernels.polar import polar_unitary_twin

    O, X = _svd_overlap(np.logspace(0, -np.log10(cond), _K6), seed=16)
    Wm, _ = _ns_polar_model(torch.from_numpy(O))
    assert np.abs(Wm.numpy() - X).max() <= 1e-13 * cond
    for W in (_j_polar(O), polar_unitary_twin(torch.from_numpy(O)).numpy()):
        assert np.abs(W - X).max() <= 1e-15 * cond ** 2


@pytest.mark.parametrize("kind", ["exactly_singular", "ridged_singular"])
def test_polar_gives_identity_on_singular_overlaps(kind):
    """Null directions never grow under the iteration, and ridged ones (1e-12,
    procrustes_align's ridge) do not converge within the cap: the model
    gives I, as the eigh-based guard of the twin and of JAX does (the null
    block is exact in O^T O, so the eigh sees w_min <= 1e-24 w_max)."""
    from tpeps_torch.kernels.polar import polar_unitary_twin

    O = np.zeros((_K6, _K6))  # an orthogonal block beside three null directions
    O[:-3, :-3] = _orthonormal(_K6 - 3, _K6 - 3, seed=17)
    if kind == "ridged_singular":
        O = O + 1e-12 * np.eye(_K6)
    Wm, steps = _ns_polar_model(torch.from_numpy(O))
    for W in (Wm.numpy(), polar_unitary_twin(torch.from_numpy(O)).numpy(), _j_polar(O)):
        np.testing.assert_array_equal(W, np.eye(_K6))


def test_polar_step_cap_sits_between_the_guard_edge_and_the_ridge():
    """The cap is the condition guard: sigma_min/sigma_max = 1e-10 (JAX's
    w_min = 1e-20 w_max) converges within it, 1e-12 does not."""
    from tpeps_torch.kernels.polar import MAX_STEPS

    O, X = _svd_overlap(np.logspace(0, -10, _K6), seed=18)
    Wm, steps = _ns_polar_model(torch.from_numpy(O))
    assert steps < MAX_STEPS and np.abs(Wm.numpy() - X).max() <= 1e-13 * 1e10
    O, _ = _svd_overlap(np.logspace(0, -12, _K6), seed=18)
    Wm, steps = _ns_polar_model(torch.from_numpy(O))
    assert steps == MAX_STEPS
    np.testing.assert_array_equal(Wm.numpy(), np.eye(_K6))


@pytest.mark.parametrize("ratio", [1e-10, 3e-11, 1e-11, 3e-12, 1e-12])
def test_polar_between_the_guard_edge_and_the_ridge(ratio, record_property):
    """Graded overlaps with sigma_min/sigma_max between JAX's guard edge
    (1e-10) and procrustes_align's ridge (1e-12): the kernel's iteration (its
    model) gives the polar factor or I by whether it converges within the
    cap, which is deterministic: W at 1e-10, I at 1e-12, and once it gives I
    it does so for every smaller ratio.  The twin and JAX decide by the
    smallest eigenvalue of O^T O, which here lies below its rounding (~1e-16
    of the largest): each gives I or a finite matrix, which one is recorded
    (``twin``, ``jax``), not asserted."""
    from tpeps_torch.kernels.polar import MAX_STEPS, polar_unitary_twin

    eye = np.eye(_K6)
    O, X = _svd_overlap(np.logspace(0, np.log10(ratio), _K6), seed=19)
    Wm, steps = _ns_polar_model(torch.from_numpy(O))
    kept = not np.array_equal(Wm.numpy(), eye)
    if kept:
        assert np.abs(Wm.numpy() - X).max() <= 1e-13 / ratio
    if ratio >= 1e-10:
        assert kept and steps < MAX_STEPS
    if ratio <= 1e-12:
        assert not kept
    smaller = np.logspace(np.log10(ratio), -12, 3)[1:]
    if not kept:  # I here, I below
        for r in smaller:
            Os, _ = _svd_overlap(np.logspace(0, np.log10(r), _K6), seed=19)
            np.testing.assert_array_equal(_ns_polar_model(torch.from_numpy(Os))[0].numpy(), eye)
    outcome = {"model": "W" if kept else "I", "model_steps": steps}
    for name, W in (("twin", polar_unitary_twin(torch.from_numpy(O)).numpy()),
                    ("jax", _j_polar(O))):
        assert np.isfinite(W).all()
        outcome[name] = "I" if np.array_equal(W, eye) else "W"
    record_property("polar_outcome", outcome)
    print(f"sigma_min/sigma_max {ratio:.0e}: {outcome}")
