"""Gradient parity of the port (tpeps_torch) with tpeps on the CPU.

The same numpy inputs and cotangents go to the JAX package (its custom VJPs
and ``jax.vjp``/``jax.grad``) and to the port (its ``autograd.Function``s,
whose kernels run their plain twins on the CPU), float64, D <= 2, chi <= 16.
Tolerances, each stated at its test: 1e-10 for single VJPs (same formulas,
summation order only), 1e-12 for forward moves, 1e-7 relative for
gradients through a converged CTMRG (two fixed points converged to 1e-12
each, then an adjoint solved to 1e-10).
"""

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from tpeps.config import CtmArgs as J_CtmArgs
from tpeps.ctm.c4v import ctmrg as jc
from tpeps.ctm.c4v.env import EnvC4v as J_Env
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.linalg import eigh as j_eigh
from tpeps.linalg import power as j_power
from tpeps.models.j1j2 import J1J2_C4V_BIPARTITE as J_J1J2
from tpeps_torch.config import CtmArgs
from tpeps_torch.ctm.c4v import ctmrg as tc
from tpeps_torch.ctm.c4v.env import EnvC4v, init_env
from tpeps_torch.io.convert import to_torch
from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
from tpeps_torch.linalg import eigh as t_eigh
from tpeps_torch.linalg import power as t_power
from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64, requires_grad=requires_grad)


def _orthonormal(rng, n, k):
    return np.linalg.qr(rng.rand(n, k) - 0.5)[0]


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)


def _symmetric(rng, spectrum):
    U = _orthonormal(rng, len(spectrum), len(spectrum))
    return (U * np.asarray(spectrum)) @ U.T


# -- eigh_desc ---------------------------------------------------------------


def test_eigh_desc_vjp_with_exact_doublets():
    """Full ``jax.vjp`` of the JAX custom VJP vs the port's autograd, on a
    spectrum with exact doublets and a gauge-invariant loss (cotangents
    constant on each doublet, so the eigenvector freedom inside a doublet,
    which the two LAPACKs fill differently, drops out).  The regularizer is
    the adjoint's floor, 1e-6: a doublet split by rounding (~1e-16) then
    weighs ~1e-10 in the gap inverse, not ~1e-4 as at 1e-12.  Tolerance
    1e-10."""
    rng = np.random.RandomState(0)
    spec = np.array([3.0, -2.0, -2.0, 1.5, 1.0, 1.0, 0.5, -0.25])
    A = _symmetric(rng, spec)
    groups = [0, 1, 1, 2, 3, 3, 4, 5]
    gd = (rng.rand(6) - 0.5)[groups]
    c = (rng.rand(6) - 0.5)[groups]
    S = rng.rand(8, 8) - 0.5

    def loss_j(A_):
        D, U = j_eigh.eigh_desc(A_, 1e-6)
        return jnp.sum(gd * D) + jnp.sum(S * ((U * c) @ U.T))

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(A)))
    At = _t(A, requires_grad=True)
    D, U = t_eigh.eigh_desc(At, 1e-6)
    loss = (_t(gd) * D).sum() + (_t(S) * ((U * _t(c)) @ U.T)).sum()
    (gt,) = torch.autograd.grad(loss, At)
    assert _rel(gt.numpy(), gj) < 1e-10


@pytest.mark.parametrize("split", [1e-6, 1e-9], ids=["split1e-6", "split1e-9"])
def test_eigh_desc_vjp_near_degenerate(split):
    """Near-degenerate pairs: the JAX custom VJP rule evaluated on the port's
    own ``(D, U)`` and cotangents vs the port's backward (the eigenvectors of
    a near-degenerate pair are too ill-conditioned to compare across two
    LAPACKs).  Tolerance 1e-10 relative."""
    rng = np.random.RandomState(1)
    spec = np.array([2.0, 1.0 + split, 1.0, 0.3, 0.3 - split, -0.1])
    A = _symmetric(rng, spec)
    At = _t(A, requires_grad=True)
    D, U = t_eigh.eigh_desc(At, 1e-12)
    gD, gU = rng.rand(6) - 0.5, rng.rand(6, 6) - 0.5
    (gt,) = torch.autograd.grad((D, U), At, grad_outputs=(_t(gD), _t(gU)))
    (gj,) = j_eigh._eigh_desc_bwd(1e-12, (jnp.asarray(D.detach().numpy()),
                                         jnp.asarray(U.detach().numpy())),
                                  (jnp.asarray(gD), jnp.asarray(gU)))
    assert _rel(gt.numpy(), np.asarray(gj)) < 1e-10


def test_eigh_desc_gradcheck():
    """torch.autograd.gradcheck of the eigh_desc Function on a gauge-invariant
    function of a non-degenerate spectrum (reg 1e-30, so the Lorentzian is
    the exact gap inverse)."""
    rng = np.random.RandomState(2)
    A = _t(_symmetric(rng, [2.0, -1.3, 0.7, 0.2]), requires_grad=True)
    c = _t(rng.rand(4))

    def f(A_):
        D, U = t_eigh.eigh_desc(0.5 * (A_ + A_.T), 1e-30)
        return D, (U * c) @ U.T

    assert torch.autograd.gradcheck(f, (A,), eps=1e-6, atol=1e-8)


def test_fix_eigvec_phase():
    rng = np.random.RandomState(3)
    U = rng.rand(7, 4) - 0.5
    U[:, 2] = 0.0
    np.testing.assert_array_equal(t_eigh.fix_eigvec_phase(_t(U)).numpy(),
                                  np.asarray(j_eigh.fix_eigvec_phase(jnp.asarray(U))))


# -- K3: CholeskyQR and its Functions ---------------------------------------


def test_cholesky_qr2_vjp():
    """``jax.vjp`` of cholesky_qr2 vs the port's (Gram, solve Functions and
    torch's Cholesky gradient).  Tolerance 1e-10 relative."""
    rng = np.random.RandomState(4)
    P, gQ = rng.rand(40, 8) - 0.5, rng.rand(40, 8) - 0.5
    Qj, vjp = jax.vjp(j_power.cholesky_qr2, jnp.asarray(P))
    (gj,) = vjp(jnp.asarray(gQ))
    Pt = _t(P, requires_grad=True)
    Qt = t_power.cholesky_qr2(Pt)
    (gt,) = torch.autograd.grad(Qt, Pt, grad_outputs=_t(gQ))
    assert _rel(Qt.detach().numpy(), np.asarray(Qj)) < 1e-12
    assert _rel(gt.numpy(), np.asarray(gj)) < 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128], ids=["real", "complex"])
def test_cholqr_functions_gradcheck(dtype):
    """gradcheck of the three K3 Functions (Gram with ridge, two-operand
    Gram, right solve) in the real and complex case."""
    g = torch.Generator().manual_seed(5)
    mk = lambda *s: torch.randn(*s, dtype=dtype, generator=g).requires_grad_()
    P, B = mk(12, 4), mk(12, 3)
    L = torch.linalg.cholesky(t_power._GramRidge.apply(P.detach(), 0.0)).requires_grad_()
    assert torch.autograd.gradcheck(lambda x: t_power._GramRidge.apply(x, 1e-3), (P,))
    assert torch.autograd.gradcheck(t_power._Gram.apply, (P, B))
    assert torch.autograd.gradcheck(lambda L_, P_: t_power._TrsmRightLowerH.apply(
        torch.tril(L_), P_), (L, P))


# -- K6: Procrustes alignment and the polar Function ------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "col_mask"])
def test_procrustes_align_vjp(masked):
    """``jax.vjp`` of procrustes_align (closed-form polar JVP transposed) vs
    the port's (two-operand Gram + polar Functions), near-aligned bases,
    both outputs' cotangents, gradients for P and P_ref.  Tolerance 1e-10."""
    rng = np.random.RandomState(6)
    n, k = 30, 6
    P_ref = _orthonormal(rng, n, k)
    R = np.linalg.qr(np.eye(k) + 0.05 * (rng.rand(k, k) - 0.5))[0]
    P = np.linalg.qr(P_ref @ R + 1e-3 * (rng.rand(n, k) - 0.5))[0]
    mask = np.ones(k)
    if masked:
        mask[-2:] = 0.0
        P = P * mask
    gPW, gW = rng.rand(n, k) - 0.5, rng.rand(k, k) - 0.5
    jm = jnp.asarray(mask) if masked else None
    tm = _t(mask) if masked else None
    outj, vjp = jax.vjp(lambda a, b: j_power.procrustes_align(a, b, jm),
                        jnp.asarray(P), jnp.asarray(P_ref))
    gPj, gRj = vjp((jnp.asarray(gPW), jnp.asarray(gW)))
    Pt, Rt = _t(P, requires_grad=True), _t(P_ref, requires_grad=True)
    PW, W = t_power.procrustes_align(Pt, Rt, tm)
    gPt, gRt = torch.autograd.grad((PW, W), (Pt, Rt), grad_outputs=(_t(gPW), _t(gW)))
    assert _rel(W.detach().numpy(), np.asarray(outj[1])) < 1e-12
    assert _rel(gPt.numpy(), np.asarray(gPj)) < 1e-10
    assert _rel(gRt.numpy(), np.asarray(gRj)) < 1e-10


def test_polar_twin_float32_is_rounded_float64():
    """A single-precision overlap's polar factor is computed in double and
    rounded once (the K6 kernel does the same)."""
    from tpeps_torch.kernels.polar import polar_unitary_twin

    O = np.random.RandomState(13).rand(7, 7) - 0.5
    W32 = polar_unitary_twin(torch.tensor(O, dtype=torch.float32))
    assert W32.dtype == torch.float32
    ref = polar_unitary_twin(torch.tensor(O, dtype=torch.float32).double()).float()
    np.testing.assert_array_equal(W32.numpy(), ref.numpy())


def test_polar_function_gradcheck_at_orthogonal():
    """gradcheck of the polar Function at an orthogonal O, where the
    closed-form derivative W skew(W^T dO) is the exact one."""
    rng = np.random.RandomState(7)
    O = _t(_orthonormal(rng, 5, 5), requires_grad=True)
    assert torch.autograd.gradcheck(t_power.polar_unitary, (O,), eps=1e-6, atol=1e-8)


def test_subspace_eigh_matches_jax():
    """The dense-M POWER projector (oversampling 8, multiplet mask): forward
    to 1e-12 and its VJP to 1e-10 against tpeps."""
    rng = np.random.RandomState(8)
    n, chi = 32, 6
    M = _symmetric(rng, np.concatenate([[3.0, -2.0, 1.5, 1.2, 1.0, 0.8, -0.6, 0.5],
                                        0.2 * (rng.rand(n - 8) - 0.5)]))
    P0 = _orthonormal(rng, n, chi)
    gD, gP = rng.rand(chi) - 0.5, rng.rand(n, chi) - 0.5
    fj = lambda m: j_power.subspace_eigh(m, jnp.asarray(P0), n_power=3)
    (Dj, Pj), vjp = jax.vjp(fj, jnp.asarray(M))
    (gj,) = vjp((jnp.asarray(gD), jnp.asarray(gP)))
    Mt = _t(M, requires_grad=True)
    Dt, Pt = t_power.subspace_eigh(Mt, _t(P0), n_power=3)
    np.testing.assert_allclose(Dt.detach().numpy(), np.asarray(Dj), rtol=0, atol=1e-12)
    # eigenvector signs are not fixed by eigh: compare P up to a sign per
    # column, and feed the port the cotangent in its own signs
    s = np.sign(np.sum(Pt.detach().numpy() * np.asarray(Pj), axis=0))
    np.testing.assert_allclose(Pt.detach().numpy() * s, np.asarray(Pj), rtol=0, atol=1e-12)
    (gt,) = torch.autograd.grad((Dt, Pt), Mt, grad_outputs=(_t(gD), _t(gP * s)))
    assert _rel(gt.numpy(), np.asarray(gj)) < 1e-10


# -- the reference-layout move ----------------------------------------------


@pytest.fixture(scope="module")
def state():
    rng = np.random.RandomState(9)
    D, chi = 2, 8
    aj = j_symmetrize(jnp.asarray(rng.rand(2, D, D, D, D) - 0.5), normalize=True)
    envj = j_init_env(aj, chi, "CTMRG")
    # a few moves so the environment is generic (no init-env degeneracies);
    # the last projector is a well-conditioned gauge reference for the next
    # move (a cold-start reference makes the Procrustes overlap singular)
    envj, _, _, P_ref = jc.run_fixed_point(aj, envj, max_iter=6, conv_tol=0.0)
    at, envt = to_torch(np.asarray(aj), (np.asarray(envj.C), np.asarray(envj.T)), device=CPU)
    P_ref = np.asarray(P_ref)
    return dict(aj=aj, envj=envj, at=at, envt=envt, P_ref=P_ref, rng=rng, D=D, chi=chi)


@pytest.mark.parametrize("method", ["SYMEIG", "POWER", "QR"])
def test_ctm_move_sl_forward(state, method):
    """One move, SYMEIG / POWER / QR projector, Procrustes gauge against the
    previous move's projector: spectrum, C', T' and P to 1e-12."""
    ej, specj, Pj = jc.ctm_move_sl(state["aj"], state["envj"], jnp.asarray(state["P_ref"]),
                                   projector_method=method)
    et, spect, Pt = tc.ctm_move_sl(state["at"], state["envt"], _t(state["P_ref"]),
                                   projector_method=method)
    for x, ref in ((spect, specj), (et.C, ej.C), (et.T, ej.T), (Pt, Pj)):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["SYMEIG", "POWER"])
def test_ctm_move_sl_vjp(state, method):
    """VJP of the move at ``sg_norm=False`` with a fixed P_ref (the map the
    implicit adjoint differentiates) vs ``jax.vjp``: gradients for a, C and
    T to 1e-10 relative."""
    rng = np.random.RandomState(10)
    # the fixed point's own projector as the gauge reference
    _, _, P_star = jc.ctm_move_sl(state["aj"], state["envj"], jnp.asarray(state["P_ref"]),
                                  projector_method=method)
    P_star = np.asarray(P_star)
    gC = rng.rand(*state["envt"].C.shape) - 0.5
    gT = rng.rand(*state["envt"].T.shape) - 0.5

    def fj(a, C, T):
        e, _, _ = jc.ctm_move_sl(a, J_Env(C, T), jnp.asarray(P_star), sg_norm=False,
                                 projector_method=method, ad_decomp_reg=1e-6)
        return e.C, e.T

    _, vjp = jax.vjp(fj, state["aj"], state["envj"].C, state["envj"].T)
    gj = vjp((jnp.asarray(gC), jnp.asarray(gT)))
    ins = [x.clone().requires_grad_() for x in (state["at"], *state["envt"])]
    et, _, _ = tc.ctm_move_sl(ins[0], EnvC4v(ins[1], ins[2]), _t(P_star), sg_norm=False,
                              projector_method=method, ad_decomp_reg=1e-6)
    gt = torch.autograd.grad((et.C, et.T), ins, grad_outputs=(_t(gC), _t(gT)))
    for x, ref in zip(gt, gj):
        assert _rel(x.numpy(), ref) < 1e-10


def test_fix_phase_continuity(state):
    rng = np.random.RandomState(11)
    P, R = rng.rand(12, 4) - 0.5, rng.rand(12, 4) - 0.5
    R[:, 1] = 0.0
    np.testing.assert_array_equal(tc.fix_phase_continuity(_t(P), _t(R)).numpy(),
                                  np.asarray(jc.fix_phase_continuity(jnp.asarray(P),
                                                                     jnp.asarray(R))))


def test_run_fixed_point_env_convergence():
    """Twin of tests/test_c4v.py::TestFixedPoint::test_elementwise_convergence:
    conv_on="env" to 1e-12 from the same init; the same number of moves and
    the environment elementwise to 1e-10."""
    chi = 16
    x = np.random.RandomState(7).rand(2, 2, 2, 2, 2) - 0.5
    aj = j_symmetrize(jnp.asarray(x), normalize=True)
    envj, nj, distj, Pj = jc.run_fixed_point(aj, j_init_env(aj, chi, "CTMRG"), max_iter=800,
                                             conv_tol=1e-12, conv_on="env")
    a = symmetrize_c4v(torch.from_numpy(x), normalize=True)
    env, n, dist, P = tc.run_fixed_point(a, init_env(a, chi, "CTMRG"), max_iter=800,
                                         conv_tol=1e-12, conv_on="env")
    assert dist < 1e-11 and float(distj) < 1e-11
    assert n == int(nj)
    np.testing.assert_allclose(env.C.numpy(), np.asarray(envj.C), rtol=0, atol=1e-10)
    np.testing.assert_allclose(env.T.numpy(), np.asarray(envj.T), rtol=0, atol=1e-10)
    e1, _, _ = tc.ctm_move_sl(a, env, P)
    assert float((e1.C - env.C).abs().max()) < 1e-10
    assert float((e1.T - env.T).abs().max()) < 1e-10


# -- converge_env: implicit and scan ----------------------------------------

GRAD_CFG = dict(ctm_max_iter=600, ctm_conv_tol=1e-12, grad_tail_iter=70,
                grad_adjoint_max_iter=300, grad_adjoint_tol=1e-10)


@pytest.mark.parametrize("grad_mode", ["implicit", "scan"])
def test_converge_env_grad(grad_mode):
    """Twin of tests/test_c4v.py::TestGradients::test_grad_vs_fd (its
    configuration: D=2, chi=8, j2=0.3): the port's gradient equals
    ``jax.grad`` of the same loss to 1e-7 relative, and a central finite
    difference to that test's tolerance (2e-3 implicit, 5e-2 scan)."""
    chi, D = 8, 2
    rng = np.random.RandomState(7)
    A = rng.rand(2, D, D, D, D) - 0.5
    v = rng.rand(*A.shape) - 0.5
    v /= np.linalg.norm(v)
    jcfg = J_CtmArgs(grad_mode=grad_mode, **GRAD_CFG)
    jmodel = J_J1J2(j1=1.0, j2=0.3)

    def loss_j(p):
        a = j_symmetrize(p, normalize=True)
        e0 = j_init_env(jax.lax.stop_gradient(a), chi, "CTMRG")
        return jmodel.energy_1x1_lowmem(a, jc.converge_env(a, e0, jcfg))

    gj = np.asarray(jax.grad(loss_j)(jnp.asarray(A)))

    cfg = CtmArgs(grad_mode=grad_mode, **GRAD_CFG)
    model = J1J2_C4V_BIPARTITE(j1=1.0, j2=0.3, device=CPU)

    def loss(p):
        a = symmetrize_c4v(p, normalize=True)
        env0 = init_env(a.detach(), chi, "CTMRG")
        return model.energy_1x1_lowmem(a, tc.converge_env(a, env0, cfg))

    def loss_ng(p):
        with torch.no_grad():
            a = symmetrize_c4v(_t(p), normalize=True)
            e, *_ = tc.run_fixed_point(a, init_env(a, chi, "CTMRG"), max_iter=600,
                                       conv_tol=1e-12, conv_on="env")
            return float(model.energy_1x1_lowmem(a, e))

    At = _t(A, requires_grad=True)
    (gt,) = torch.autograd.grad(loss(At), At)
    gt = gt.numpy()
    assert np.isfinite(gt).all()
    assert _rel(gt, gj) < 1e-7
    eps = 1e-6
    fd = (loss_ng(A + eps * v) - loss_ng(A - eps * v)) / (2 * eps)
    an = float(np.sum(gt * v))
    tol = 2e-3 if grad_mode == "implicit" else 5e-2
    assert abs(fd - an) < tol * max(abs(fd), 1e-8), (fd, an)


def test_implicit_divergence_guard(monkeypatch):
    """The Neumann adjoint stops once ``|u|`` has grown twice in a row and
    warns, keeping the partial sum; a move map with ``2 * env`` added stands
    in for a non-contracting Jacobian.  The stats record the forward moves,
    the adjoint iterations and that the guard fired."""
    chi = 8
    x = np.random.RandomState(12).rand(2, 2, 2, 2, 2) - 0.5
    a = symmetrize_c4v(torch.from_numpy(x), normalize=True).requires_grad_()
    cfg = CtmArgs(ctm_max_iter=5, ctm_conv_tol=1e-12, grad_mode="implicit",
                  grad_adjoint_max_iter=50, grad_adjoint_tol=1e-10)
    stats = {}
    env = tc.converge_env(a, init_env(a.detach(), chi, "CTMRG"), cfg, stats=stats)
    move = tc.ctm_move_sl

    def expanding(a_, env_, P, **kw):
        e2, spec, P2 = move(a_, env_, P, **kw)
        return EnvC4v(e2.C + 2.0 * env_.C, e2.T + 2.0 * env_.T), spec, P2

    monkeypatch.setattr(tc, "ctm_move_sl", expanding)
    with pytest.warns(RuntimeWarning, match="diverging"):
        (g,) = torch.autograd.grad(env.C.sum() + env.T.sum(), a)
    assert np.isfinite(g.numpy()).all()
    assert stats["fwd_moves"] == 5
    assert stats["adj_diverged"] is True
    assert stats["adj_iters"] < 50
