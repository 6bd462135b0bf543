"""The U(1) C4v abelian training path: the port's gradients against tpeps on
the CPU.

The same numpy arrays (``np.random.RandomState``) go to both packages; the
port runs its kernels' twins.  Tolerances: K8's backward (tensordot and
transpose VJPs, fermionic signs and an ``out_like`` superset included)
against eager ``jax.vjp`` 1e-12; ``svd_reg``'s VJP against ``jax.vjp``
(real and complex; tall, wide, square; a degenerate pair) 1e-10, and central
differences 1e-5 as tests/test_linalg.py:152; the frozen blockwise
decompositions' VJPs on a D=3 corner with gauge-invariant losses 1e-10; the
``frozen_epilogue_vjp`` twin against ``jax.vjp`` of the JAX epilogue on a
tensor whose maximum is tied 1e-13; the ``adjoint_commit`` twin against the
JAX package's adjoint ``while_loop`` (its factory with a linear stand-in
move) on crafted |u|^2 sequences, the accumulated cotangent 1e-15 and the
counters exactly.  The slice, at the D=3 state of tests/test_torch_abelian.py
and chi=9: the gradient of the training loss against central differences of
the same loss in four random directions, 1e-6 relative (measured: <= 5e-8 at
h=1e-5, 40 frozen moves), and the loss against JAX's from the same closed
``(C0, T0)``, 1e-10.  The two tests that differentiate through JAX's frozen move are
``slow`` (a jitted ``jax.vjp`` of one move compiles for ~75 s here; JAX's
whole gradient takes more than 290 s).
"""

import re
from unittest import mock

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from test_torch_abelian import PHYS, c4v_state
from test_torch_sym import DOT_CASES, jrandom, port
from tpeps.ctm.c4v_abelian import ctmrg as j_ctmrg
from tpeps.ctm.c4v_abelian import env as j_env
from tpeps.ctm.c4v_abelian import frozen as j_frozen
from tpeps.ipeps.ipeps_abelian import IPEPS_ABELIAN as J_IPEPS_ABELIAN
from tpeps.ipeps.ipeps_abelian import make_c4v_symm_A1_abelian as j_symm
from tpeps.linalg import svd as j_svd
from tpeps.models.abelian.j1j2 import J1J2_ABELIAN as J_J1J2_ABELIAN
from tpeps.sym import frozen as j_sfrozen
from tpeps.sym import io as j_io
from tpeps.sym import tensor as j_tensor
from tpeps_torch.config import CtmArgs, configure, get_args_parser
from tpeps_torch.ctm.c4v_abelian import ctmrg, frozen
from tpeps_torch.ctm.c4v_abelian import env as c4v_env
from tpeps_torch.ipeps.ipeps_abelian import IPEPS_ABELIAN, make_c4v_symm_A1_abelian
from tpeps_torch.kernels.frozen import (adjoint_commit_twin, adjoint_state,
                                        frozen_epilogue_vjp_twin)
from tpeps_torch.linalg.svd import fix_svd_signs, svd_reg
from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
from tpeps_torch.sym import frozen as t_sfrozen
from tpeps_torch.sym.tensor import AbelianTensor

CPU = torch.device("cpu")
CHI, J2, FROZEN_ITER = 9, 0.3, 40
PK = dict(svd_reltol=1e-12, eps_multiplet=1e-12)


def flat(t, data):
    return AbelianTensor._flat(t, t.struct, data)


def with_grad(t):
    x = t.data.detach().clone().requires_grad_()
    return flat(t, x), x


def jax_tensor(t, backend=jnp.asarray):
    """The port's (non-fermionic) tensor as the JAX package's."""
    return j_tensor.AbelianTensor(t.sym, t.signature,
                                  [j_tensor.leg(dict(l.charges), l.pshift) for l in t.legs], t.n,
                                  {q: backend(b) for q, b in t.numpy_blocks().items()})


def block_err(jt, tt, g):
    """Max abs difference of JAX's cotangent ``jt`` and the port's flat ``g``
    laid out as ``tt``."""
    tb = flat(tt, g).numpy_blocks()
    assert sorted(tb) == sorted(jt.blocks)
    return max((float(np.abs(np.asarray(b) - tb[q]).max()) for q, b in jt.blocks.items()),
               default=0.0)


def random_like(rng, jt):
    return jt.copy_with({q: jnp.asarray(rng.rand(*np.shape(b)) - 0.5)
                         for q, b in sorted(jt.blocks.items())})


# ---------------------------------------------------------------------------
# K8 backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DOT_CASES))
def test_tensordot_vjp_matches_jax(name):
    sa, da, sb, db, axes, ferm, pshifts, _ = DOT_CASES[name]
    rng = np.random.RandomState(len(name))
    pa, pb = pshifts or (None, None)
    ja = jrandom(rng, sa, da, 1, ferm, pa, jnp.asarray)
    jb = jrandom(rng, sb, db, 0, ferm, pb, jnp.asarray)
    dot = lambda x, y: x.tensordot(y, axes)  # noqa: E731
    ct = random_like(rng, jax.eval_shape(dot, ja, jb))
    ga, gb = jax.jit(lambda x, y, c: jax.vjp(dot, x, y)[1](c))(ja, jb, ct)
    ta, xa = with_grad(port(ja))
    tb, xb = with_grad(port(jb))
    tc = ta.tensordot(tb, axes)
    tct = port(ct)
    assert tct.struct is tc.struct
    g1, g2 = torch.autograd.grad(tc.data, (xa, xb), tct.data)
    assert block_err(ga, ta, g1) < 1e-12 and block_err(gb, tb, g2) < 1e-12


@pytest.mark.parametrize("fermionic", [False, True], ids=["plain", "fermionic"])
def test_transpose_vjp_matches_jax(fermionic):
    rng = np.random.RandomState(3)
    ja = jrandom(rng, (1, 1, 1, -1, -1), (PHYS,) + (DOT_CASES["one_leg"][1][0],) * 4, 1,
                 fermionic, (1, 0, 0, 0, 0) if fermionic else None, jnp.asarray)
    perm = (4, 2, 0, 3, 1)
    jc, vjp = jax.vjp(lambda x: x.transpose(perm), ja)
    ct = random_like(rng, jc)
    (ga,) = vjp(ct)
    ta, xa = with_grad(port(ja))
    (g,) = torch.autograd.grad(ta.transpose(perm).data, xa, port(ct).data)
    assert block_err(ga, ta, g) < 1e-12


def test_out_like_superset_vjp():
    """``tensordot(out_like=...)`` into a superset of the produced blocks: the
    extra blocks stay zero and take no gradient; the operands' cotangents
    are JAX's for the cotangent restricted to the produced blocks."""
    sa, da, sb, db, axes, *_ = DOT_CASES["two_legs_permuted"]
    rng = np.random.RandomState(5)
    ja, jb = jrandom(rng, sa, da, 1, backend=jnp.asarray), jrandom(rng, sb, db, 0,
                                                                   backend=jnp.asarray)
    jc, vjp = jax.vjp(lambda x, y: x.tensordot(y, axes), ja, jb)
    ta, xa = with_grad(port(ja))
    tb, xb = with_grad(port(jb))
    plain = ta.tensordot(tb, axes)
    wide = [j_tensor.leg({**dict(l.charges), 5: 1, -5: 1}) for l in jc.legs]
    sup = j_tensor.AbelianTensor("U1", jc.signature, wide, jc.n)
    sup = port(sup.copy_with({q: np.zeros(sup.block_shape(q))
                              for q in sorted(sup.all_allowed_blocks())}))
    extra = set(sup.struct.keys) - set(plain.struct.keys)
    assert extra and set(plain.struct.keys) <= set(sup.struct.keys)
    tc = ta.tensordot(tb, axes, out_like=sup)
    assert tc.struct is sup.struct
    assert all(float(tc.blocks[q].detach().abs().max()) == 0.0 for q in extra)
    w = {q: rng.rand(*sup.struct.shapes[sup.struct.index[q]]) - 0.5 for q in sup.struct.keys}
    ga, gb = vjp(jc.copy_with({q: jnp.asarray(w[q]) for q in jc.blocks}))
    wt = torch.cat([torch.as_tensor(w[q]).reshape(-1) for q in sup.struct.keys])
    g1, g2 = torch.autograd.grad(tc.data, (xa, xb), wt)
    assert block_err(ga, ta, g1) < 1e-12 and block_err(gb, tb, g2) < 1e-12


# ---------------------------------------------------------------------------
# svd_reg
# ---------------------------------------------------------------------------


def _svd_matrix(shape, dtype, degenerate=False):
    rng = np.random.RandomState(sum(shape) + (7 if degenerate else 0))

    def rnd(*s):
        x = rng.randn(*s)
        return x + 1j * rng.randn(*s) if dtype == "complex" else x

    if not degenerate:
        return rnd(*shape)
    q1, _ = np.linalg.qr(rnd(shape[0], shape[0]))
    q2, _ = np.linalg.qr(rnd(shape[1], shape[1]))
    s = np.array([3.0, 2.0, 2.0, 1.0, 0.5])[:min(shape)]
    return (q1[:, :len(s)] * s) @ q2[:, :len(s)].conj().T


SVD_CASES = {f"{dt}_{name}": (shape, dt, False) for dt in ("real", "complex")
             for name, shape in (("tall", (7, 4)), ("wide", (4, 7)), ("square", (5, 5)))}
# a pair equal to rounding: the Lorentzian must be wider than the split
# (~1e-15 in s^2), else 1/(s_j^2 - s_i^2) is ~1e15 in both packages and
# their gradients differ by rounding times that; eps = 1e-3 gives width 9e-6
SVD_CASES["real_degenerate_pair"] = ((6, 5), "real", True)
SVD_CASES["complex_degenerate_pair"] = ((5, 5), "complex", True)


@pytest.mark.parametrize("name", list(SVD_CASES))
def test_svd_reg_vjp_matches_jax(name):
    """A loss of S, of the rank-3 reconstruction and of the rank-3 projector
    (gauge-invariant: the cut at 3 lies in a gap): the port's gradient
    against ``jax.grad`` of the same loss (torch's complex gradient is the
    conjugate of JAX's)."""
    shape, dt, degenerate = SVD_CASES[name]
    A = _svd_matrix(shape, dt, degenerate)
    eps = 1e-3 if degenerate else 1e-12
    rng = np.random.RandomState(11)
    W1, W2 = rng.randn(*shape), rng.randn(shape[0], shape[0])

    def loss(A, svd, xp):
        U, S, Vh = svd(A)
        R = (U[:, :3] * S[:3][None, :]) @ Vh[:3]
        P = U[:, :3] @ U[:, :3].conj().T
        return (xp.sum(S ** 3) + xp.sum(xp.asarray(W1) * R).real
                + xp.sum(xp.asarray(W2) * P).real + xp.sum(xp.abs(R) ** 2))

    gj = jax.jit(jax.grad(lambda x: loss(x, lambda y: j_svd.svd_reg(y, eps), jnp)))(
        jnp.asarray(A))
    At = torch.as_tensor(A).requires_grad_()
    (gt,) = torch.autograd.grad(loss(At, lambda y: svd_reg(y, eps), torch), At)
    ref = np.conj(np.asarray(gj))
    assert np.abs(gt.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


def test_svd_reg_complex_grad():
    """Twin of tests/test_linalg.py:152 for the port's ``svd_reg``: central
    differences of a projector loss and of a truncation loss, real and
    complex (torch's convention: the gradient is dL/dRe + i dL/dIm)."""
    rng = np.random.default_rng(5)

    def loss_proj(A):
        U, S, Vh = svd_reg(A)
        U, Vh = fix_svd_signs(U, Vh)
        U, S = U[:, :3], S[:3]
        P = (A @ U.conj()) * torch.rsqrt(S)[None, :]
        M = torch.arange(A.shape[0] ** 2, dtype=torch.float64).reshape(A.shape[0], -1)
        return torch.trace(P.conj().T @ M.to(A.dtype) @ P).real

    def loss_trunc(A):
        U, S, Vh = svd_reg(A, 1e-12)
        At = (U[:, :3] * S[:3][None, :]) @ Vh[:3]
        return (At.abs() ** 2).sum()

    cases = [("real", torch.as_tensor(rng.standard_normal((6, 6)))),
             ("complex", torch.as_tensor(rng.standard_normal((6, 6))
                                         + 1j * rng.standard_normal((6, 6))))]
    for label, A0 in cases:
        for loss in (loss_proj, loss_trunc):
            A = A0.clone().requires_grad_()
            (grad,) = torch.autograd.grad(loss(A), A)
            for (i, j) in [(0, 0), (1, 2), (3, 4)]:
                eps = 1e-6
                dA = torch.zeros_like(A0)
                dA[i, j] = eps
                fd = (float(loss(A0 + dA)) - float(loss(A0 - dA))) / (2 * eps)
                assert abs(fd - float(grad[i, j].real)) < 1e-5, label
                if A0.is_complex():
                    fdi = (float(loss(A0 + 1j * dA)) - float(loss(A0 - 1j * dA))) / (2 * eps)
                    assert abs(fdi - float(grad[i, j].imag)) < 1e-5, label


# ---------------------------------------------------------------------------
# the frozen blockwise decompositions on a D=3 corner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corner():
    """The D=3 state's enlarged corner after 2 dynamic moves from init_env
    (JAX, numpy blocks), its eigh and SVD keep profiles, and random weights."""
    ja = c4v_state()
    je = j_env.init_env(J_IPEPS_ABELIAN("U1", {(0, 0): ja}), CHI)
    for _ in range(2):
        je = j_ctmrg.ctm_move_sl(ja, je, PK)
    M = j_ctmrg.c2x2_sl(ja, je.C, je.T)
    Ue, _ = j_tensor.eigh_blockwise(M, (0, 1, 2), (3, 4, 5), chi=CHI, eps_multiplet=1e-8)
    Us, _, _ = j_tensor.svd_blockwise(M, (0, 1, 2), (3, 4, 5), chi=CHI, eps_multiplet=1e-8)
    return M, dict(Ue.legs[-1].charges), dict(Us.legs[-1].charges), je


def _grams(t, rows_first):
    """Per block of an isometry ``t`` (new leg last, or first for V), the
    Gram matrix over its rows (or columns): invariant under the column signs
    that the gauge fixing picks."""
    out = {}
    for q, b in t.blocks.items():
        m = b.reshape(-1, b.shape[-1]) if rows_first else b.reshape(b.shape[0], -1).T
        out[q] = m @ m.conj().T
    return out


def _eigh_loss(M, keep, w, fixed, xp):
    U, W = fixed(M, (0, 1, 2), (3, 4, 5), keep)
    G = _grams(U, True)
    return sum(xp.sum(v ** 3) for v in W.values()) + \
        sum(xp.sum(xp.asarray(w.get(("U",) + q, 0.0)) * g) for q, g in G.items()), G


def _svd_loss(M, keep, w, fixed, xp):
    U, S, V = fixed(M, (0, 1, 2), (3, 4, 5), keep)
    G = {("U",) + q: g for q, g in _grams(U, True).items()}
    G.update({("V",) + q: g for q, g in _grams(V, False).items()})
    return sum(xp.sum(v ** 3) for v in S.values()) + \
        sum(xp.sum(xp.asarray(w.get(q, 0.0)) * g) for q, g in G.items()), G


@pytest.mark.parametrize("kind", ["eigh", "svd"])
def test_blockwise_fixed_vjp_matches_jax(corner, kind):
    """A loss of the kept values and of every isometry block's Gram matrix
    (gauge-invariant) through the frozen decomposition of the corner."""
    M, keep_e, keep_s, _ = corner
    if kind == "eigh":
        keep, fn = keep_e, _eigh_loss
        jfix, tfix = j_sfrozen.eigh_blockwise_fixed, t_sfrozen.eigh_blockwise_fixed
    else:
        keep, fn = keep_s, _svd_loss
        jfix, tfix = j_sfrozen.svd_blockwise_fixed, t_sfrozen.svd_blockwise_fixed
    with torch.no_grad():
        grams = fn(port(M), keep, {}, tfix, torch)[1]
    rng = np.random.RandomState(2)
    w = {q if kind == "svd" else ("U",) + q: rng.rand(*g.shape) - 0.5
         for q, g in sorted(grams.items())}
    tM, x = with_grad(port(M))
    (gt,) = torch.autograd.grad(fn(tM, keep, w, tfix, torch)[0], x)
    gj = jax.jit(jax.grad(lambda m: fn(m, keep, w, jfix, jnp)[0]))(M.to_backend("jnp"))
    err = block_err(gj, tM, gt)
    assert err <= 1e-10 * max(float(gt.abs().max()), 1.0), err


# ---------------------------------------------------------------------------
# the K9 backward kernels' twins
# ---------------------------------------------------------------------------


def _tie(blocks, key, partner_key, index, partner_index, value=10.0):
    """Set one element and its transpose partner to ``value``: after the
    symmetrization the maximum is tied between the two."""
    blocks[key][index] = value
    blocks[partner_key][partner_index] = value


def test_frozen_epilogue_vjp_twin_matches_jax(corner):
    """The epilogue's backward with the scale differentiated, on raw C', T'
    whose symmetrized maximum is tied between an element and its transpose
    partner (in another block): the twin against ``jax.vjp`` of the JAX
    package's epilogue (symmetrize, ``_normalized(sg=False)``)."""
    je = corner[3]
    rng = np.random.RandomState(4)
    out = []
    for t, axes, idx in ((je.C, frozen.C_PARTNER, (0, 0)), (je.T, frozen.T_PARTNER, (0, 0, 0, 0))):
        blocks = {q: rng.rand(*np.shape(b)) - 0.5 for q, b in sorted(t.blocks.items())}
        key = next(q for q in sorted(blocks) if tuple(q[i] for i in axes) != q)
        _tie(blocks, key, tuple(key[i] for i in axes), idx, idx)
        out.append(t.copy_with({q: jnp.asarray(b) for q, b in blocks.items()}))
    jC, jT = out

    def epilogue(nC, nT):
        nC = 0.5 * (nC + nC.transpose(frozen.C_PARTNER).conj_blocks())
        nT = 0.5 * (nT + nT.transpose(frozen.T_PARTNER).conj_blocks())
        return j_frozen._normalized(nC, False), j_frozen._normalized(nT, False)

    yC, yT = jax.eval_shape(epilogue, jC, jT)
    cC, cT = random_like(rng, yC), random_like(rng, yT)
    gC, gT = jax.jit(lambda x, y, c: jax.vjp(epilogue, x, y)[1](c))(jC, jT, (cC, cT))
    tC, tT = port(jC), port(jT)
    assert sorted(yC.blocks) == list(tC.struct.keys) and sorted(yT.blocks) == list(tT.struct.keys)
    pC = frozen.partner_index(tC.struct, frozen.C_PARTNER, CPU)
    pT = frozen.partner_index(tT.struct, frozen.T_PARTNER, CPU)
    xC, xT = frozen_epilogue_vjp_twin(tC.data, tT.data, pC, pT, port(cC).data, port(cT).data)
    assert block_err(gC, tC, xC) < 1e-13 and block_err(gT, tT, xT) < 1e-13
    # the move's epilogue Function takes the same route
    rC, rT = (t.data.clone().requires_grad_() for t in (tC, tT))
    y = frozen._Epilogue.apply(rC, rT, pC, pT)
    g = torch.autograd.grad(y, (rC, rT), (port(cC).data, port(cT).data))
    assert torch.equal(g[0], xC) and torch.equal(g[1], xT)


# (lambda_C, lambda_T, |ybar_T| / |ybar_C|, adjoint_max_iter, expected iterations,
# diverged): u_C and u_T scale by lambda each iteration
ADJ_CASES = {
    "converging": (0.5, 0.5, 1.0, 100, 27, False),
    "four_growths": (1.2, 1.2, 1.0, 100, 4, True),
    "blow_up": (200.0, 0.5, 1.0, 100, 1, True),
    "max_iter": (0.99, 0.99, 1.0, 7, 7, False),
    "decay_then_growth": (0.3, 1.5, 1e-3, 100, None, True),
}


@pytest.mark.parametrize("name", list(ADJ_CASES))
def test_adjoint_commit_twin_matches_jax_loop(name, capfd):
    """The Neumann adjoint on crafted |u|^2 sequences: the JAX package's
    backward of ``_make_converge_frozen`` (its ``while_loop``, ``cond`` and
    ``body``) with a linear stand-in move (``move(a, C, T) = (l_C C + a, l_T T
    + a)``, so ``abar_i = u_C + u_T``) against the ``adjoint_commit`` twin
    driven by the same vectors: the accumulated cotangent (which fixes the
    iteration count) to 1e-15, and the iteration count, |u|^2 and the
    divergence as JAX prints them."""
    lam_c, lam_t, ratio, max_iter, n_expected, diverged = ADJ_CASES[name]
    a = jnp.asarray([0.3, -0.2, 0.1])
    cot = (jnp.asarray([1.0, 0.5, -0.25]), ratio * jnp.asarray([0.5, -1.0, 0.75]))

    def move(a_, C, T, keep=None, ad_decomp_reg=None, sg_norm=None):
        return lam_c * C + a_, lam_t * T + a_

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_frozen, "move_frozen", move)
        mp.setattr(j_frozen, "run_frozen", lambda a_, C, T, keep, **kw: (C, T, 0, 0.0))
        conv = j_frozen._make_converge_frozen.__wrapped__((), 1, 0.0, 1e-12, max_iter, 1e-8)
        _, vjp = jax.vjp(conv, a, a, a)
        da_j = np.asarray(vjp(cot)[0])
        jax.effects_barrier()
    printed = capfd.readouterr().out

    uC, uT = (torch.tensor(np.asarray(c)) for c in cot)
    st = adjoint_state(torch.zeros(3, dtype=torch.float64), uC, uT, max_iter, 1e-8)
    while not bool(st.ctl[1]):
        da_i = uC + uT
        uC, uT = lam_c * uC, lam_t * uT
        adjoint_commit_twin(st, da_i, uC, uT)
    i, done, _, _, grew, div = st.ctl.tolist()
    assert np.abs(st.da.numpy() - da_j).max() <= 1e-15 * np.abs(da_j).max()
    assert done == 1 and bool(div) == diverged
    if n_expected is not None:
        assert i == n_expected
    if diverged:  # JAX prints |u|^2 to a few digits
        m = re.search(r"diverging \(iter (\d+), \|u\|\^2=([^)]+)\)", printed)
        assert m and int(m.group(1)) == i, printed
        assert abs(float(m.group(2)) - float(st.scal[0])) <= 1e-6 * float(st.scal[0]), printed
    else:
        assert "diverging" not in printed


# ---------------------------------------------------------------------------
# the slice at D=3, chi=9
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_ctx():
    """The training loss's context at the D=3 state: the warm environment of
    tests/test_torch_abelian.py's frozen runs (JAX's init_env and 6 dynamic
    moves at chi=9), its frozen profile, and the closed warm start (the JAX
    package's frozen program for these block sets and 10 moves is then one
    compilation for both files, kept in its compile cache)."""
    ja = c4v_state()
    ta = port(ja)
    je = j_env.init_env(J_IPEPS_ABELIAN("U1", {(0, 0): ja}), CHI)
    for _ in range(6):
        je = j_ctmrg.ctm_move_sl(ja, je, PK)
    keep = j_frozen.freeze_from_env(je)
    C, T = port(je.C), port(je.T)
    C0, T0 = frozen.close_structure(ta, C, T, dict(keep))
    return ja, ta, (C, T), keep, C0, T0


def training_loss(ctx, p, stats=None, max_iter=FROZEN_ITER):
    """The loss of ``optimize_c4v_abelian``: A1 projector, normalization, the
    frozen fixed point (implicit adjoint), energy on the bipartite view."""
    _, ta, _, keep, C0, T0 = ctx
    A = make_c4v_symm_A1_abelian(flat(ta, p))
    A = A * (1.0 / A.norm())
    Cf, Tf = frozen.converge_closed(A, C0, T0, keep, max_iter=max_iter, conv_tol=1e-10,
                                    stats=stats)
    sb, eg = c4v_env.as_generic(IPEPS_ABELIAN("U1", {(0, 0): A}),
                                c4v_env.ENV_C4V_ABELIAN(CHI, Cf, Tf))
    return J1J2_ABELIAN(j1=1.0, j2=J2, device=CPU).energy_per_site(sb, eg)


@pytest.fixture(scope="module")
def fd_check(slice_ctx):
    """Central differences of the loss (h = 1e-5) along four random
    directions, and the gradient of the loss with and without the sign
    alignment ``R`` of the backward."""
    ta = slice_ctx[1]
    gen = torch.Generator().manual_seed(1)
    dirs = [torch.randn(ta.data.shape, generator=gen, dtype=torch.float64) for _ in range(4)]
    h = 1e-5
    with torch.no_grad():
        fd = [(float(training_loss(slice_ctx, ta.data + h * v))
               - float(training_loss(slice_ctx, ta.data - h * v))) / (2 * h) for v in dirs]
    out = {}
    for label, align in (("aligned", frozen.sign_alignment),
                         ("unaligned", lambda *a, **k: (None, None))):
        with mock.patch.object(frozen, "sign_alignment", align):
            p = ta.data.clone().requires_grad_()
            stats = {}
            (g,) = torch.autograd.grad(training_loss(slice_ctx, p, stats), p)
        out[label] = ([abs(float(g @ v) - f) / abs(f) for v, f in zip(dirs, fd)], stats)
    return out


def test_close_structure_grows_nothing(slice_ctx):
    """The dynamic env already holds every block the frozen move makes, so
    the port's loss is the JAX package's (whose close_structure keeps the
    sets)."""
    _, _, (C, T), _, C0, T0 = slice_ctx
    assert C0.struct is C.struct and T0.struct is T.struct


def test_gradient_matches_central_differences(fd_check):
    errs, stats = fd_check["aligned"]
    assert max(errs) <= 1e-6, errs
    assert stats["adjoint_iters"] > 0 and not stats["adjoint_diverged"]
    # the forward loop's T keeps flipping signs here: R != 1 is exercised
    assert stats["sign_aligned"][1], stats


def test_unaligned_adjoint_fails_central_differences(fd_check):
    """The reference's backward linearizes the move at the last iterate,
    where ``move(x*) = R x*`` with R != 1 (ROADMAP Queue 3): without the
    alignment the gradient misses the central differences by O(1)
    (measured 0.27-3.5 relative)."""
    errs, stats = fd_check["unaligned"]
    assert max(errs) > 0.1, errs
    assert not any(stats["sign_aligned"])


def test_loss_matches_jax(slice_ctx):
    """The loss's value against the JAX package's from the same closed (C0,
    T0): symmetrize, normalize, the frozen fixed point (JAX's compiled
    ``run_frozen``, the forward of ``_make_converge_frozen``; 10 moves each),
    energy."""
    ja, ta, _, keep, C0, T0 = slice_ctx
    A = j_symm(ja)
    A = A * (1.0 / float(A.norm()))
    Cf, Tf, n, _ = j_frozen.run_frozen(A.to_backend("jnp"), jax_tensor(C0), jax_tensor(T0), keep,
                                       max_iter=10, conv_tol=1e-10)
    assert int(n) == 10
    env = j_env.ENV_C4V_ABELIAN(CHI, Cf.to_backend("np"), Tf.to_backend("np"))
    jbp, jg = j_env.as_generic(J_IPEPS_ABELIAN("U1", {(0, 0): A}), env)
    e_j = float(J_J1J2_ABELIAN(j1=1.0, j2=J2).energy_per_site(jbp, jg).real)
    with torch.no_grad():
        e_t = float(training_loss(slice_ctx, ta.data, max_iter=10))
    assert abs(e_t - e_j) <= 1e-10, (e_t, e_j)


# ---------------------------------------------------------------------------
# the optimizer and the entry point
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory, slice_ctx):
    """Two L-BFGS epochs of the entry point (backtracking line search) on the
    D=3 state written by the JAX package, on the CPU."""
    from tpeps_torch.examples.j1j2.abelian.optim_j1j2_c4v_u1 import main

    tmp = tmp_path_factory.mktemp("optim_u1")
    path = str(tmp / "state.json")
    j_io.write_ipeps_abelian(J_IPEPS_ABELIAN("U1", {(0, 0): slice_ctx[0]}), path)
    stats = []
    e, history = main(["--instate", path, "--chi", str(CHI), "--j2", str(J2), "--opt_max_iter",
                       "2", "--OPTARGS_line_search", "backtracking", "--CTMARGS_ctm_max_iter",
                       "10", "--instate_noise", "0.05", "--seed", "7", "--out_prefix",
                       str(tmp / "run"), "--GLOBALARGS_device", "cpu"], grad_stats=stats)
    return e, history, stats, tmp


def test_optimize_c4v_abelian_two_epochs(entry_run):
    _, history, stats, _ = entry_run
    losses = history["loss"]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] <= losses[0], losses
    assert stats and all(s["adjoint_iters"] > 0 and not s["adjoint_diverged"] for s in stats)


def test_entry_point_on_written_state(entry_run):
    """The FINAL energy (dynamic engine) is finite and the best state file
    reads in both packages to the same blocks."""
    from tpeps_torch.sym.io import read_ipeps_abelian

    e, _, _, tmp = entry_run
    assert np.isfinite(e)
    path = str(tmp / "run_state.json")
    jst, tst = j_io.read_ipeps_abelian(path), read_ipeps_abelian(path)
    jb, tb = jst.site((0, 0)).blocks, tst.site((0, 0)).numpy_blocks()
    assert sorted(jb) == sorted(tb)
    assert all(np.array_equal(np.asarray(jb[q]), tb[q]) for q in jb)


# ---------------------------------------------------------------------------
# through JAX's frozen move (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_move_frozen_vjp_matches_jax(slice_ctx):
    """One ``move_frozen``'s VJP at the port's fixed point against a jitted
    ``jax.vjp`` of JAX's ``move_frozen(sg_norm=False)`` (1e-10).  Where a
    gauge tie makes the packages pick other signs, ``y_jax = R' y_port``: the
    port's VJP takes the cotangent ``R' ct``.  Slow: the jitted VJP compiles for ~75 s."""
    _, ta, _, keep, C0, T0 = slice_ctx
    Cf, Tf = frozen.converge_closed(ta, C0, T0, keep, max_iter=FROZEN_ITER, conv_tol=1e-10)
    ja, jC, jT = (jax_tensor(t) for t in (ta, Cf, Tf))
    move = jax.jit(lambda a, C, T: jax.vjp(
        lambda *x: j_frozen.move_frozen(*x, keep=dict(keep), sg_norm=False), a, C, T))
    (yC, yT), vjp = move(ja, jC, jT)
    rng = np.random.RandomState(6)
    cC, cT = random_like(rng, yC), random_like(rng, yT)
    ga, gC, gT = vjp((cC, cT))
    leaves = [t.data.clone().requires_grad_() for t in (ta, Cf, Tf)]
    tC, tT = frozen.move_frozen(*(flat(t, x) for t, x in zip((ta, Cf, Tf), leaves)), keep)
    rC = torch.sign(port(yC).data) * torch.sign(tC.data.detach())
    rT = torch.sign(port(yT).data) * torch.sign(tT.data.detach())
    assert torch.allclose(port(yC).data, rC * tC.data, atol=1e-12)
    assert torch.allclose(port(yT).data, rT * tT.data, atol=1e-12)
    g = torch.autograd.grad((tC.data, tT.data), leaves, (rC * port(cC).data, rT * port(cT).data))
    for jg, t, gi in zip((ga, gC, gT), (ta, Cf, Tf), g):
        assert block_err(jg, t, gi) <= 1e-10


@pytest.mark.slow
def test_whole_gradient_against_jax(slice_ctx):
    """JAX's gradient of the same training loss (``_make_converge_frozen``'s
    custom VJP) from the same (C0, T0).  Where R = 1 the port's backward is
    JAX's and the two agree to 1e-8; where R != 1 (this state's T) JAX
    linearizes the move at a point that is not its fixed point, so they are
    expected to differ: then the port's gradient holds to central
    differences and JAX's does not.  Slow: more than 290 s here."""
    ja, ta, _, keep, C0, T0 = slice_ctx
    conv = j_frozen._make_converge_frozen(keep, FROZEN_ITER, 1e-10, 1e-12, 100, 1e-8)
    jC0, jT0 = jax_tensor(C0), jax_tensor(T0)

    def loss(A):
        A = j_symm(A)
        A = A * (1.0 / A.norm())
        Cf, Tf = conv(A, jC0, jT0)
        sb, eg = j_env.as_generic(J_IPEPS_ABELIAN("U1", {(0, 0): A}),
                                  j_env.ENV_C4V_ABELIAN(CHI, Cf, Tf))
        return J_J1J2_ABELIAN(j1=1.0, j2=J2).energy_per_site(sb, eg).real

    gj = jax.jit(jax.grad(loss))(ja.to_backend("jnp"))
    gj = port(gj).data
    p = ta.data.clone().requires_grad_()
    stats = {}
    (gt,) = torch.autograd.grad(training_loss(slice_ctx, p, stats), p)
    if not any(stats["sign_aligned"]):
        assert float((gt - gj).abs().max()) <= 1e-8 * float(gt.abs().max())
        return
    gen = torch.Generator().manual_seed(1)
    v = torch.randn(p.shape, generator=gen, dtype=torch.float64)
    with torch.no_grad():
        fd = (float(training_loss(slice_ctx, ta.data + 1e-5 * v))
              - float(training_loss(slice_ctx, ta.data - 1e-5 * v))) / 2e-5
    assert abs(float(gt @ v) - fd) <= 1e-6 * abs(fd)
    assert abs(float(gj @ v) - fd) > 1e-3 * abs(fd)
