"""The U(1) C4v abelian CTMRG forward path: port against tpeps on the CPU.

A D=3 U(1) C4v state (aux {-1:1,0:1,1:1}, phys {-1:1,1:1}, n=1, signature
(1,1,1,1,1)) is built once from numpy and goes to both packages; the port's
kernels run on their twins.  Tolerances: init_env RDMs 1e-12; the corner
spectra of 6 dynamic moves 1e-12 per move (the twin of
tests/test_abelian.py:142-173 with trivial charges, plus the charged state);
``run`` to 1e-9 with the energy and observables 1e-10; the frozen engine
from the same closed (C, T) after 1 and after 10 moves, C elementwise and
T's magnitudes elementwise, 1e-12 (the frozen gauge fixing leaves a sign
ambiguity, see ``abs_diff``); the frozen_commit twin against the JAX loop
body on the same raw move, 1e-15 and dist2 1e-12 relative; the entry
point's energy 1e-10.  JAX's frozen program is compiled once for the module
(max_iter is static; the one-move run stops on a conv_tol above any
distance).
"""

import functools
import importlib.util
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax

from tpeps.config import CtmArgs as J_CtmArgs
from tpeps.ctm.c4v_abelian import ctmrg as j_ctmrg
from tpeps.ctm.c4v_abelian import env as j_env
from tpeps.ctm.c4v_abelian import frozen as j_frozen
from tpeps.ctm.generic_abelian import rdm as j_rdm
from tpeps.ipeps.ipeps_abelian import IPEPS_ABELIAN as J_IPEPS_ABELIAN
from tpeps.ipeps.ipeps_abelian import make_c4v_symm_A1_abelian as j_symm
from tpeps.models.abelian.j1j2 import J1J2_ABELIAN as J_J1J2_ABELIAN
from tpeps.sym import io as j_io
from tpeps.sym.tensor import AbelianTensor as J_AbelianTensor
from tpeps.sym.tensor import leg as j_leg
from tpeps_torch.config import CtmArgs
from tpeps_torch.ctm.c4v_abelian import ctmrg, frozen
from tpeps_torch.ctm.c4v_abelian import env as c4v_env
from tpeps_torch.ctm.generic_abelian import rdm
from tpeps_torch.io.convert import abelian_to_torch
from tpeps_torch.ipeps.ipeps_abelian import IPEPS_ABELIAN
from tpeps_torch.kernels.frozen import frozen_commit_twin, frozen_state
from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
PHYS, AUX = {-1: 1, 1: 1}, {-1: 1, 0: 1, 1: 1}
PK = dict(svd_reltol=1e-12, eps_multiplet=1e-12)
J2 = 0.3


def port(t):
    spec = (t.sym, t.signature, [l.charges for l in t.legs], [l.pshift for l in t.legs], t.n,
            t.fermionic, {q: np.asarray(b) for q, b in t.blocks.items()})
    return abelian_to_torch(spec, device=CPU)


def c4v_state(seed=0, charged=True):
    """The JAX site: RandomState blocks, C4v-projected, unit norm."""
    rng = np.random.RandomState(seed)
    if charged:
        legs, n = (j_leg(PHYS),) + (j_leg(AUX),) * 4, 1
    else:
        legs, n = (j_leg({0: 2}),) + (j_leg({0: 3}),) * 4, 0
    a = J_AbelianTensor("U1", (1,) * 5, legs, n)
    a = j_symm(a.copy_with({q: rng.rand(*a.block_shape(q)) - 0.5
                            for q in sorted(a.all_allowed_blocks())}))
    return a * (1.0 / float(a.norm()))


@pytest.fixture(scope="module")
def site():
    ja = c4v_state()
    return ja, port(ja)


def spectrum(env):
    s = env.get_spectrum()
    return s / s[0]


def max_diff(jt, tt):
    tb = tt.numpy_blocks()
    assert sorted(tb) == sorted(jt.blocks)
    return max(float(np.abs(np.asarray(b) - tb[q]).max()) for q, b in jt.blocks.items())


RDMS = ("rdm1x1", "rdm2x1", "rdm1x2", "rdm2x2", "rdm2x2_NNN_11", "rdm2x2_NNN_1n1")


@pytest.mark.parametrize("name", RDMS)
def test_init_env_rdms_match_jax(site, name):
    ja, ta = site
    jst, jg = j_env.as_generic(J_IPEPS_ABELIAN("U1", {(0, 0): ja}),
                               j_env.init_env(J_IPEPS_ABELIAN("U1", {(0, 0): ja}), 9))
    tst, tg = c4v_env.as_generic(IPEPS_ABELIAN("U1", {(0, 0): ta}),
                                 c4v_env.init_env(IPEPS_ABELIAN("U1", {(0, 0): ta}), 9))
    coord = (0, 1) if name.endswith("1n1") else (0, 0)
    ref = np.asarray(getattr(j_rdm, name)(coord, jst, jg))
    got = getattr(rdm, name)(coord, tst, tg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("charged", [False, True], ids=["trivial_charges", "charged"])
def test_moves_match_jax(charged):
    """6 dynamic moves from each package's init_env: corner spectra per move
    and the chi profile."""
    ja = c4v_state(seed=1, charged=charged)
    ta = port(ja)
    je = j_env.init_env(J_IPEPS_ABELIAN("U1", {(0, 0): ja}), 18)
    te = c4v_env.init_env(IPEPS_ABELIAN("U1", {(0, 0): ta}), 18)
    for i in range(6):
        je = j_ctmrg.ctm_move_sl(ja, je, PK)
        te = ctmrg.ctm_move_sl(ta, te, PK)
        s1, s2 = spectrum(je), spectrum(te)
        assert te.C.legs[0].charges == je.C.legs[0].charges, f"move {i + 1}"
        np.testing.assert_allclose(s2, s1, rtol=0, atol=1e-12, err_msg=f"move {i + 1}")


@pytest.fixture(scope="module")
def converged(site):
    ja, ta = site
    jst, tst = J_IPEPS_ABELIAN("U1", {(0, 0): ja}), IPEPS_ABELIAN("U1", {(0, 0): ta})
    je, jh = j_ctmrg.run(jst, j_env.init_env(jst, 9), J_CtmArgs(ctm_max_iter=60,
                                                                 ctm_conv_tol=1e-9))
    te, th = ctmrg.run(tst, c4v_env.init_env(tst, 9), CtmArgs(ctm_max_iter=60, ctm_conv_tol=1e-9))
    return jst, je, jh, tst, te, th


def test_run_energy_and_observables_match_jax(converged):
    jst, je, jh, tst, te, th = converged
    assert len(th["conv_crit"]) == len(jh["conv_crit"]) and th["conv_crit"][-1] < 1e-9
    np.testing.assert_allclose(spectrum(te), spectrum(je), rtol=0, atol=1e-9)
    jm, tm = J_J1J2_ABELIAN(j1=1.0, j2=J2), J1J2_ABELIAN(j1=1.0, j2=J2, device=CPU)
    jbp, jg = j_env.as_generic(jst, je)
    tbp, tg = c4v_env.as_generic(tst, te)
    assert abs(float(tm.energy_per_site(tbp, tg)) - float(jm.energy_per_site(jbp, jg))) < 1e-10
    (ov_j, lab_j), (ov_t, lab_t) = jm.eval_obs(jbp, jg), tm.eval_obs(tbp, tg)
    assert lab_t == lab_j
    for l, x, y in zip(lab_j, ov_j, ov_t):
        assert abs(complex(x) - complex(y)) < 1e-10, l


@pytest.fixture(scope="module")
def frozen_runs(site):
    """JAX's run_frozen from one warm env, compiled once: one move (a
    conv_tol above any distance) and ten moves (conv_tol 0)."""
    ja, ta = site
    je = j_env.init_env(J_IPEPS_ABELIAN("U1", {(0, 0): ja}), 9)
    for _ in range(6):
        je = j_ctmrg.ctm_move_sl(ja, je, PK)
    keep = j_frozen.freeze_from_env(je)
    jA, jC, jT = ja.to_backend("jnp"), je.C.to_backend("jnp"), je.T.to_backend("jnp")
    runs = {}
    for label, tol in (("one", 1e30), ("ten", 0.0)):
        Cf, Tf, n, d2 = j_frozen.run_frozen(jA, jC, jT, keep, max_iter=10, conv_tol=tol)
        jax.block_until_ready(jax.tree_util.tree_leaves((Cf, Tf)))
        runs[label] = (Cf, Tf, int(n), float(d2))
    return ta, port(je.C), port(je.T), keep, runs


def abs_diff(jt, tt):
    """Max difference of the entries' magnitudes: the frozen gauge fixing picks
    each isometry column's sign from its largest entry, and the ket/bra swap
    symmetry of the double layer makes two entries of equal magnitude, so a
    rounding-level difference may flip a column's sign (in T, a sign pattern
    on a block's rows or columns; C' is diagonal in the kept basis)."""
    tb = tt.numpy_blocks()
    assert sorted(tb) == sorted(jt.blocks)
    return max(float(np.abs(np.abs(np.asarray(b)) - np.abs(tb[q])).max())
               for q, b in jt.blocks.items())


@pytest.mark.parametrize("moves", ["one", "ten"])
def test_frozen_matches_jax(frozen_runs, moves):
    ta, C, T, keep, runs = frozen_runs
    jC, jT, jn, jd2 = runs[moves]
    C2, T2 = frozen.close_structure(ta, C, T, dict(keep))
    assert C2.struct is C.struct and T2.struct is T.struct  # already closed
    if moves == "one":
        tC, tT = frozen.move_frozen(ta, C, T, keep)
        assert jn == 1
    else:
        tC, tT, n, d2 = frozen.run_frozen(ta, C, T, keep, max_iter=10, conv_tol=0.0)
        assert n == jn == 10
    assert max_diff(jC, tC) < 1e-12 and abs_diff(jT, tT) < 1e-12


def test_frozen_commit_twin_matches_jax_loop_body(frozen_runs):
    """One move's raw outputs through the frozen_commit twin against the JAX
    loop body's symmetrize, normalize, reindex and dist2 on the same raw
    outputs: C and T to 1e-15, dist2 to 1e-12 relative."""
    from tpeps.ctm.c4v_abelian.frozen import _env_dist2, _normalized
    from tpeps.sym.frozen import reindex_like

    ta, C, T, keep, runs = frozen_runs
    nC, nT = frozen._move_raw(ta, C, T, dict(keep))
    st = frozen_state(C.data, T.data, 10, 1e30)
    frozen_commit_twin(st, nC.data, nT.data,
                       frozen.partner_index(C.struct, frozen.C_PARTNER, CPU),
                       frozen.partner_index(T.struct, frozen.T_PARTNER, CPU))
    assert st.ctl[:2].tolist() == [1, 1]

    def jax_tensor(t):
        return J_AbelianTensor(t.sym, t.signature, [j_leg(dict(l.charges)) for l in t.legs], t.n,
                               t.numpy_blocks())

    @jax.jit  # as the loop body runs: one program, not one per block operation
    def body(jnC, jnT, jC0, jT0):
        jC1 = reindex_like(_normalized(0.5 * (jnC + jnC.transpose((1, 0)).conj_blocks()), True),
                           jC0)
        jT1 = reindex_like(_normalized(0.5 * (jnT + jnT.transpose((3, 1, 2, 0)).conj_blocks()),
                                       True), jT0)
        return jC1, jT1, _env_dist2((jC1, jT1), (jC0, jT0))

    jC1, jT1, jd2 = body(*(jax_tensor(t).to_backend("jnp") for t in (nC, nT, C, T)))
    jd2 = float(jd2)
    assert abs(float(st.dist2) - jd2) <= 1e-12 * jd2
    tC = type(C)._flat(C, C.struct, st.C)
    tT = type(T)._flat(T, T.struct, st.T)
    assert max_diff(jC1, tC) < 1e-15 and max_diff(jT1, tT) < 1e-15


def _exact_commit_case(max_iter=10, conv_tol=0.5):
    """A 2x2 C block (partners transposed) and three T entries, the first
    with no partner (-1: its block absent); the symmetrized, scaled values
    are exact: C' = [0.5, 0.25, 0.25, -1], T' = [0.5, 1, 1].  The committed
    C differs from C' by 0.5 in one entry, so dist2 = 0.25 exactly."""
    f = lambda *v: torch.tensor(v, dtype=torch.float64)
    rawC, pC = f(2.0, 1.0, 1.0, -4.0), torch.tensor([0, 2, 1, 3])
    rawT, pT = f(2.0, 3.0, 1.0), torch.tensor([-1, 2, 1])
    st = frozen_state(f(0.5, 0.25, 0.25, -0.5), f(0.5, 1.0, 1.0), max_iter, conv_tol)
    return st, (rawC, rawT, pC, pT)


def test_frozen_commit_twin_partnerless_entries_and_exact_values():
    st, raw = _exact_commit_case()
    frozen_commit_twin(st, *raw)
    assert st.C.tolist() == [0.5, 0.25, 0.25, -1.0] and st.T.tolist() == [0.5, 1.0, 1.0]
    assert float(st.dist2) == 0.25


@pytest.mark.parametrize("conv_tol,done", [(0.5, 1), (0.4999999, 0)],
                         ids=["dist2_at_tol2", "dist2_above_tol2"])
def test_frozen_commit_twin_dist2_at_conv_tol_squared(conv_tol, done):
    """dist2 exactly at conv_tol^2 ends the loop (the test is dist2 > tol^2)."""
    st, raw = _exact_commit_case(conv_tol=conv_tol)
    frozen_commit_twin(st, *raw)
    assert st.ctl[:2].tolist() == [1, done]


def test_frozen_commit_twin_max_iter_reached():
    st, raw = _exact_commit_case(max_iter=2, conv_tol=0.0)
    st.ctl[0] = 1
    frozen_commit_twin(st, *raw)
    assert st.ctl[:2].tolist() == [2, 1] and st.C.tolist() == [0.5, 0.25, 0.25, -1.0]


def test_frozen_commit_twin_done_leaves_the_state():
    st, raw = _exact_commit_case(conv_tol=0.0)
    st.ctl[1] = 1
    before = [x.clone() for x in st]
    frozen_commit_twin(st, *raw)
    for x, y in zip(st, before):
        assert torch.equal(x, y)


def _block_reduce(vals, op):
    """``block_reduce2`` of ``csrc/frozen_commit.cu`` over a block's
    per-thread values (a multiple of 32): an xor butterfly in each warp, lane
    0's result, then the warps in order."""
    out = None
    for w in range(0, len(vals), 32):
        buf = list(vals[w:w + 32])
        for o in (16, 8, 4, 2, 1):
            buf = [op(buf[i], buf[i ^ o]) for i in range(32)]
        out = buf[0] if out is None else op(out, buf[0])
    return out


def _frozen_commit_partition(state, rawC, rawT, pC, pT, grid, nt=64, keep=8):
    """A plain-torch model of how ``csrc/frozen_commit.cu`` splits the work,
    in place on ``state``: C and T one index space, thread ``tid`` of
    ``grid`` x ``nt`` taking every stride-th element, its first ``keep``
    symmetrized values and their committed ones kept and the rest read again
    after the barrier; per-block maxima met order-free (the kernel's atomic
    max on |x|'s bits), the product with 1 / max, per-block dist2 partials
    and the last block's sum in the kernel's order.  It checks the index
    coverage and the orders of the split, not the kernel, which runs only on
    the card (chip_smoke.py's frozen_commit_checks hold it to the twin there).
    Returns the times each element was committed."""
    C, T, dist2, conv_tol, ctl = state
    if int(ctl[1]):
        return None
    nC, n = rawC.numel(), rawC.numel() + rawT.numel()
    stride, zero = grid * nt, torch.zeros((), dtype=C.dtype)

    def sym(e):
        raw, p, i = (rawC, pC, e) if e < nC else (rawT, pT, e - nC)
        q = int(p[i])
        return 0.5 * (raw[i] + (raw[q] if q >= 0 else zero))

    kept, mC, mT = {}, [], []
    for b in range(grid):
        tC, tT = [], []
        for t in range(nt):
            tid, aC, aT = b * nt + t, zero, zero
            for r, e in enumerate(range(tid, n, stride)):
                v = sym(e)
                if r < keep:  # the value and the committed one, before the barrier
                    kept[e] = (v, C[e].clone() if e < nC else T[e - nC].clone())
                aC, aT = (torch.fmax(aC, v.abs()), aT) if e < nC else (aC, torch.fmax(aT, v.abs()))
            tC.append(aC)
            tT.append(aT)
        mC.append(_block_reduce(tC, torch.fmax))
        mT.append(_block_reduce(tT, torch.fmax))

    def last_block(parts, op, init):  # thread i % nt sums parts i, then the block
        acc = [init] * nt
        for i, p in enumerate(parts):
            acc[i % nt] = op(acc[i % nt], p)
        return _block_reduce(acc, op)

    # the blocks' maxima in arrival order, which the kernel does not fix:
    # here the reverse of the block order
    iC = 1.0 / functools.reduce(torch.fmax, mC[::-1], zero)
    iT = 1.0 / functools.reduce(torch.fmax, mT[::-1], zero)
    hits, part_d = torch.zeros(n, dtype=torch.int64), []
    for b in range(grid):
        ds = []
        for t in range(nt):
            d = zero
            for e in range(b * nt + t, n, stride):
                dst, i, inv = (C, e, iC) if e < nC else (T, e - nC, iT)
                v, old = kept[e] if e in kept else (sym(e), dst[i])
                v = v * inv
                x = v - old
                d = d + x * x
                dst[i] = v
                hits[e] += 1
            ds.append(d)
        part_d.append(_block_reduce(ds, torch.add))
    s = last_block(part_d, torch.add, zero)
    dist2.fill_(s)
    it = int(ctl[0]) + 1
    ctl[0] = it
    ctl[1] = int(not (it < int(ctl[3]) and float(s) > float(conv_tol) ** 2))
    return hits


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("keep", [2, 8], ids=["past_keep", "all_kept"])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "max_ties"])
def test_frozen_commit_partition_is_the_twin(dtype, keep, ties):
    """The kernel's partition on a chi=9, D=3 frozen layout (C a 9 x 9 block,
    81 entries; T a (9, 3, 3, 9) block, 729, its first 81 entries without a
    partner), 3 blocks of 64 threads (two warps): with 2 values kept a
    thread most are symmetrized again after the barrier, with 8 all are
    kept; with ties, the largest magnitude appears many times, in both
    signs.  Every element committed once, C and T bit-identical to the
    twin, (i, done) equal, dist2 to 1e-12 (f64) or 1e-5 (f32) relative
    (summation order)."""
    rng = np.random.RandomState(5)
    t = lambda n: torch.from_numpy(rng.rand(n) - 0.5).to(dtype)
    rawC, rawT = t(81), t(729)
    if ties:
        rawC[::7] = 3.0
        rawT[5::11] = -3.0
    pC = torch.arange(81).view(9, 9).T.reshape(-1)
    pT = torch.arange(729).view(9, 3, 3, 9).permute(3, 1, 2, 0).reshape(-1).clone()
    pT[:81] = -1
    st_m, st_t = (frozen_state(t(81), t(729), 10, 0.0) for _ in range(2))
    st_t.C.copy_(st_m.C)
    st_t.T.copy_(st_m.T)
    hits = _frozen_commit_partition(st_m, rawC, rawT, pC, pT, grid=3, keep=keep)
    frozen_commit_twin(st_t, rawC, rawT, pC, pT)
    assert bool((hits == 1).all())
    assert torch.equal(st_m.C, st_t.C) and torch.equal(st_m.T, st_t.T)
    assert st_m.ctl[:2].tolist() == st_t.ctl[:2].tolist() == [1, 0]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert abs(float(st_m.dist2) - float(st_t.dist2)) <= tol * float(st_t.dist2)


def test_converge_frozen_forward_only(frozen_runs):
    """The forward from a detached site; a site that requires grad now takes
    the implicit adjoint (tests/test_torch_abelian_grad.py holds its values):
    the result carries a graph and the backward gives a finite gradient."""
    ta, C, T, keep, _ = frozen_runs
    env = c4v_env.ENV_C4V_ABELIAN(9, C, T)
    out = frozen.converge_frozen(ta, env, max_iter=3)
    assert out.C.struct is C.struct and not out.C.data.requires_grad
    x = ta.data.clone().requires_grad_()
    out = frozen.converge_frozen(type(ta)._flat(ta, ta.struct, x), env, max_iter=3)
    assert out.C.struct is C.struct and out.C.data.requires_grad
    (g,) = torch.autograd.grad((out.C.data ** 2).sum() + (out.T.data ** 2).sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_ctmrg_j1j2_c4v_u1", ROOT / "examples" / "j1j2" / "abelian" / "ctmrg_j1j2_c4v_u1.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", ["ctmrg_j1j2_c4v_u1.py"]):
        spec.loader.exec_module(module)
    return module


def test_entry_point_matches_jax(tmp_path, site):
    from tpeps_torch.examples.j1j2.abelian.ctmrg_j1j2_c4v_u1 import main

    ja, _ = site
    path = str(tmp_path / "state.json")
    j_io.write_ipeps_abelian(J_IPEPS_ABELIAN("U1", {(0, 0): ja}), path)
    jmod = _jax_example()
    for k, v in dict(instate=path, chi=9, j2=J2, CTMARGS_ctm_max_iter=5,
                     CTMARGS_ctm_conv_tol=1e-8).items():
        setattr(jmod.args, k, v)
    e_j, obs_j, labels_j = jmod.main()
    stats = []
    e_t, obs_t, labels_t = main(["--instate", path, "--chi", "9", "--j2", str(J2),
                                 "--CTMARGS_ctm_max_iter", "5", "--CTMARGS_ctm_conv_tol", "1e-8",
                                 "--GLOBALARGS_device", "cpu"], stats=stats)
    assert len(stats) == 5
    assert abs(e_t - e_j) < 1e-10, (e_t, e_j)
    assert labels_t == labels_j
    for l, x, y in zip(labels_j, obs_j, obs_t):
        assert abs(complex(x) - complex(y)) < 1e-10, l
