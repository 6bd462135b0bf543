"""The generic-cell U(1) abelian engine: the port against tpeps on the CPU.

The state is a random U(1) 2-site bipartite state in the canonical signature
(1, 1, 1, -1, -1), built once from ``np.random.RandomState(0)`` and given to
both packages: site (0, 0) random blocks (aux {-1:1, 0:1, 1:1}, phys {-1:1,
1:1}, n=1) projected onto C4v's A1 in the uniform signature, its (d, r) legs
flipped; site (1, 0) its Neel partner (the charge conjugate with the phase
-1 on the physical charge +1, n=-1).  Independent random sites make a CTMRG
that does not converge at chi <= 18 (the corner spectra keep moving by O(1)
per sweep), so they have no frozen profile and no fixed point.
chi = 9; the port runs its kernels' twins, on one torch thread.

Tolerances (and the readings they came from, this file's runs): the init env
and all six RDMs 1e-12 (read 4e-16); ``init_eye`` block for block exact; one
``ctm_move`` per direction and two sweeps of ``run`` against JAX's numpy host
engine, corner spectra 1e-10 (read 3e-14), energy and ``eval_obs`` 1e-10; one
``ctm_move_frozen`` per direction against JAX's eager one from one closed
env, C and T elementwise 1e-10 with JAX's sign fixing given the port's pivot
rule, |C| and |T| with JAX's own (the ket/bra symmetry ties pivots, which
JAX's argmax picks by rounding, ROADMAP Queue 3); the frozen sweep's energy
against the dynamic run's from the same start after 4 sweeps 1e-6 (read 0);
the implicit gradient of ``optimize_generic_abelian``'s loss against central
differences (h = 1e-5) along three random directions, 1e-6 relative (read
1e-8 to 5e-6 at conv_tol 1e-10, see the test); the K10 twins against the
JAX package's ``_normalized`` / ``_env_dist2`` / ``jax.vjp(_normalized)``
1e-15 / 1e-12; JSON byte for byte; the entry point's FINAL energy 1e-10.
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from tpeps.config import CtmArgs as J_CtmArgs
from tpeps.ctm.generic_abelian import ctmrg as j_ctmrg
from tpeps.ctm.generic_abelian import env as j_env
from tpeps.ctm.generic_abelian import frozen as j_frozen
from tpeps.ctm.generic_abelian import rdm as j_rdm
from tpeps.ipeps.ipeps_abelian import IPEPS_ABELIAN as J_IPEPS_ABELIAN
from tpeps.ipeps.ipeps_abelian import make_c4v_symm_A1_abelian as j_symm
from tpeps.models.abelian.j1j2 import J1J2_ABELIAN as J_J1J2_ABELIAN
from tpeps.sym import io as j_io
from tpeps.sym.tensor import AbelianTensor as J_AbelianTensor
from tpeps.sym.tensor import leg as j_leg
from test_torch_abelian import _block_reduce
from tpeps_torch.config import CtmArgs
from tpeps_torch.ctm.generic_abelian import ctmrg, frozen, rdm
from tpeps_torch.ctm.generic_abelian import env as g_env
from tpeps_torch.io.convert import (abelian_to_torch, env_abelian_to_numpy, env_abelian_to_torch,
                                    ipeps_abelian_to_numpy, ipeps_abelian_to_torch)
from tpeps_torch.io.convert import config_from_dict
from tpeps_torch.ipeps.ipeps_abelian import IPEPS_ABELIAN, bipartite
from tpeps_torch.kernels import frozen as kfrozen
from tpeps_torch.kernels import frozen_generic as kgen
from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
from tpeps_torch.optim.abelian import generic_abelian_losses
from tpeps_torch.sym import io as t_io

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
PHYS, AUX = {-1: 1, 1: 1}, {-1: 1, 0: 1, 1: 1}
CHI, J2 = 9, 0.3
PK = dict(svd_reltol=1e-8, eps_multiplet=1e-8)  # the CtmArgs defaults of both packages
DIRS = ((0, -1), (-1, 0), (0, 1), (1, 0))
RDMS = ("rdm1x1", "rdm2x1", "rdm1x2", "rdm2x2", "rdm2x2_NNN_11", "rdm2x2_NNN_1n1")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the twins launch many small operations, which a
    thread pool only slows down (7x on 8 threads here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port(t):
    spec = (t.sym, t.signature, [l.charges for l in t.legs], [l.pshift for l in t.legs], t.n,
            t.fermionic, {q: np.asarray(b) for q, b in t.blocks.items()})
    return abelian_to_torch(spec, device=CPU)


def jax_tensor(t, backend=np.asarray):
    """The port's (non-fermionic) tensor as the JAX package's."""
    return J_AbelianTensor(t.sym, t.signature, [j_leg(dict(l.charges), l.pshift) for l in t.legs],
                           t.n, {q: backend(b) for q, b in t.numpy_blocks().items()})


def jax_env(env, backend=np.asarray):
    return j_env.ENV_ABELIAN(env.chi, {k: jax_tensor(t, backend) for k, t in env.C.items()},
                             {k: jax_tensor(t, backend) for k, t in env.T.items()})


def bipartite_sites(seed=0, aux=AUX):
    """The JAX sites of the module's state (numpy blocks)."""
    rng = np.random.RandomState(seed)
    a = J_AbelianTensor("U1", (1,) * 5, (j_leg(PHYS),) + (j_leg(aux),) * 4, 1)
    a = j_symm(a.copy_with({q: rng.rand(*a.block_shape(q)) - 0.5
                            for q in sorted(a.all_allowed_blocks())})).flip_charges((3, 4))
    A = a * (1.0 / float(a.norm()))
    B = A.charge_conjugate()
    B = B.copy_with({qs: (-b if qs[0] == 1 else b) for qs, b in B.blocks.items()})
    return {(0, 0): A, (1, 0): B}


@pytest.fixture(scope="module")
def states():
    sites = bipartite_sites()
    jst = J_IPEPS_ABELIAN("U1", sites, vertexToSite=bipartite, lX=2, lY=1)
    tst = IPEPS_ABELIAN("U1", {c: port(a) for c, a in sites.items()}, vertexToSite=bipartite,
                        lX=2, lY=1)
    assert all(a.signature == (1, 1, 1, -1, -1) for a in tst.sites.values())
    return jst, tst


def spectra_err(je, te, chi):
    return float(np.abs(j_ctmrg._corner_spectra(je, chi) - ctmrg._corner_spectra(te, chi)).max())


def max_block_diff(jt, tt, magnitude=False):
    tb = tt.numpy_blocks()
    assert sorted(tb) == sorted(jt.blocks)
    f = np.abs if magnitude else (lambda x: x)
    return max(float(np.abs(f(np.asarray(b)) - f(tb[q])).max()) for q, b in jt.blocks.items())


# ---------------------------------------------------------------------------
# the dynamic engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RDMS)
def test_init_env_rdms_match_jax(states, name):
    jst, tst = states
    je, te = j_env.init_env(jst, CHI), g_env.init_env(tst, CHI)
    coords = ((0, 1), (1, 1)) if name.endswith("1n1") else ((0, 0), (1, 0))
    for coord in coords:
        ref = np.asarray(getattr(j_rdm, name)(coord, jst, je))
        got = getattr(rdm, name)(coord, tst, te).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, err_msg=str(coord))


def test_init_eye_matches_jax(states):
    jst, tst = states
    je, te = j_env.init_env(jst, CHI, "eye"), g_env.init_env(tst, CHI, "eye")
    for jg, tg in ((je.C, te.C), (je.T, te.T)):
        assert sorted(jg) == sorted(tg)
        for k, jt in jg.items():
            assert tg[k].signature == jt.signature
            assert [l.charges for l in tg[k].legs] == [l.charges for l in jt.legs]
            assert max_block_diff(jt, tg[k]) == 0.0


def test_env_with_grading_clone_and_staggered_site(states):
    """``env_with_grading`` flags every tensor and shares its buffer, ``clone``
    copies the dicts and shares the tensors (as the JAX package's);
    ``make_staggered_signature_site`` has the canonical signature and JAX's
    blocks (the random values come from another generator)."""
    from tpeps.ipeps.ipeps_abelian import make_staggered_signature_site as j_site
    from tpeps_torch.ipeps.ipeps_abelian import make_staggered_signature_site

    jst, tst = states
    te = g_env.init_env(tst, CHI)
    for graded, src in ((g_env.env_with_grading(te, True), te),
                        (j_env.env_with_grading(j_env.init_env(jst, CHI), True), None)):
        for k, t in graded.C.items():
            assert t.fermionic and (src is None or t.data is src.C[k].data)
    cl = te.clone()
    assert cl.C is not te.C and all(cl.C[k] is te.C[k] for k in te.C)
    ja = j_site(jax.random.PRNGKey(0), "U1", j_leg(PHYS), j_leg(AUX), 1)
    ta = make_staggered_signature_site(torch.Generator().manual_seed(0), "U1",
                                       g_env.leg(PHYS), g_env.leg(AUX), 1)
    assert ta.signature == ja.signature == (1, 1, 1, -1, -1)
    assert sorted(ta.blocks) == sorted(ja.blocks)
    assert all(tuple(ta.blocks[q].shape) == np.shape(b) for q, b in ja.blocks.items())


@pytest.mark.parametrize("direction", DIRS)
def test_ctm_move_matches_jax(states, direction):
    """One directional move from each package's init_env: every corner's
    spectrum and chi legs."""
    jst, tst = states
    je = j_ctmrg.ctm_move(direction, jst, j_env.init_env(jst, CHI), CHI, PK)
    te = ctmrg.ctm_move(direction, tst, g_env.init_env(tst, CHI), CHI, PK)
    assert all([l.charges for l in te.C[k].legs] == [l.charges for l in je.C[k].legs]
               for k in je.C)
    assert spectra_err(je, te, CHI) <= 1e-10


def test_run_energy_and_observables_match_jax(states):
    """Two sweeps of ``run`` (12 directional moves) against JAX's host engine:
    the corner spectra, the energy and the observables."""
    jst, tst = states
    cfg = dict(ctm_max_iter=2, ctm_conv_tol=0.0)
    je, jh = j_ctmrg.run(jst, j_env.init_env(jst, CHI), J_CtmArgs(**cfg))
    stats = []
    te, th = ctmrg.run(tst, g_env.init_env(tst, CHI), CtmArgs(**cfg), stats=stats)
    assert len(stats) == 2 and np.allclose(th["conv_crit"], jh["conv_crit"], rtol=0, atol=1e-10)
    assert spectra_err(je, te, CHI) <= 1e-10
    jm, tm = J_J1J2_ABELIAN(j1=1.0, j2=J2), J1J2_ABELIAN(j1=1.0, j2=J2, device=CPU)
    assert abs(float(tm.energy_per_site(tst, te))
               - float(jm.energy_per_site(jst, je).real)) <= 1e-10
    (ov_j, lab_j), (ov_t, lab_t) = jm.eval_obs(jst, je), tm.eval_obs(tst, te)
    assert lab_t == lab_j
    for l, x, y in zip(lab_j, ov_j, ov_t):
        assert abs(complex(x) - complex(y)) <= 1e-10, l


# ---------------------------------------------------------------------------
# the frozen engine and the gradient
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train(states):
    """The context of ``optimize_generic_abelian``'s loss (30 dynamic sweeps,
    stopping at conv_tol 1e-10, the profiles, the closed warm start) and the
    loss itself (the frozen fixed point to conv_tol, the energy)."""
    _, tst = states
    cfg = config_from_dict({"main": {"chi": CHI}, "ctm": {"ctm_max_iter": 30,
                                                          "ctm_conv_tol": 1e-10}})
    model = J1J2_ABELIAN(j1=1.0, j2=J2, device=CPU)
    stats = []
    p0, ctx_fn, loss_fn, norm_sites = generic_abelian_losses(tst, model.energy_per_site, cfg,
                                                             grad_stats=stats)
    with torch.no_grad():
        ctx = ctx_fn(p0)
    st = IPEPS_ABELIAN("U1", norm_sites(p0), vertexToSite=bipartite, lX=2, lY=1)
    return st, ctx[1], frozen._prof_dict(ctx[0]), p0, loss_fn, stats, ctx


def jax_fix_svd_signs_first_tied(U, Vh):
    """The JAX package's ``fix_svd_signs`` with the port's pivot rule: of the
    entries within ``PIVOT_TIE_REL`` of a column's largest magnitude, the
    first is the pivot (``argmax`` of the boolean takes the first)."""
    from tpeps_torch.linalg.svd import PIVOT_TIE_REL

    Ua = jnp.abs(jax.lax.stop_gradient(U))
    idx = jnp.argmax(Ua >= Ua.max(axis=0, keepdims=True) * (1.0 - PIVOT_TIE_REL), axis=0)
    pivots = U[idx, jnp.arange(U.shape[1])]
    phase = jnp.sign(pivots) + (pivots == 0)
    return U * phase[None, :], Vh * phase[:, None]


def fix_svd_signs_last_tied(U, Vh):
    """The port's ``fix_svd_signs`` with the last of the tied entries as the
    pivot: another gauge of the same decomposition."""
    from tpeps_torch.linalg.svd import PIVOT_TIE_REL

    Ua = U.detach().abs()
    tied = Ua >= Ua.amax(dim=0, keepdim=True) * (1.0 - PIVOT_TIE_REL)
    pos = torch.arange(1, U.shape[0] + 1, device=U.device)[:, None]
    pivots = U[torch.argmax(tied.to(pos.dtype) * pos, dim=0), torch.arange(U.shape[1])]
    phase = torch.sign(pivots) + (pivots == 0).to(U.dtype)
    return U * phase[None, :], Vh * phase[:, None]


@pytest.mark.parametrize("direction", DIRS)
def test_ctm_move_frozen_matches_jax(train, direction):
    """One frozen directional move from the closed warm start against the JAX
    package's ``ctm_move_frozen`` (eager; the blocks go in as numpy arrays).
    The ket/bra symmetry ties the largest entries of some singular vectors;
    JAX's ``argmax`` then takes the pivot of the sign fixing by rounding, the
    port the first of the tied entries (``fix_svd_signs``).  With that rule
    in JAX's sign fixing, C and T match elementwise; with JAX's own, their
    magnitudes do (the gauge differs, ROADMAP Queue 3)."""
    from tpeps.sym import frozen as j_sym_frozen

    st, ctx, keeps = train[:3]
    jst = J_IPEPS_ABELIAN("U1", {c: jax_tensor(a) for c, a in st.sites.items()},
                          vertexToSite=bipartite, lX=2, lY=1)
    te = frozen.ctm_move_frozen(direction, st, ctx, keeps)
    with mock.patch.object(j_sym_frozen, "fix_svd_signs", jax_fix_svd_signs_first_tied):
        jr = j_frozen.ctm_move_frozen(direction, jst, jax_env(ctx), keeps)
    assert max(max_block_diff(jr.C[k], te.C[k]) for k in jr.C) <= 1e-10
    assert max(max_block_diff(jr.T[k], te.T[k]) for k in jr.T) <= 1e-10
    je = j_frozen.ctm_move_frozen(direction, jst, jax_env(ctx), keeps)
    assert max(max_block_diff(je.C[k], te.C[k], magnitude=True) for k in je.C) <= 1e-10
    assert max(max_block_diff(je.T[k], te.T[k], magnitude=True) for k in je.T) <= 1e-10


def test_close_structure_is_closed(train):
    """The warm start holds every block a frozen sweep makes: closing it again
    changes nothing, and the sweep's outputs keep its block sets."""
    st, ctx, keeps = train[:3]
    again = frozen.close_structure_generic(st, ctx, keeps)
    assert all(again.C[k].struct is ctx.C[k].struct for k in ctx.C)
    assert all(again.T[k].struct is ctx.T[k].struct for k in ctx.T)


def test_frozen_energy_matches_dynamic(train):
    """Four sweeps of ``converge_frozen_generic`` (conv_tol 0) and of the
    dynamic ``run`` from the same warm start: the energies.  The frozen
    profiles are the dynamic cut's here, so the two compute the same
    environment up to the gauge."""
    st, ctx = train[:2]
    model = J1J2_ABELIAN(j1=1.0, j2=J2, device=CPU)
    ef = frozen.converge_frozen_generic(st, ctx, max_iter=4, conv_tol=0.0)
    ed, _ = ctmrg.run(st, ctx, CtmArgs(ctm_max_iter=4, ctm_conv_tol=0.0))
    assert abs(float(model.energy_per_site(st, ef)) - float(model.energy_per_site(st, ed))) <= 1e-6


# ---------------------------------------------------------------------------
# K10's twins
# ---------------------------------------------------------------------------


def _outputs(rng, n_tensors=3):
    """Random JAX tensors of uneven block sets (rank 2 and 4)."""
    out = []
    for i in range(n_tensors):
        legs = (j_leg({-1: 2, 0: 3, 1: 1}),) * 2 if i % 2 == 0 else \
            (j_leg({-1: 2, 0: 1, 1: 2}), j_leg(AUX), j_leg(AUX), j_leg({-1: 1, 0: 2, 1: 2}))
        sig = (1, -1) if i % 2 == 0 else (1, -1, 1, -1)
        t = J_AbelianTensor("U1", sig, legs, 0)
        out.append(t.copy_with({q: rng.rand(*t.block_shape(q)) - 0.5
                                for q in sorted(t.all_allowed_blocks())}))
    return out


def _table(tensors, offsets):
    return kgen.segment_table([(o, port(t).struct.sizes) for t, o in zip(tensors, offsets)], CPU)


def _generic_epilogue_partition(raw, seg, env, grid, nt=64, keep=8):
    """A plain-torch model of how ``csrc/frozen_generic.cu``'s
    ``epilogue_kernel`` splits the work, in place on ``env``: the segments
    one index space, thread ``tid`` of ``grid`` x ``nt`` taking every
    stride-th element, its first ``keep`` kept across the barrier and the
    rest read again; per block and segment the max of |x| (order-free, as
    the kernel's atomic max on |x|'s bits: a NaN is the largest), the
    product with 1 / max.  It checks the index coverage of the split, not
    the kernel, which runs only on the card (chip_smoke.py's phase 10(a)
    holds it to the twin there).  Returns the times each raw element was
    written."""
    host = seg.host.tolist()
    beg = np.concatenate([[0], np.cumsum([r[2] for r in host])])
    n, stride = int(beg[-1]), grid * nt
    where = lambda e: int(np.searchsorted(beg, e, side="right") - 1)
    zero = torch.zeros((), dtype=raw.dtype)
    parts, kept = [], {}
    for b in range(grid):
        smax = [zero] * len(host)
        for t in range(nt):
            for r, e in enumerate(range(b * nt + t, n, stride)):
                q = where(e)
                x = raw[host[q][0] + e - int(beg[q])]
                if r < keep:
                    kept[e] = x
                smax[q] = torch.maximum(smax[q], x.abs())
        parts.append(smax)
    inv = []
    for q in range(len(host)):
        m = zero
        for p in parts:
            m = torch.maximum(m, p[q])
        inv.append(1.0 / m)
    hits = torch.zeros(n, dtype=torch.int64)
    for e in range(n):
        q = where(e)
        x = kept[e] if e in kept else raw[host[q][0] + e - int(beg[q])]
        env[host[q][1] + e - int(beg[q])] = x * inv[q]
        hits[e] += 1
    return hits


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("keep", [1, 8], ids=["past_keep", "all_kept"])
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_in_one_output"])
def test_generic_epilogue_partition_is_the_twin(dtype, keep, nan):
    """The kernel's partition on six outputs of odd lengths (81, 729, 5, 81,
    729, 13; blocks of several sizes) written to env slots in another order,
    3 blocks of 64 threads: every element written once, the env bit for bit
    the twin's; a NaN in one output makes that output NaN in both."""
    lens = ((81,), (700, 29), (5,), (40, 41), (729,), (13,))
    sizes = [sum(x) for x in lens]
    dst = np.cumsum([0] + sizes[::-1])[:-1][::-1]  # the slots in reverse order
    seg = kgen.segment_table([(int(d), list(b)) for d, b in zip(dst, lens)], CPU)
    raw = torch.from_numpy(np.random.RandomState(4).rand(seg.numel) - 0.5).to(dtype)
    if nan:
        raw[81 + 300] = float("nan")
    env_m, env_t = torch.zeros_like(raw), torch.zeros_like(raw)
    hits = _generic_epilogue_partition(raw, seg, env_m, grid=3, keep=keep)
    kgen.generic_epilogue_twin(raw, seg, env_t)
    assert bool((hits == 1).all())
    assert torch.equal(env_m.isnan(), env_t.isnan())
    assert torch.equal(env_m.nan_to_num(7.0), env_t.nan_to_num(7.0))
    assert int(env_t.isnan().sum()) == (729 if nan else 0)


def test_generic_epilogue_and_sweep_commit_twins_match_jax():
    """``generic_epilogue``'s twin against the JAX package's ``_normalized``
    per output (written into its env slot), bit-exact; ``sweep_commit``'s twin
    against ``_env_dist2`` of the two envs (1e-12 relative), the commit and
    the loop test."""
    rng = np.random.RandomState(3)
    outs = _outputs(rng)
    sizes = [port(t).struct.numel for t in outs]
    offsets = list(np.cumsum([5] + [s + 7 for s in sizes[:-1]]))  # slots with gaps between
    env0 = torch.as_tensor(rng.rand(int(offsets[-1]) + sizes[-1] + 3) - 0.5)
    W = env0.clone()
    raw = torch.cat([port(t).data for t in outs])
    kgen.generic_epilogue_twin(raw, _table(outs, offsets), W)
    ref = env0.clone()
    for t, o, n in zip(outs, offsets, sizes):
        ref[o:o + n] = port(j_frozen._normalized(t.to_backend("jnp"), True)).data
    assert torch.equal(W, ref)
    st = kgen.sweep_state(env0, 2, 1e-3)
    kgen.sweep_commit_twin(st, W)
    j_d2 = float(j_frozen._env_dist2([jnp.asarray(W.numpy())], [jnp.asarray(env0.numpy())]))
    assert abs(float(st.dist2) - j_d2) <= 1e-12 * j_d2
    assert torch.equal(st.S, W) and st.ctl[:2].tolist() == [1, 0]
    kgen.sweep_commit_twin(st, W)  # distance 0: the loop ends, at i = 2 = max_iter
    assert st.ctl[:2].tolist() == [2, 1] and float(st.dist2) == 0.0
    kgen.sweep_commit_twin(st, env0)  # done: nothing happens
    assert st.ctl[:2].tolist() == [2, 1] and torch.equal(st.S, W)


@pytest.mark.parametrize("sg_norm", [True, False], ids=["scale_detached", "scale_differentiated"])
def test_generic_epilogue_vjp_twin_matches_jax(sg_norm):
    """The epilogue's backward against ``jax.vjp`` of the JAX package's
    ``_normalized(t, sg_norm)`` per output, the cotangent read from the env
    slots; one output has three tied maxima in uneven blocks (two in one
    block, one in another: JAX's weights 1/4, 1/4, 1/2)."""
    rng = np.random.RandomState(4)
    outs = _outputs(rng)
    blocks = {q: np.asarray(b) for q, b in outs[0].blocks.items()}
    ka, kb = sorted(k for k, b in blocks.items() if b.size >= 2)[:2]
    blocks[ka].flat[0] = blocks[ka].flat[1] = blocks[kb].flat[0] = 3.0
    outs[0] = outs[0].copy_with(blocks)
    sizes = [port(t).struct.numel for t in outs]
    offsets = list(np.cumsum([2] + sizes[:-1]))
    gW = torch.as_tensor(rng.rand(int(offsets[-1]) + sizes[-1]) - 0.5)
    raw = torch.cat([port(t).data for t in outs])
    seg = _table(outs, offsets)
    got = kgen.generic_epilogue_vjp_twin(raw, gW, seg, sg_norm)
    for t, o, n, (so, *_) in zip(outs, offsets, sizes, seg.host.tolist()):
        tj = t.to_backend("jnp")
        ct = gW[o:o + n].clone()
        cj = tj.copy_with({q: jnp.asarray(b.numpy()) for q, b in
                           type(port(t))._flat(port(t), port(t).struct, ct).blocks.items()})
        (ref,) = jax.vjp(lambda x: j_frozen._normalized(x, sg_norm), tj)[1](cj)
        ref = port(ref).data
        assert float((got[so:so + n] - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def _generic_vjp_partition(raw, g, seg, sg_norm, grid, nt=64, keep=8):
    """A model, in numpy scalars of the inputs' dtype, of how
    ``csrc/frozen_generic.cu``'s ``vjp_kernel`` splits the work: the
    segments one index space, thread ``tid`` of ``grid`` x ``nt`` taking
    every stride-th element, its first ``keep`` values and cotangents kept
    across the barriers and the rest read again; the tie counts (scratch as
    ``torch.empty`` leaves it) zeroed by the threads' grid-stride shares of
    each segment's blocks; per segment the max (order-free, a NaN the
    largest, as the kernel's max of |x|'s bits); the dot g.x per warp of 32
    lanes and step, a segmented scan over the warp's 32 consecutive elements
    leaving each run of one segment's sum in its last lane, added into a
    slot a warp and segment in step order, the warps' slots in order
    into a partial a block and segment, and after the first barrier the
    partials of a segment summed by the block (thread t the partials t, t +
    nt, ... in order, then a butterfly and the warps in order); the ties
    counted per layout block (a
    block's first tie adds the block to its segment's tied-block count) and
    every element off the maximum written; after the second barrier (the
    scale differentiated) the tied ones; the last block done reading zeroes
    the words.  It checks the index coverage and the orders of the split,
    not the kernel, which runs only on the card (chip_smoke.py's
    ``generic_vjp_checks``).  Returns ``(xbar, hits, words)``."""
    dt = raw.numpy().dtype.type
    zero, one = dt(0), dt(1)
    x_all, g_all, blk = raw.numpy(), g.numpy(), seg.blk.numpy()
    host = seg.host.tolist()
    beg = np.concatenate([[0], np.cumsum([r[2] for r in host])])
    n, stride, diff, nq = int(beg[-1]), grid * nt, not sg_norm, len(host)
    where = lambda e: int(np.searchsorted(beg, e, side="right") - 1)
    cnt = np.full(max(seg.nblk, 1), -7, dtype=np.int64)  # torch.empty's garbage
    words = {"max": [zero] * nq, "ntb": [0] * nq, "read": 0}

    def load(e):
        q = where(e)
        off = e - int(beg[q])
        return q, off, x_all[host[q][0] + off], g_all[host[q][1] + off]

    if diff:
        for tid in range(grid * nt):
            for q in range(nq):
                for b in range(host[q][3] + tid, host[q][4], stride):
                    cnt[b] = 0
    kept, parts = {}, []
    for b in range(grid):  # (a)
        slot = np.zeros((nq, nt // 32), dtype=dt)
        for t in range(nt):
            for r, e in enumerate(range(b * nt + t, n, stride)):
                q, off, x, gv = load(e)
                if r < keep:
                    kept[e] = (q, off, x, gv)
                words["max"][q] = np.maximum(words["max"][q], abs(x))
        for w in range(nt // 32):
            e0 = b * nt + 32 * w
            for r in range(0, (n - e0 + stride - 1) // stride if e0 < n else 0):
                lanes = [load(e) if e < n else (-1, 0, zero, zero)
                         for e in range(e0 + r * stride, e0 + r * stride + 32)]
                q = [x[0] for x in lanes]
                d = [x[3] * x[2] for x in lanes]
                for o in (1, 2, 4, 8, 16):  # the segmented Hillis-Steele scan
                    d = [d[i] + d[i - o] if i >= o and q[i - o] == q[i] else d[i]
                         for i in range(32)]
                for i in range(32):  # each run's last lane
                    if q[i] >= 0 and (i == 31 or q[i + 1] != q[i]):
                        slot[q[i], w] = slot[q[i], w] + d[i]
        parts.append([functools.reduce(np.add, slot[q, 1:], slot[q, 0]) for q in range(nq)])
    m = words["max"]  # (b): every block the same maxima and dot sums
    inv = [one / x for x in m]
    coef = []
    for q in range(nq):
        threads = [zero] * nt
        for b in range(grid):
            threads[b % nt] = threads[b % nt] + parts[b][q]
        coef.append(_block_reduce(threads, np.add) * inv[q] * inv[q])
    tied = set()
    if diff:
        for e in range(n):
            q, off, x, _ = kept[e] if e in kept else load(e)
            if abs(x) == m[q]:
                tied.add(e)
                k = blk[host[q][0] + off]
                cnt[k] += 1
                if cnt[k] == 1:
                    words["ntb"][q] += 1
    out, hits = np.empty_like(x_all), np.zeros(n, dtype=np.int64)

    def store(e, w):
        q, off, x, gv = kept[e] if e in kept else load(e)
        s = dt(np.sign(x))
        out[host[q][0] + off] = gv * inv[q] - coef[q] * w * s if diff else gv * inv[q]
        hits[e] += 1

    for e in range(n):  # (b): off the maximum
        if e not in tied:
            store(e, zero)
    for e in sorted(tied):  # (c), after the second barrier
        q, off, _, _ = kept[e] if e in kept else load(e)
        store(e, one / (dt(words["ntb"][q]) * dt(cnt[blk[host[q][0] + off]])))
    words.update(max=[zero] * nq, ntb=[0] * nq, read=0)  # the last block's zeroing
    return torch.from_numpy(out), hits, words


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("keep", [1, 8], ids=["past_keep", "all_kept"])
@pytest.mark.parametrize("case", ["random", "ties", "all_equal", "nan"])
def test_generic_vjp_partition_is_the_twin(dtype, keep, case):
    """The one-launch ``generic_epilogue_vjp``'s partition on six outputs of
    odd lengths in uneven blocks (81; 700 + 29; one element; 40 + 41; 729;
    13), written from env slots in another order, 3 blocks of 64 threads
    (two warps; the outputs' boundaries fall inside warps): with 1 value kept
    a thread most are read again, with 8 nearly all are kept.  ``ties``:
    output 1's maximum tied twice in its first block (+) and once in its
    second (-); ``all_equal``: output 3 all equal (every entry tied);
    ``nan``: a NaN in output 4 (that output's cotangent all NaN).  Both scale
    modes: every element written once, detached bit-identical to the twin,
    differentiated within 1e-12 (f64) or 1e-5 (f32) relative (the dot's
    order), NaN where the twin's; the words left zero."""
    lens = ((81,), (700, 29), (1,), (40, 41), (729,), (13,))
    sizes = [sum(x) for x in lens]
    dst = np.cumsum([0] + sizes[::-1])[:-1][::-1]  # the slots in reverse order
    seg = kgen.segment_table([(int(d), list(b)) for d, b in zip(dst, lens)], CPU)
    rng = np.random.RandomState(14)
    raw = torch.from_numpy(rng.rand(seg.numel) - 0.5).to(dtype)
    g = torch.from_numpy(rng.rand(seg.numel) - 0.5).to(dtype)
    if case == "ties":
        raw[81 + 3] = raw[81 + 650] = 2.0
        raw[81 + 710] = -2.0
    elif case == "all_equal":
        raw[811:892] = 0.25
    elif case == "nan":
        raw[892 + 300] = float("nan")
    for sg in (False, True):
        got, hits, words = _generic_vjp_partition(raw, g, seg, sg, grid=3, keep=keep)
        want = kgen.generic_epilogue_vjp(raw, g, seg, sg)  # CPU tensors: the twin
        assert bool((hits == 1).all())
        assert all(not any(v) for v in (words["max"], words["ntb"])) and words["read"] == 0
        assert torch.equal(got.isnan(), want.isnan())
        assert int(want.isnan().sum()) == (729 if case == "nan" else 0)
        got, want = got.nan_to_num(0.0), want.nan_to_num(0.0)
        if sg:
            assert torch.equal(got, want)
        else:
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("sg_norm", [True, False], ids=["scale_detached", "scale_differentiated"])
def test_vjp_twins_give_nan_as_jax(sg_norm):
    """A NaN in a tiny tensor: ``jax.vjp`` of the JAX package's
    ``_normalized(t, sg_norm)`` gives NaN for every entry of its cotangent,
    and so do the two epilogue VJPs' twins (K10's on the tensor as one
    output, K9's shared scale backward; K9's whole twin on the tensor as C'
    beside a finite T', whose cotangent stays finite)."""
    rng = np.random.RandomState(6)
    t = _outputs(rng, 1)[0]
    blocks = {q: np.asarray(b).copy() for q, b in t.blocks.items()}
    blocks[sorted(blocks)[1]].flat[0] = np.nan
    t = t.copy_with({q: jnp.asarray(b) for q, b in blocks.items()})
    ct = t.copy_with({q: jnp.asarray(rng.rand(*np.shape(b)) - 0.5) for q, b in blocks.items()})
    (ref,) = jax.vjp(lambda x: j_frozen._normalized(x, sg_norm), t)[1](ct)
    assert all(np.isnan(np.asarray(b)).all() for b in ref.blocks.values())
    tt, gt = port(t), port(ct)
    seg = _table([t], [0])
    assert bool(kgen.generic_epilogue_vjp_twin(tt.data, gt.data, seg, sg_norm).isnan().all())
    nb = len(tt.struct.keys)
    assert bool(kfrozen.scale_vjp_twin(tt.data, gt.data, seg.blk, nb, sg_norm).isnan().all())
    none = torch.full_like(seg.blk, -1, dtype=torch.int64)
    fT = torch.from_numpy(rng.rand(7) - 0.5)
    xC, xT = kfrozen.frozen_epilogue_vjp_twin(tt.data, fT, none, torch.full((7,), -1), gt.data,
                                              fT, seg.blk, torch.zeros(7, dtype=torch.int32),
                                              nb, 1, sg_norm)
    assert bool(xC.isnan().all()) and not bool(xT.isnan().any())


def test_adjoint_commit_on_generic_buffers(capfd):
    """``adjoint_commit``'s twin driven by the generic buffers (da over both
    sites' blocks, u split into the C and the T part of the flat env) against
    the JAX package's generic adjoint ``while_loop`` (its factory with a
    linear stand-in sweep, ``sweep(s, C, T) = (l C + s, l T + s)``), the
    accumulated cotangent 1e-15 and the iteration count."""
    lam, na = 0.5, 3
    s0 = {(0, 0): jnp.asarray([0.3, -0.2, 0.1])}
    C0 = {"c": jnp.asarray([1.0, 0.5, -0.25])}
    T0 = {"t": jnp.asarray([0.5, -1.0, 0.75])}

    def sweep(state, env, keeps, move_seq, lX, lY, reg, sg):
        s = state.sites[(0, 0)]
        return j_env.ENV_ABELIAN(env.chi, {k: lam * x + s for k, x in env.C.items()},
                                 {k: lam * x + s for k, x in env.T.items()})

    class _St:  # the geometry the factory reads
        sym, lX, lY = "U1", 1, 1

        @staticmethod
        def vertexToSite(c):
            return (0, 0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_frozen, "_sweep", sweep)
        mp.setattr(j_frozen, "IPEPS_ABELIAN", lambda sym, sites, **kw: type(
            "S", (), {"sites": sites})())
        conv = j_frozen.make_converge_frozen_generic(_St, 4, (), DIRS, 0, 0.0, 1e-12, 100, 1e-8)
        cot = ({"c": jnp.asarray([1.0, 0.5, -0.25])}, {"t": jnp.asarray([0.5, -1.0, 0.75])})
        _, vjp = jax.vjp(conv, s0, C0, T0)
        da_j = np.asarray(vjp(cot)[0][(0, 0)])
    uC, uT = (torch.tensor(np.asarray(c[k])) for c, k in zip(cot, ("c", "t")))
    st = kfrozen.adjoint_state(torch.zeros(na, dtype=torch.float64), uC, uT, 100, 1e-8)
    n = 0
    while not bool(st.ctl[1]):
        da_i = uC + uT
        uC, uT = lam * uC, lam * uT
        kfrozen.adjoint_commit_twin(st, da_i, uC, uT)
        n += 1
    assert np.abs(st.da.numpy() - da_j).max() <= 1e-15 * np.abs(da_j).max()
    assert int(st.ctl[0]) == n == 27 and not bool(st.ctl[5])


# ---------------------------------------------------------------------------
# JSON, convert, entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_json_two_sites_round_trip_bit_identical(tmp_path, states, direction):
    jst, tst = states
    path = str(tmp_path / "state.json")
    if direction == "port_reads_jax":
        j_io.write_ipeps_abelian(jst, path)
        back = t_io.read_ipeps_abelian(path, vertexToSite=bipartite)
        pairs = [(jst.sites[c], back.sites[c]) for c in jst.sites]
    else:
        t_io.write_ipeps_abelian(tst, path)
        back = j_io.read_ipeps_abelian(path, vertexToSite=bipartite)
        pairs = [(back.sites[c], tst.sites[c]) for c in tst.sites]
    assert (back.lX, back.lY) == (2, 1) and back.vertexToSite((1, 1)) == (0, 0)
    assert all(max_block_diff(j, t) == 0.0 for j, t in pairs)
    other = str(tmp_path / "other.json")
    t_io.write_ipeps_abelian(t_io.read_ipeps_abelian(path), other)
    j_io.write_ipeps_abelian(j_io.read_ipeps_abelian(path), path)
    assert open(other).read() == open(path).read()
    assert len(json.load(open(path))["sites"]) == 2


def test_convert_generic_env_and_state(states):
    """JAX's generic init env and 2-site state carried into the port as block
    specs equal the port's own; back to specs exactly."""
    jst, tst = states
    je = j_env.init_env(jst, CHI)

    def spec(t):
        return (t.sym, t.signature, [l.charges for l in t.legs], [l.pshift for l in t.legs], t.n,
                t.fermionic, {q: np.asarray(b) for q, b in t.blocks.items()})

    te = env_abelian_to_torch(CHI, {k: spec(t) for k, t in je.C.items()},
                              {k: spec(t) for k, t in je.T.items()}, device=CPU)
    own = g_env.init_env(tst, CHI)
    for grp in ("C", "T"):
        for k, t in getattr(te, grp).items():
            assert t.struct is getattr(own, grp)[k].struct
            assert float((t.data - getattr(own, grp)[k].data).abs().max()) <= 1e-15
    chi, C, T = env_abelian_to_numpy(te)
    assert chi == CHI and all(np.array_equal(C[k][6][q], np.asarray(b))
                              for k, t in je.C.items() for q, b in t.blocks.items())
    st = ipeps_abelian_to_torch("U1", {c: spec(a) for c, a in jst.sites.items()}, bipartite, 2,
                                1, device=CPU)
    sym, sites, v2s, lX, lY = ipeps_abelian_to_numpy(st)
    assert (sym, lX, lY, v2s((1, 1))) == ("U1", 2, 1, (0, 0))
    assert all(np.array_equal(sites[c][6][q], np.asarray(b))
               for c, a in jst.sites.items() for q, b in a.blocks.items())


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "examples" / "j1j2" / "abelian" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch.object(sys, "argv", [f"{name}.py"]):
        spec.loader.exec_module(module)
    return module


def test_ctmrg_entry_point_matches_jax(tmp_path, states):
    from tpeps_torch.examples.j1j2.abelian.ctmrg_j1j2_u1 import main

    jst, _ = states
    path = str(tmp_path / "state.json")
    j_io.write_ipeps_abelian(jst, path)
    jmod = _jax_example("ctmrg_j1j2_u1")
    for k, v in dict(instate=path, chi=CHI, j2=J2, tiling="BIPARTITE", CTMARGS_ctm_max_iter=1,
                     CTMARGS_ctm_conv_tol=0.0).items():
        setattr(jmod.args, k, v)
    e_j, obs_j, labels_j = jmod.main()
    stats = []
    e_t, obs_t, labels_t = main(["--instate", path, "--chi", str(CHI), "--j2", str(J2),
                                 "--tiling", "BIPARTITE", "--CTMARGS_ctm_max_iter", "1",
                                 "--CTMARGS_ctm_conv_tol", "0", "--GLOBALARGS_device", "cpu"],
                                stats=stats)
    assert len(stats) == 1 and abs(e_t - e_j) <= 1e-10, (e_t, e_j)
    assert labels_t == labels_j
    for l, x, y in zip(labels_j, obs_j, obs_t):
        assert abs(complex(x) - complex(y)) <= 1e-10, l
