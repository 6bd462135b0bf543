"""K8's launch schedules (``tpeps_torch/kernels/blocksparse.py``) on the CPU.

The CUDA kernels run only on the card; what decides their results on the
host is checked here.

* Table invariants, on the tensordots of one D=3 U(1) C4v move and on
  synthetic tables shaped like the D=8 classes (skinny products with n, k
  <= 4, dB-like reductions of 100+ pairs into 4 x 4 blocks, blocks of 20+
  pairs with few tiles): every output element written exactly once (by a
  tile, or by the last tile of its group), every pair of an output block in
  exactly one split (a SPLIT block: every k chunk of a pair in exactly one
  piece), the splits in pair order; every permute table's boxes
  give the table's element index bit for bit, and a model of the kernel's
  two passes (its index tables and carry steps) copies each element once.
* Parity: :func:`gemm_model`, a plain-torch model of the kernel's schedule
  (tiles, then partials into slots, then each group's slots summed in
  order; the DMMA class's slabs built by the kernel's (pair, k) cursors),
  against ``block_gemm_twin`` and, through the port's tensordot and its
  backward, against the JAX package's ``AbelianTensor.tensordot`` and
  ``jax.vjp`` on the same numpy blocks, 1e-12 relative (sums in another
  order).
"""

from unittest import mock

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from test_torch_abelian import c4v_state
from test_torch_sym import jrandom, port
from tpeps.sym import tensor as j_tensor
from tpeps_torch.ctm.c4v_abelian import ctmrg
from tpeps_torch.ctm.c4v_abelian import env as c4v_env
from tpeps_torch.ipeps.ipeps_abelian import IPEPS_ABELIAN
from tpeps_torch.kernels import blocksparse as bs
from tpeps_torch.sym import tensor as t_tensor
from tpeps_torch.sym.tensor import AbelianTensor
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PK = dict(svd_reltol=1e-12, eps_multiplet=1e-12)
PTHREADS = 256  # csrc/block_sparse.cu PNT


# ---------------------------------------------------------------------------
# the plain-torch model of block_gemm's schedule
# ---------------------------------------------------------------------------


def _operand(buf, off, rows, cols, k_major):
    """A block of ``buf`` as a (rows x cols) matrix; ``k_major``: stored
    transposed (cols x rows)."""
    x = buf[off:off + rows * cols]
    return x.view(cols, rows).T if k_major else x.view(rows, cols)


def _pair(a, b, t, p, m, n):
    k = int(t.pr_k[p])
    A = _operand(a, int(t.pr_a[p]), m, k, t.trans_a)
    B = _operand(b, int(t.pr_b[p]), k, n, t.trans_b)
    return float(t.pr_s[p]) * A, B


def _slabs(a, b, t, o, p0, p1, r0, c0):
    """The DMMA tile's operands as the kernel stages them: the pairs'
    concatenated k walked in 16-deep slabs, every slab column (row) found by
    a cursor (pair, k) that advances 16 a slab; the sign beside each column."""
    m, n = int(t.ob_m[o]), int(t.ob_n[o])
    ktot = int(t.pr_k[p0:p1].sum())
    nslab = -(-ktot // 16)
    A = torch.zeros(64, 16 * nslab, dtype=a.dtype)
    B = torch.zeros(16 * nslab, 64, dtype=a.dtype)
    rows = torch.arange(r0, min(r0 + 64, m))
    cols = torch.arange(c0, min(c0 + 64, n))
    for c in range(16):
        p, kl = p0, c
        for s in range(nslab):
            while p < p1 and kl >= int(t.pr_k[p]):
                kl -= int(t.pr_k[p])
                p += 1
            if p < p1:
                Ap, Bp = _pair(a, b, t, p, m, n)
                A[:len(rows), 16 * s + c] = Ap[rows, kl]
                B[16 * s + c, :len(cols)] = Bp[kl, cols]
            kl += 16
    return A, B


def gemm_model(a, b, out, t: bs.GemmTable):
    """What the kernel computes from ``t``'s tiles: each tile's result or
    partial, then each group's partials summed in slot order by its last
    tile.  Returns ``out`` and the count of writes of every element."""
    writes = torch.zeros(out.numel(), dtype=torch.int64)
    slots, region = {}, {}

    def put(o, rows, cols, val):
        n = int(t.ob_n[o])
        idx = int(t.ob_off[o]) + rows[:, None] * n + cols[None, :]
        out[idx.reshape(-1)] = val.reshape(-1)
        writes[idx.reshape(-1)] += 1

    for o, cls, r0, c0, p0, p1, slot, grp in t.tiles.tolist():
        m, n = int(t.ob_m[o]), int(t.ob_n[o])
        q0, q1 = int(t.ob_ptr[o]), int(t.ob_ptr[o + 1])
        full = lambda: sum((torch.matmul(*_pair(a, b, t, p, m, n)) for p in range(q0, q1)),
                           torch.zeros(m, n, dtype=a.dtype))  # noqa: E731
        if cls == bs.SMALL:
            e = torch.arange(r0, min(r0 + bs.SMALL_TILE, m * n))
            idx = int(t.ob_off[o]) + e
            out[idx] = full().reshape(-1)[e]
            writes[idx] += 1
            continue
        if cls == bs.ROWS:
            rows = torch.arange(r0, min(r0 + bs.SKINNY_TILE, m))
            put(o, rows, torch.arange(n), full()[rows])
            continue
        if cls == bs.COLS:
            cols = torch.arange(r0, min(r0 + bs.SKINNY_TILE, n))
            put(o, torch.arange(m), cols, full()[:, cols])
            continue
        if cls == bs.DMMA:
            rows = torch.arange(r0, min(r0 + 64, m))
            cols = torch.arange(c0, min(c0 + 64, n))
            A, B = _slabs(a, b, t, o, p0, p1, r0, c0)
            val = (A @ B)[:len(rows), :len(cols)]
        else:  # SPLIT
            rows, cols = torch.arange(m), torch.arange(n)
            val = torch.zeros(m, n, dtype=a.dtype)
            for p, k0, k1 in t.units[p0:p1].tolist():
                Ap, Bp = _pair(a, b, t, p, m, n)
                val = val + Ap[:, k0:k1] @ Bp[k0:k1]
        if slot < 0:
            put(o, rows, cols, val)
        else:
            slots.setdefault(grp, {})[slot] = val
            region[grp] = (o, rows, cols)
    for grp, parts in slots.items():
        assert sorted(parts) == list(range(int(t.grp_n[grp])))
        put(*region[grp], sum(parts[z] for z in range(len(parts))))
    return out, writes


def check_schedule(t: bs.GemmTable):
    """Every output element written once, nothing outside the output blocks;
    every pair of a block in exactly one split, the splits in pair order; a
    group's slots 0..n-1 in one region."""
    numel = int((t.ob_off + t.ob_m.astype(np.int64) * t.ob_n).max(initial=0))
    o_of_p = np.repeat(np.arange(t.nout), np.diff(t.ob_ptr))
    k = t.pr_k.astype(np.int64)
    na = int((t.pr_a + t.ob_m[o_of_p] * k).max(initial=0))
    nb = int((t.pr_b + t.ob_n[o_of_p] * k).max(initial=0))
    _, writes = gemm_model(torch.zeros(na, dtype=torch.float64),
                           torch.zeros(nb, dtype=torch.float64),
                           torch.zeros(numel, dtype=torch.float64), t)
    inside = torch.zeros(numel, dtype=torch.bool)
    for o in range(t.nout):
        inside[int(t.ob_off[o]):int(t.ob_off[o]) + int(t.ob_m[o]) * int(t.ob_n[o])] = True
    assert torch.equal(writes[inside], torch.ones_like(writes[inside]))
    assert int(writes[~inside].sum()) == 0
    tl = t.tiles
    for cls in (bs.DMMA, bs.SPLIT):
        sel = tl[tl[:, 1] == cls]
        by_region = {}
        for o, _, r0, c0, p0, p1, slot, grp in sel.tolist():
            by_region.setdefault((o, r0, c0), []).append((slot, p0, p1, grp))
        for (o, _, _), pieces in by_region.items():
            pieces.sort()
            assert [s for s, *_ in pieces] == ([-1] if len(pieces) == 1 else
                                               list(range(len(pieces))))
            assert len({g for *_, g in pieces}) == 1
            q0, q1 = int(t.ob_ptr[o]), int(t.ob_ptr[o + 1])
            if cls == bs.DMMA:
                bounds = [q0] + [p1 for _, _, p1, _ in pieces]
                assert [p0 for _, p0, _, _ in pieces] == bounds[:-1] and bounds[-1] == q1
            else:
                u = np.concatenate([t.units[p0:p1] for _, p0, p1, _ in pieces])
                for p in range(q0, q1):
                    mine = u[u[:, 0] == p]
                    assert mine[0, 1] == 0 and mine[-1, 2] == t.pr_k[p]
                    assert (mine[1:, 1] == mine[:-1, 2]).all() and (mine[:, 2] > mine[:, 1]).all()
                assert set(u[:, 0]) == set(range(q0, q1))
                for _, p0, p1, _ in pieces:  # a piece: one k chunk of pairs in pair order
                    assert (np.diff(t.units[p0:p1, 0]) > 0).all()
                    assert len(set(t.units[p0:p1, 1] // bs.SPLIT_DEPTH)) == 1
    for cls in (bs.SMALL, bs.ROWS, bs.COLS):
        sel = tl[tl[:, 1] == cls]
        assert (sel[:, 6] == -1).all()


def gemm_parity(t, a, b, numel):
    """The model, the twin and a dense per-pair reference on the same
    buffers; the model's and twin's relative errors to the reference."""
    got, _ = gemm_model(a, b, torch.full((numel,), 7.0, dtype=torch.float64), t)
    twin = bs.block_gemm_twin(a, b, torch.full((numel,), 7.0, dtype=torch.float64), t)
    ref = torch.full((numel,), 7.0, dtype=torch.float64)
    for o in range(t.nout):
        m, n = int(t.ob_m[o]), int(t.ob_n[o])
        acc = torch.zeros(m, n, dtype=torch.float64)
        for p in range(int(t.ob_ptr[o]), int(t.ob_ptr[o + 1])):
            A, B = _pair(a, b, t, p, m, n)
            acc += A @ B
        ref[int(t.ob_off[o]):int(t.ob_off[o]) + m * n] = acc.reshape(-1)
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / scale, float((twin - got).abs().max()) / scale


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _d3_dots():
    """The tensordots of one dynamic D=3 U(1) C4v move at chi=9 (CPU twins)."""
    a = port(c4v_state()).to(CPU)
    st = IPEPS_ABELIAN("U1", {(0, 0): a})
    env = c4v_env.init_env(st, 9)
    for _ in range(2):
        env = ctmrg.ctm_move_sl(a, env, PK)
    calls, orig = [], AbelianTensor.tensordot

    def rec(self, other, axes, out_like=None):
        calls.append((self, other, axes, out_like))
        return orig(self, other, axes, out_like)

    with mock.patch.object(AbelianTensor, "tensordot", rec):
        ctmrg.ctm_move_sl(a, env, PK)
    return calls


_D3 = {}


def d3_dots():
    if not _D3:
        _D3["calls"] = _d3_dots()
    return _D3["calls"]


def synthetic(name):
    """A table shaped like one of the D=8 classes, on random block offsets:
    ``(table, size of a, size of b, size of out)``."""
    rng = np.random.RandomState(len(name))

    def build(m, n, ks, trans_a=False, trans_b=False, signs=True):
        ptr = np.concatenate([[0], np.cumsum([len(x) for x in ks])])
        k = np.concatenate(ks)
        o_of_p = np.repeat(np.arange(len(m)), np.diff(ptr))
        sa = m[o_of_p] * k
        sb = k * n[o_of_p]
        pa = np.cumsum(sa) - sa
        pb = np.cumsum(sb) - sb
        # some pairs share an operand block, as in a tensordot
        share = rng.rand(len(k)) < 0.2
        share[0] = False
        prev = np.maximum(np.arange(len(k)) - 1, 0)
        same = share & (sb == sb[prev]) & (k == k[prev])
        pb = np.where(same, pb[prev], pb)
        out = m * n
        off = np.cumsum(out) - out
        sg = np.where(rng.rand(len(k)) < 0.3, -1, 1) if signs else np.ones(len(k), int)
        t = bs.GemmTable(off, m, n, ptr, pa, pb, k, sg, trans_a, trans_b)
        return t, int(sa.sum()), int(sb.sum()), int(out.sum())

    if name == "skinny_rows":  # env x site: n, k <= 4, m up to ~600, 3-8 pairs
        nb = 12
        m = rng.randint(36, 600, nb)
        n = rng.randint(1, 5, nb)
        return build(m, n, [rng.randint(1, 5, rng.randint(3, 9)) for _ in range(nb)])
    if name == "skinny_dA":  # their dA tables: B read transposed
        nb = 10
        m = rng.randint(36, 600, nb)
        n = rng.randint(1, 5, nb)
        return build(m, n, [rng.randint(1, 5, rng.randint(3, 9)) for _ in range(nb)],
                     trans_b=True)
    if name == "skinny_cols":  # m <= 4, n long, A read transposed
        nb = 6
        m = rng.randint(1, 5, nb)
        n = rng.randint(20, 400, nb)
        return build(m, n, [rng.randint(1, 5, rng.randint(3, 9)) for _ in range(nb)],
                     trans_a=True)
    if name == "split_dB":  # dB: 4 x 4 blocks, 100+ pairs each reducing over m <= 600
        nb = 3
        m = rng.randint(1, 5, nb)
        n = rng.randint(1, 5, nb)
        return build(m, n, [rng.randint(36, 600, rng.randint(100, 130)) for _ in range(nb)],
                     trans_a=True)
    if name == "dmma_few_tiles":  # 20+ pairs into blocks of few tiles (tensordot 6)
        nb = 3
        m = rng.randint(16, 90, nb)
        n = rng.randint(16, 90, nb)
        return build(m, n, [rng.randint(2, 40, rng.randint(20, 26)) for _ in range(nb)])
    if name == "dmma_transposed":  # chi-leg tables read transposed, k 2-40
        nb = 4
        m = rng.randint(16, 140, nb)
        n = rng.randint(5, 140, nb)
        return build(m, n, [rng.randint(2, 40, rng.randint(2, 9)) for _ in range(nb)],
                     trans_a=True, trans_b=True)
    raise KeyError(name)


SYNTHETIC = ("skinny_rows", "skinny_dA", "skinny_cols", "split_dB", "dmma_few_tiles",
             "dmma_transposed")
D3_DOTS = range(10)


def _classes(t):
    return {bs.CLASS_NAMES[c] for c in np.unique(t.ob_kind)}


def test_synthetic_tables_take_their_classes():
    want = {"skinny_rows": {"rows"}, "skinny_dA": {"rows"}, "skinny_cols": {"cols"},
            "split_dB": {"split"}, "dmma_few_tiles": {"dmma"}}
    for name, cls in want.items():
        t = synthetic(name)[0]
        assert _classes(t) == cls, name
    t = synthetic("split_dB")[0]
    assert (t.tiles[:, 6] >= 0).all() and len(t.grp_n) == t.nout  # every block split
    t = synthetic("dmma_few_tiles")[0]
    assert (t.grp_n > 1).all() and len(t.grp_n) == (np.ceil(t.ob_m / 64)
                                                    * np.ceil(t.ob_n / 64)).sum()


@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_schedule_invariants(name):
    check_schedule(synthetic(name)[0])


@pytest.mark.parametrize("name", SYNTHETIC)
def test_synthetic_model_matches_twin(name):
    t, na, nb_, nout = synthetic(name)
    rng = np.random.RandomState(7)
    a = torch.as_tensor(rng.rand(na) - 0.5)
    b = torch.as_tensor(rng.rand(nb_) - 0.5)
    e_ref, e_twin = gemm_parity(t, a, b, nout)
    assert e_ref < 1e-12 and e_twin < 1e-12


@pytest.mark.parametrize("i", D3_DOTS)
def test_d3_move_schedules(i):
    """The forward table and both grad tables of each tensordot of a D=3
    move: invariants, and the model against the twin."""
    x, y, axes, out_like = d3_dots()[i]
    plan, A, B = x.dot_operands(y, axes, out_like)
    ta, tb = plan.gemm.grad_tables()
    G = torch.as_tensor(np.random.RandomState(i).rand(plan.out.numel) - 0.5)
    for t, lhs, rhs, n in ((plan.gemm, A, B, plan.out.numel), (ta, G, B, A.numel()),
                           (tb, A, G, B.numel())):
        check_schedule(t)
        e_ref, e_twin = gemm_parity(t, lhs, rhs, n)
        assert e_ref < 1e-12 and e_twin < 1e-12


# ---------------------------------------------------------------------------
# parity with the JAX package through the port's tensordot and its backward
# ---------------------------------------------------------------------------


def _model_gemm(a, b, out, table):
    return gemm_model(a, b, out, table)[0]


BIG = {-1: 20, 0: 24, 1: 18}
NARROW = {-1: 1, 0: 2, 1: 1}
LONG = {-1: 300, 0: 340, 1: 280}
SHORT = {-1: 2, 0: 3, 1: 2}
MID = {-1: 40, 0: 60, 1: 45}
# (signature a, dims a, signature b, dims b, axes, fermionic, pshifts) per class
JAX_CASES = {
    "dmma": ((1, -1, 1), (BIG, NARROW, BIG), (1, -1, -1), (NARROW, BIG, BIG), ((1, 2), (0, 1)),
             False, None),
    "rows": ((1, -1, 1), (MID, SHORT, NARROW), (1, -1, 1), (SHORT, NARROW, NARROW),
             ((1, 2), (0, 1)), False, None),
    "split": ((1, 1), (LONG, NARROW), (-1, 1), (LONG, NARROW), ((0,), (0,)), False, None),
    "rows_fermionic": ((1, -1, 1, -1), (MID, SHORT, NARROW, NARROW), (1, 1, 1),
                       (SHORT, NARROW, NARROW), ((1, 3), (0, 1)), True, None),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_model_tensordot_and_vjp_match_jax(name):
    """The port's tensordot and its backward with ``block_gemm`` replaced by
    the schedule's model, against JAX's tensordot and ``jax.vjp`` (the
    forward table and both grad tables, transposed reads, +-1 signs)."""
    sa, da, sb, db, axes, ferm, pshifts = JAX_CASES[name]
    rng = np.random.RandomState(len(name))
    pa, pb = pshifts or (None, None)
    ja = jrandom(rng, sa, da, 1, ferm, pa, jnp.asarray)
    jb = jrandom(rng, sb, db, 0, ferm, pb, jnp.asarray)
    dot = lambda x, y: x.tensordot(y, axes)  # noqa: E731
    jc, vjp = jax.vjp(dot, ja, jb)
    ct = jc.copy_with({q: jnp.asarray(rng.rand(*np.shape(v)) - 0.5)
                       for q, v in sorted(jc.blocks.items())})
    ga, gb = vjp(ct)
    ta, tb = port(ja), port(jb)
    xa = ta.data.detach().clone().requires_grad_()
    xb = tb.data.detach().clone().requires_grad_()
    with mock.patch.object(t_tensor, "block_gemm", _model_gemm):
        tc = AbelianTensor._flat(ta, ta.struct, xa).tensordot(AbelianTensor._flat(tb, tb.struct,
                                                                                  xb), axes)
        g1, g2 = torch.autograd.grad(tc.data, (xa, xb), port(ct).data)
    plan = ta.dot_operands(tb, axes)[0]
    tabs = (plan.gemm,) + plan.gemm.grad_tables()
    assert any(bs.CLASS_NAMES[c] in name for t in tabs for c in np.unique(t.ob_kind))

    def rel(jt, tt, flat_data):
        got = AbelianTensor._flat(tt, tt.struct, flat_data.detach()).numpy_blocks()
        ref = {q: np.asarray(v) for q, v in jt.blocks.items()}
        assert sorted(got) == sorted(ref)
        scale = max(float(np.abs(v).max()) for v in ref.values())
        return max(float(np.abs(got[q] - ref[q]).max()) for q in ref) / scale

    assert rel(jc, tc, tc.data) < 1e-12
    assert rel(ga, ta, g1) < 1e-12 and rel(gb, tb, g2) < 1e-12


# ---------------------------------------------------------------------------
# block_permute's boxes and passes
# ---------------------------------------------------------------------------


def _by_dst(sidx, didx):
    order = np.argsort(didx, kind="stable")
    return sidx[order], didx[order]


def boxes_index(t: bs.PermuteTable):
    R = t.rank
    meta = t.c_meta.astype(np.int64)
    return bs.expand_entries(t.c_soff, t.c_doff, meta[:, :R], meta[:, R:2 * R],
                             meta[:, 2 * R:3 * R])


def passes_model(t: bs.PermuteTable):
    """The kernel's copy of every box, index by index: SMALL boxes element by
    element; staged ones through its two passes (the outer and inner tables,
    each thread's carry steps).  Returns (src, dst) per element written."""
    R = t.rank
    srcs, dsts = [], []
    for e, mt in enumerate(t.c_meta.astype(np.int64)):
        shape, ss, ds, size = mt[:R], mt[R:2 * R], mt[2 * R:3 * R], mt[3 * R]
        so, do = int(t.c_soff[e]), int(t.c_doff[e])
        assert size == shape.prod() and size <= bs.PERMUTE_CHUNK
        if size <= 128:
            _, s, d = bs.expand_entries([so], [do], shape[None], ss[None], ds[None])
            srcs.append(s)
            dsts.append(d)
            continue
        # the kernel's leg orders (by stride, extent 1 first, ties by leg) and
        # the legs where their prefix products cross sqrt(size)
        def order(st):
            key = [np.iinfo(np.int64).max if shape[j] == 1 else st[j] for j in range(R)]
            rank = [sum(key[j] > key[l] or (key[j] == key[l] and j < l) for j in range(R))
                    for l in range(R)]
            out = np.zeros(R, np.int64)
            out[rank] = np.arange(R)
            return out

        def middle(ordr):
            pre = np.cumprod(shape[ordr])
            cross = np.nonzero(pre * pre > size)[0]
            return int(cross[0]) if len(cross) else R - 1

        aord, bord = order(ss), order(ds)
        aq, bq = middle(aord), middle(bord)
        loc = bs.contiguous_strides(shape[None])[0]
        flags = int(all(shape[l] == 1 or ds[l] == loc[l] for l in range(R)))

        def table(order, l0, l1, strides):
            n = int(np.prod(shape[order[l0:l1]]))
            assert n <= bs.PERMUTE_TABLE
            out = np.zeros(n, np.int64), np.zeros(n, np.int64)
            for x in range(n):
                r = x
                for j in range(l1 - 1, l0 - 1, -1):
                    l = order[j]
                    i = r % shape[l]
                    r //= shape[l]
                    for k, st in enumerate(strides):
                        out[k][x] += i * st[l]
            return out, n

        def walk(I, E):
            pos = []
            for th in range(PTHREADS):
                i, r = th % I, th // I
                m, o = r % E, r // E
                di, q = PTHREADS % I, PTHREADS // I
                dm, dq = q % E, q // E
                for x in range(th, size, PTHREADS):
                    pos.append((x, o, m, i))
                    i += di
                    c = i >= I
                    i -= I if c else 0
                    m += dm + c
                    c = m >= E
                    m -= E if c else 0
                    o += dq + c
            return pos

        (ti_s, ti_d), I = table(aord, aq + 1, R, (ss, loc))
        (to_s, to_d), O = table(aord, 0, aq, (ss, loc))
        lm = aord[aq]
        staged = np.full(size, -1, np.int64)  # the source index each staged slot holds
        for x, o, m, i in walk(I, shape[lm]):
            d = to_d[o] + m * loc[lm] + ti_d[i]
            assert staged[d] == -1
            staged[d] = so + to_s[o] + m * ss[lm] + ti_s[i]
        assert (staged >= 0).all()
        if flags & 1:
            dst = do + np.arange(size)
        else:
            (wi_d, wi_l), I = table(bord, bq + 1, R, (ds, loc))
            (wo_d, wo_l), O = table(bord, 0, bq, (ds, loc))
            lb = bord[bq]
            dst = np.full(size, -1, np.int64)
            for x, o, m, i in walk(I, shape[lb]):
                slot = wo_l[o] + m * loc[lb] + wi_l[i]
                assert dst[slot] == -1
                dst[slot] = do + wo_d[o] + m * ds[lb] + wi_d[i]
            assert (dst >= 0).all()
        srcs.append(staged)
        dsts.append(dst)
    return np.concatenate(srcs), np.concatenate(dsts)


def _permute_tables():
    """Operand layouts of the D=3 move, the corner's sector gather, its
    inverse, and a synthetic table of rank-7 entries large enough to be cut."""
    tabs = {}
    for i, (x, y, axes, out_like) in enumerate(d3_dots()):
        plan = x.dot_operands(y, axes, out_like)[0]
        for side, p in (("a", plan.perm_a), ("b", plan.perm_b)):
            if p is not None:
                tabs[f"d3_dot{i}_{side}"] = p
    x = d3_dots()[3][0]
    sp = t_tensor._sector_plan(x, tuple(range(x.ndim - 3)), tuple(range(x.ndim - 3, x.ndim)))
    tabs["sector_gather"] = sp.table
    tabs["sector_scatter"] = sp.table.inverse()
    rng = np.random.RandomState(3)
    dims = np.array([[44, 4, 2, 3, 4, 2, 3], [19, 2, 4, 4, 3, 2, 2], [6, 3, 3, 3, 3, 3, 3],
                     [2, 2, 2, 2, 2, 2, 2], [1, 1, 5, 1, 7, 1, 1]])
    perm = np.array([3, 0, 5, 1, 6, 2, 4])
    src_str = bs.contiguous_strides(dims)
    size = dims.prod(axis=1)
    soff = np.cumsum(size) - size
    dst_dims = dims[:, perm]
    big = bs.PermuteTable(soff, soff, dst_dims, src_str[:, perm], bs.contiguous_strides(dst_dims),
                          np.where(rng.rand(len(dims)) < 0.5, -1.0, 1.0))
    tabs["rank7_cut"] = big
    tabs["rank7_cut_inverse"] = big.inverse()
    return tabs


_PT = {}


def permute_tables():
    if not _PT:
        _PT.update(_permute_tables())
    return _PT


def test_permute_tables_cover_the_kinds():
    tabs = permute_tables()
    assert tabs["rank7_cut"].c_meta.shape[0] > tabs["rank7_cut"].nblk  # entries were cut
    sg = tabs["sector_gather"]
    R = sg.rank
    rows = bs.contiguous_strides(sg.c_meta[:, :R].astype(np.int64))
    assert not (((sg.c_meta[:, 2 * R:3 * R] == rows) | (sg.c_meta[:, :R] == 1)).all(axis=1)).all()
    assert len([k for k in tabs if k.startswith("d3_dot")]) >= 4


@pytest.mark.parametrize("which", ["d3", "sector", "rank7"])
def test_permute_boxes_give_the_element_index(which):
    for name, t in permute_tables().items():
        if not name.startswith(which if which != "sector" else "sector"):
            continue
        sidx, didx, sc = t.element_index(CPU)
        ent, bs_s, bs_d = boxes_index(t)
        ref_s, ref_d = _by_dst(sidx.numpy(), didx.numpy())
        got_s, got_d = _by_dst(bs_s, bs_d)
        assert np.array_equal(got_d, ref_d) and np.array_equal(got_s, ref_s), name
        assert (t.c_meta[:, -1] <= bs.PERMUTE_CHUNK).all()
        if sc is not None:
            order = np.argsort(bs_d, kind="stable")
            ref_order = np.argsort(didx.numpy(), kind="stable")
            assert np.array_equal(t.c_scale[ent][order], sc.numpy()[ref_order]), name
        tp = t.tile_ptr
        assert tp[0] == 0 and tp[-1] == len(t.c_soff) and (np.diff(tp) > 0).all()
        assert (np.diff(tp) <= bs.PERMUTE_TILE_ENTRIES).all()


@pytest.mark.parametrize("which", ["d3", "sector", "rank7"])
def test_permute_passes_copy_each_element_once(which):
    for name, t in permute_tables().items():
        if not name.startswith(which):
            continue
        sidx, didx, _ = t.element_index(CPU)
        s, d = passes_model(t)
        ref_s, ref_d = _by_dst(sidx.numpy(), didx.numpy())
        got_s, got_d = _by_dst(s, d)
        assert np.array_equal(got_d, ref_d) and np.array_equal(got_s, ref_s), name
