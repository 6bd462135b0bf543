"""Parity of the port's Ozaki product (tpeps_torch.linalg.ozaki, the K7
kernels ozaki_split / ozaki_gemm through their CPU twins) with
tpeps.linalg.ozaki, and of the factored move with ``dot_impl="ozaki"``.

The same numpy inputs go to both packages (twins of tests/test_ozaki.py).
XLA's CPU ``exp2`` is not exact at every integer (``exp2(3.0)`` comes out
8 - 1.8e-15), so where a row's exponent lands there the JAX package's scale
is off by an ulp and its lowest digits differ from the exact ones the port
extracts.  The bit-for-bit checks therefore take rows whose max |x| lies in
[0.5, 1) (exponent 0, exact in both); the tolerance checks take any input.
"""

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from tpeps.ctm.c4v import move_tpu as jm
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps.linalg import ozaki as jo
from tpeps_torch.ctm.c4v import move_factored as tm
from tpeps_torch.io.convert import to_torch
from tpeps_torch.kernels import ozaki as ko
from tpeps_torch.kernels.ozaki import ozaki_gemm_twin, ozaki_split_twin, padded_k
from tpeps_torch.linalg import ozaki as to
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

SLICES = [8, 7, 6, 2]


def _rel_err(C, Cref):
    C, Cref = np.asarray(C), np.asarray(Cref)
    return float(np.abs(C - Cref).max() / np.abs(Cref).max())


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _exact_scale_pair(seed):
    """(192, 257) @ (257, 129) with every row / column max in [0.5, 1)."""
    rng = np.random.RandomState(seed)
    A = rng.uniform(-1, 1, (192, 257))
    B = rng.uniform(-1, 1, (257, 129))
    A[:, 0] = 0.75  # pin every row's (column's) max into [0.5, 1)
    B[0, :] = -0.75
    return A, B


@pytest.mark.parametrize("s", SLICES)
def test_split_bit_identical(s):
    A, B = _exact_scale_pair(0)
    for X, axis in ((A, 1), (B, 0)):
        cj, ej = jo._split_int8(jnp.asarray(X), s, 7, axis)
        planes, e = to._split_int8(_t(X), s, 7, axis)
        ref = np.stack([np.asarray(c) for c in cj])
        if axis == 0:
            ref = ref.transpose(0, 2, 1)  # the port stores B's planes as (n, k)
        k = X.shape[axis]
        assert planes.dtype == torch.int8 and planes.shape == (s, X.shape[1 - axis], padded_k(k))
        np.testing.assert_array_equal(planes[:, :, :k].numpy(), ref)
        assert not planes[:, :, k:].any()  # zero digits pad k to a multiple of 32
        np.testing.assert_array_equal(e.numpy(), np.asarray(ej).ravel())


@pytest.mark.parametrize("s", SLICES)
def test_matmul_matches_jax(s):
    A, B = _exact_scale_pair(1)
    Cj = np.asarray(jo.ozaki_matmul(jnp.asarray(A), jnp.asarray(B), s, 7))
    Ct = to.ozaki_matmul(_t(A), _t(B), s, 7).numpy()
    assert _rel_err(Ct, Cj) <= 1e-15


@pytest.mark.parametrize("s,bound", [(8, 1e-13), (7, 1e-11), (6, 3e-10)])
def test_matmul_accuracy(s, bound):
    rng = np.random.RandomState(0)
    A, B = rng.randn(192, 257), rng.randn(257, 129)
    C = to.ozaki_matmul(_t(A), _t(B), s, 7)
    assert _rel_err(C, A @ B) < bound
    # and JAX's product, whose scales may be an ulp off, to the same digits
    assert _rel_err(C, jo.ozaki_matmul(jnp.asarray(A), jnp.asarray(B), s, 7)) < bound


def test_matmul_dynamic_range():
    rng = np.random.RandomState(1)
    A = rng.randn(64, 96) * np.logspace(-12, 9, 64)[:, None]
    B = rng.randn(96, 64) * np.logspace(8, -11, 64)[None, :]
    assert _rel_err(to.ozaki_matmul(_t(A), _t(B), 8, 7), A @ B) < 1e-12


def test_matmul_zero_rows():
    B = np.random.RandomState(2).randn(32, 16)
    C = to.ozaki_matmul(torch.zeros(16, 32, dtype=torch.float64), _t(B), 8, 7)
    assert float(C.abs().max()) == 0.0


def test_int32_group_sums_wrap():
    """A digit group whose sum leaves int32 wraps, as XLA's int32 dot (and
    the kernel's wgmma without .satfinite) does."""
    k = 160000  # 160000 * 127^2 = 2.58e9 > 2^31
    Ap = torch.full((1, 2, k), 127, dtype=torch.int8)
    Bp = torch.full((1, 3, k), 127, dtype=torch.int8)
    out = ozaki_gemm_twin(Ap, torch.ones(2, dtype=torch.float64), Bp,
                          torch.ones(3, dtype=torch.float64), 7)
    wrapped = (k * 127 * 127 + 2**31) % 2**32 - 2**31
    np.testing.assert_array_equal(out.numpy(), np.full((2, 3), wrapped * 2.0**-14))


def test_dot_general_batched_matches_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(3, 5, 4, 6), rng.randn(3, 6, 4, 7)
    dn = (((2, 3), (2, 1)), ((0,), (0,)))
    C = to.ozaki_dot_general(_t(a), _t(b), dn).numpy()
    assert _rel_err(C, jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), dn)) < 1e-12
    assert _rel_err(C, jo.ozaki_dot_general(jnp.asarray(a), jnp.asarray(b), dn)) < 1e-12


def test_matmul_grad_is_split_matmul():
    rng = np.random.RandomState(4)
    A, B, W = rng.randn(24, 32), rng.randn(32, 16), rng.randn(24, 16)
    At, Bt = _t(A).requires_grad_(), _t(B).requires_grad_()
    (to.ozaki_matmul(At, Bt, 8, 7) * _t(W)).sum().backward()
    assert _rel_err(At.grad, W @ B.T) < 1e-12
    assert _rel_err(Bt.grad, A.T @ W) < 1e-12
    f = lambda x, y: jnp.vdot(jnp.asarray(W), jo.ozaki_matmul(x, y, 8, 7))
    gA, gB = jax.grad(f, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(B))
    assert _rel_err(At.grad, gA) < 1e-12 and _rel_err(Bt.grad, gB) < 1e-12


@pytest.mark.parametrize("s", [8, 7])
def test_presplit_equals_one_shot(s):
    rng = np.random.RandomState(3)
    A = rng.randn(96, 131) * np.exp(rng.randn(96, 131))
    Ac, ea = to.ozaki_presplit(_t(A), s)
    for _ in range(3):  # several right operands reuse one split
        B = rng.randn(131, 40)
        got = to.ozaki_matmul_presplit(Ac, ea, _t(B), s)
        np.testing.assert_array_equal(got.numpy(), to.ozaki_matmul(_t(A), _t(B), s, 7).numpy())
        assert _rel_err(got, A @ B) < (1e-12 if s == 8 else 1e-10)


def test_presplit_raises_under_autograd():
    A = torch.rand(8, 8, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        to.ozaki_presplit(A)
    Ac, ea = to.ozaki_presplit(A.detach())
    with pytest.raises(RuntimeError, match="forward-only"):
        to.ozaki_matmul_presplit(Ac, ea, torch.rand(8, 3, dtype=torch.float64,
                                                     requires_grad=True))
    with torch.no_grad():  # nothing is tracked, nothing is dropped
        to.ozaki_presplit(A)


def test_dot_impl_parse_as_jax():
    rng = np.random.RandomState(5)
    x, y = rng.randn(32, 48), rng.randn(48, 24)
    dn = (((1,), (0,)), ((), ()))
    ref = x @ y
    assert _rel_err(tm._dot(_t(x), _t(y), dn, "ozaki:7"), ref) < 1e-11
    assert _rel_err(tm._dot(_t(x), _t(y), dn, "ozaki"), ref) < 1e-13
    assert _rel_err(tm._dot(_t(x), _t(y), dn, "ozaki:2"), ref) > 1e-7  # the knob is honoured
    assert _rel_err(tm._dot(_t(x), _t(y), dn, "xla"), ref) < 1e-15
    for bad in ("ozakii", "ozaki8", "ozaki:", "ozaki:x", "ozaki:0", "xl"):
        with pytest.raises(ValueError) as ej:
            jm._ozaki_slices(bad)
        with pytest.raises(ValueError) as et:
            tm._dot(_t(x), _t(y), dn, bad)
        assert str(et.value) == str(ej.value)


def test_ozaki_twins_reject_bad_word_bits():
    with pytest.raises(ValueError, match="word_bits"):
        to.ozaki_matmul(torch.eye(4, dtype=torch.float64), torch.eye(4, dtype=torch.float64), 8, 8)
    with pytest.raises(ValueError, match="overflows"):
        to.ozaki_presplit(torch.zeros(2, 1 << 17, dtype=torch.float64))


@pytest.fixture(scope="module")
def move_case():
    rng = np.random.RandomState(5)
    D, chi = 3, 27
    aj = j_symmetrize(jnp.asarray(rng.rand(2, D, D, D, D) - 0.5), normalize=True)
    envj = j_init_env(aj, chi, "CTMRG")
    at, envt = to_torch(np.asarray(aj), (np.asarray(envj.C), np.asarray(envj.T)), device="cpu")
    return D, chi, aj, envj, at, envt


@pytest.mark.parametrize("slice_phys", [False, True], ids=["full", "slice_phys"])
def test_ozaki_move_matches_jax(move_case, slice_phys):
    """One factored move with dot_impl="ozaki", port against JAX's: the
    chi products, the layers and the corner apply all on Ozaki products."""
    D, chi, aj, envj, at, envt = move_case
    P0 = np.eye(chi * D * D, chi)
    Cj, Tj, sj, Pj = (np.asarray(x) for x in jm.ctm_move_sl_tpu(
        aj, envj.C, jm.to_tpu_layout(envj.T, D), jnp.asarray(P0), slice_phys=slice_phys,
        dot_impl="ozaki"))
    Ct, Tt, st, Pt = (x.numpy() for x in tm.ctm_move_sl_factored(
        at, envt.C, tm.to_int_layout(envt.T, D), _t(P0), slice_phys=slice_phys,
        dot_impl="ozaki"))
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-11)
    for x, y in ((Ct, Cj), (Tt, Tj), (Pt, Pj)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-10)
    # and the port's FP64 move from the same start, to the Ozaki accuracy
    Cx, Tx, sx, _ = (x.numpy() for x in tm.ctm_move_sl_factored(
        at, envt.C, tm.to_int_layout(envt.T, D), _t(P0), slice_phys=slice_phys))
    np.testing.assert_allclose(st, sx, rtol=0, atol=1e-11)
    np.testing.assert_allclose(Ct, Cx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Tt, Tx, rtol=0, atol=1e-10)


def test_split_twin_matches_kernel_layout():
    """The twin's planes are (s, rows, kp): rows of A, columns of B."""
    X = torch.tensor([[0.5, -0.25], [0.0, 0.75], [-1.0, 2.0]], dtype=torch.float64)
    pa, ea = ozaki_split_twin(X, 2, 7, 1)
    pb, eb = ozaki_split_twin(X, 2, 7, 0)
    assert pa.shape == (2, 3, 32) and pb.shape == (2, 2, 32)
    np.testing.assert_array_equal(ea.numpy(), [1.0, 1.0, 4.0])
    np.testing.assert_array_equal(eb.numpy(), [2.0, 4.0])
    # 0.5 -> digit 64 of 128 in the top plane; -0.25 -> -32
    assert pa[0, 0, 0] == 64 and pa[0, 0, 1] == -32 and pa[1, 0, 0] == 0


# --- host-side logic of the ozaki_gemm kernel: its recombination table
# (csrc/ozaki.cu reads it; the kernel itself runs on the card)

def _jax_accumulate_steps(s, w):
    """The steps of tpeps/linalg/ozaki.py:_accumulate for every total, with
    its own expressions: (total, "f64", scale), (total, "tail0", None),
    (total, "tail", factor); and the scale of the float32 tail."""
    steps, t_tail, t_prev = [], None, None
    for total in range(s + 1, 1, -1):
        if total * w >= 42:
            if t_tail is None:
                t_tail = total
                steps.append((total, "tail0", None))
            else:
                steps.append((total, "tail", float(2.0 ** ((total - t_prev) * w))))
            t_prev = total
        else:
            steps.append((total, "f64", float(2.0 ** (-total * w))))
    return steps, (float(2.0 ** (-t_prev * w)) if t_tail is not None else None)


@pytest.mark.parametrize("w", range(1, 8))
@pytest.mark.parametrize("s", range(1, 9))
def test_recombination_table_is_jax_accumulate(s, w):
    kind, scale, factor, tail_scale = ko.recombination_table(s, w)
    steps, final = _jax_accumulate_steps(s, w)
    names = {1: "f64", 2: "tail0", 3: "tail"}
    got = [(g + 2, names[kind[g]], scale[g] if kind[g] == 1 else factor[g] if kind[g] == 3
            else None) for g in range(ko.MAX_SLICES - 1, -1, -1) if kind[g]]
    assert got == steps  # Python floats: == is bit for bit here (no NaN, no -0.0)
    assert all(kind[g] == 0 for g in range(s, ko.MAX_SLICES))  # totals past s + 1
    assert (tail_scale if tail_scale != 0.0 else None) == final
    # the kernel holds the tail factors in float32: exact
    assert all(float(np.float32(f)) == f for f in factor)


def _recombine_as_kernel(Ap, ea, Bp, eb, w):
    """The kernel's epilogue in torch ops: int32 group sums (wrapped), then
    the table walked from group MAX_SLICES - 1 down to 0."""
    s = Ap.shape[0]
    kind, scale, factor, tail_scale = ko.recombination_table(s, w)
    sums = [sum((Ap[p].double() @ Bp[g - p].double().T).to(torch.int64)
                for p in range(g + 1) if p < s and g - p < s) for g in range(s)]
    sums = [((x + 2**31) % 2**32 - 2**31).to(torch.int32) for x in sums]
    out = torch.zeros(sums[0].shape, dtype=torch.float64)
    tail = torch.zeros(sums[0].shape, dtype=torch.float32)
    for g in range(ko.MAX_SLICES - 1, -1, -1):
        if kind[g] == 1:
            out = out + sums[g].double() * scale[g]
        elif kind[g] == 2:
            tail = sums[g].float()
        elif kind[g] == 3:
            tail = tail * torch.tensor(factor[g], dtype=torch.float32) + sums[g].float()
    if tail_scale != 0.0:
        out = out + tail.double() * tail_scale
    return out * ea[:, None] * eb[None, :]


@pytest.mark.parametrize("s,w", [(1, 7), (3, 7), (5, 7), (6, 7), (8, 7), (8, 5), (8, 3), (4, 2)])
def test_kernel_recombination_is_the_twin(s, w):
    """Walking the table as the kernel does gives the twin bit for bit."""
    rng = np.random.RandomState(s + 10 * w)
    hi = 2**w - 1
    Ap = torch.from_numpy(rng.randint(-hi, hi + 1, (s, 16, 64)).astype(np.int8))
    Bp = torch.from_numpy(rng.randint(-hi, hi + 1, (s, 24, 64)).astype(np.int8))
    ea = torch.from_numpy(2.0 ** rng.randint(-3, 4, 16))
    eb = torch.from_numpy(2.0 ** rng.randint(-3, 4, 24))
    assert torch.equal(_recombine_as_kernel(Ap, ea, Bp, eb, w), ozaki_gemm_twin(Ap, ea, Bp, eb, w))


def test_recombination_table_rejects_bad_slices():
    with pytest.raises(ValueError, match="slices"):
        ko.recombination_table(9, 7)
    with pytest.raises(ValueError, match="slices"):
        ko.recombination_table(0, 7)



def _bitfield_split(X, s, w, axis):
    """A plain-torch int64 model of the split kernel's digit extraction
    (csrc/ozaki.cu: row_scale, fixed_point, digits16): ex from the row's
    max as the twin forms it; F = floor(|x| 2^(s w - ex)), x's significand
    (hidden bit 0 for a subnormal) shifted by its exponent field; digit p =
    (F >> ((s-1-p) w)) & mask times sign(x).  A row with a NaN or an
    infinity gives zero digits; a row whose max is below 2^-1024 (2^-ex
    infinite) gives the mask for every nonzero x, as the twin's saturating
    int32 truncation does on the card."""
    mx = X.abs().amax(dim=axis, keepdim=True)
    ex = torch.floor(torch.log2(torch.where(mx == 0.0, torch.ones_like(mx), mx))) + 1.0
    finite = torch.isfinite(ex)
    bits = X.view(torch.int64)
    mag = bits & 0x7FFFFFFFFFFFFFFF
    E = mag >> 52
    sig = (mag & ((1 << 52) - 1)) | torch.where(E > 0, 1 << 52, 0)
    sh = torch.where(E > 0, E, 1) + (s * w - 1075) - torch.where(finite, ex, 0.0).to(torch.int64)
    F = torch.where(sh >= 0, sig << sh.clamp(0, 63), sig >> (-sh).clamp(0, 63))
    F = torch.where(sh <= -64, 0, F)
    F = torch.where(finite & (ex <= -1024), torch.where(mag != 0, -1, 0), F)  # -1: every bit set
    F = torch.where(finite, F, 0)
    mask = (1 << w) - 1
    planes = torch.stack([torch.where(bits < 0, -d, d).to(torch.int8)
                          for d in ((F >> ((s - 1 - p) * w)) & mask for p in range(s))])
    if axis == 0:
        planes = planes.transpose(1, 2)
    k = planes.shape[-1]
    planes = torch.nn.functional.pad(planes, (0, padded_k(k) - k)).contiguous()
    return planes, torch.exp2(ex).reshape(-1)


def _mixed_rows(k, seed):
    """Rows at k mixing exponents 2^-60 .. 2^60 with exact powers of two,
    -0.0, subnormal entries, a zero row, a row of subnormals whose max is in
    [2^-1023, 2^-1022), a row holding a NaN and one holding an infinity."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.5, 1.0, (9, k)) * np.exp2(rng.randint(-60, 61, (9, k)))
    X *= rng.choice([-1.0, 1.0], (9, k))
    at = rng.rand(9, k) < 0.1
    X[at] = np.exp2(rng.randint(-40, 41, at.sum()))
    X[rng.rand(9, k) < 0.08] = -0.0
    at = rng.rand(9, k) < 0.08
    X[at] = 5e-324 * rng.randint(1, 1000, at.sum())
    # every other row keeps a max above 2^-1024: below it the CPU twin's int32
    # truncation of an infinity differs from the card's (held on the card)
    X[np.abs(X).max(axis=1) < 2.0**-1000, 0] = 0.75
    X[2] = 0.0
    X[3] = np.linspace(-0.999, 0.5, k) * 2.0**-1022
    X[4, k // 2] = np.nan
    X[5, 0] = -np.inf
    X[6] = np.exp2(rng.randint(-30, 30, k))  # exact powers of two
    return X


def _same(x, y):
    return torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
        torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0))


@pytest.mark.parametrize("w", [7, 5, 3])
@pytest.mark.parametrize("s", SLICES)
def test_bitfield_digits_are_the_twin(s, w):
    """The kernel's digit algorithm (the model) bit for bit against the twin,
    rows and columns, k = 1, 31, 33 and 147."""
    for k in (1, 31, 33, 147):
        X = torch.from_numpy(_mixed_rows(k, 7 * k + s))
        for axis, Y in ((1, X), (0, X.mT.contiguous())):
            P, e = _bitfield_split(Y, s, w, axis)
            Pt, et = ozaki_split_twin(Y, s, w, axis)
            assert torch.equal(P, Pt), (k, axis)
            assert _same(e, et), (k, axis)


@pytest.mark.parametrize("s,w", [(8, 7), (6, 7), (8, 5), (2, 3)])
def test_bitfield_digits_are_jax(s, w):
    """The model against JAX's ``_split_int8`` on rows whose max is in [0.5,
    1) (XLA's CPU exp2 is inexact at some integers, see the module
    docstring), with subnormal entries, -0.0 and odd k."""
    rng = np.random.RandomState(s + w)
    for k in (1, 33, 147):
        X = rng.uniform(-1, 1, (6, k)) * np.exp2(rng.randint(-50, 1, (6, k)))
        X[:, 0] = 0.75
        X[1, 1:] = -0.0
        X[2, 1:] = 5e-324 * rng.randint(1, 1000, k - 1)
        cj, ej = jo._split_int8(jnp.asarray(X), s, w, 1)
        P, e = _bitfield_split(_t(X), s, w, 1)
        np.testing.assert_array_equal(P[:, :, :k].numpy(), np.stack([np.asarray(c) for c in cj]))
        np.testing.assert_array_equal(e.numpy(), np.asarray(ej).ravel())
