"""K2's float32 corner apply and K9's ``adjoint_commit``: a CPU model of
K2's design and the adjoint twin's stop decisions, held against the JAX
package.

K2 (``tpeps_torch/csrc/corner_apply.cu``) computes ``Y = M2 @ P`` in float32
as three TF32 products on the tensor cores: each operand split into ``hi =
tf32(x)`` and ``lo = tf32(x - hi)``, rounded to nearest with ties away from
zero (``cvt.rna``; the kernel rounds with two integer operations on the
bits), and ``Y = A_hi B_hi + A_hi B_lo + A_lo B_hi``.  A plain-torch model of
that split (rounding modelled from the value, independently of the bit
trick) is held against JAX's ``_m_apply`` (tpeps/ctm/c4v/move_tpu.py:121) in
float32 at 1e-5 normwise on a D=3, chi=27 move; the bit trick against the
model bit for bit; hi + lo against x to 2^-21 relative across exponents
2^-30 .. 2^30.

For K9's ``adjoint_commit`` the twin's stop decisions are held against the
JAX package's adjoint ``while_loop`` on crafted edge cases: delta exactly at
``tol^2 |ybar|^2`` and at ``1e4 |ybar|^2``, a delta that never changes, and
the fourth growth in a row.
"""

import re

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from tpeps.ctm.c4v import move_tpu as jm
from tpeps.ctm.c4v.env import init_env as j_init_env
from tpeps.ctm.c4v_abelian import frozen as j_frozen
from tpeps.ipeps.ipeps_c4v import symmetrize_c4v as j_symmetrize
from tpeps_torch.kernels.corner import corner_apply, corner_apply_twin
from tpeps_torch.kernels.frozen import adjoint_commit_twin, adjoint_state
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

D, CHI = 3, 27


def tf32_rna_model(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 stored significand bits), to nearest
    with ties away from zero, from the value: ``|x|`` in units of its TF32
    spacing, ``floor(. + 1/2)``, back (float64 throughout, exact)."""
    v = x.double()
    mag = v.abs()
    # the spacing of TF32 at |x|: 2^(e - 10) for |x| in [2^e, 2^(e+1)), and
    # 2^-136 below 2^-126 (subnormals)
    e = torch.floor(torch.log2(torch.where(mag > 0, mag, torch.ones_like(mag))))
    e = torch.clamp(e, min=-126.0)
    ulp = torch.exp2(e - 10)
    r = torch.floor(mag / ulp + 0.5) * ulp
    return (torch.sign(v) * r).float()


def tf32_rna_bits(x: torch.Tensor) -> torch.Tensor:
    """The kernel's rounding: half the dropped 13 bits' unit added to the
    bits, then the 13 bits dropped."""
    b = x.view(torch.int32).long() & 0xFFFFFFFF
    r = ((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)


def split_model(x: torch.Tensor):
    hi = tf32_rna_model(x)
    lo = tf32_rna_model((x.double() - hi.double()).float())
    return hi, lo


def tf32x3_model(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A_hi B_hi + A_hi B_lo + A_lo B_hi`` with exact products (TF32 x TF32
    fits float32's significand) summed in float64, rounded to float32."""
    ah, al = (t.double() for t in split_model(A))
    bh, bl = (t.double() for t in split_model(B))
    return (ah @ bh + ah @ bl + al @ bh).float()


@pytest.fixture(scope="module")
def move_operands():
    """M2 (the port's layout) and P of a D=3, chi=27 move, float32, from a
    numpy RandomState, with JAX's ``_m_apply`` of them in float32."""
    rng = np.random.RandomState(3)
    aj = j_symmetrize(jnp.asarray(rng.rand(2, D, D, D, D) - 0.5), normalize=True)
    envj = j_init_env(aj, CHI, "CTMRG")
    M6 = np.asarray(jm._c2x2_factored(aj, envj.C, jm.to_tpu_layout(envj.T, D)), np.float32)
    n = CHI * D * D
    P = np.linalg.qr(rng.rand(n, CHI) - 0.5)[0].astype(np.float32)
    Yj = np.asarray(jm._m_apply(jnp.asarray(M6), jnp.asarray(P), CHI, D))
    assert Yj.dtype == np.float32
    # JAX M6[f,g,e,r,j,i] -> the port's M2[(j,e,f),(i,r,g)]
    M2 = np.ascontiguousarray(M6.transpose(4, 2, 0, 5, 3, 1).reshape(n, n))
    return torch.from_numpy(M2), torch.from_numpy(P), torch.from_numpy(Yj.copy())


def _normwise(x, ref):
    return float(torch.linalg.norm((x - ref).double()) / torch.linalg.norm(ref.double()))


def test_tf32x3_model_matches_jax_m_apply(move_operands):
    """The 3xTF32 model of K2's float32 product against JAX's float32
    ``_m_apply`` at 1e-5 normwise, as the port's twin is; one TF32 product
    alone is not within it."""
    M2, P, Yj = move_operands
    assert _normwise(tf32x3_model(M2, P), Yj) <= 1e-5
    assert _normwise(corner_apply(M2, P), Yj) <= 1e-5
    assert _normwise(corner_apply_twin(M2, P), Yj) <= 1e-5
    one = (tf32_rna_model(M2).double() @ tf32_rna_model(P).double()).float()
    assert _normwise(one, Yj) > 1e-5


def _exponent_sweep(seed=0, n=20000):
    """float32 values of both signs with random significands and exponents
    2^-30 .. 2^30."""
    rng = np.random.RandomState(seed)
    sig = 1.0 + rng.randint(0, 2**23, n) / 2.0**23
    x = sig * np.exp2(rng.randint(-30, 31, n)) * np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    return torch.from_numpy(x.astype(np.float32))


def test_hi_plus_lo_reproduces_x():
    """hi + lo reproduces every float32 across exponents 2^-30 .. 2^30 to
    2^-21 relative; hi and lo are TF32 values (13 low bits zero)."""
    x = _exponent_sweep()
    hi, lo = split_model(x)
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0**-21
    for t in (hi, lo):
        assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_kernel_rounding_is_rna():
    """The kernel's bit rounding is the model's round-to-nearest, ties away:
    on the exponent sweep, on exact ties of both signs, on significands of
    all ones (the carry into the exponent), on zeros, subnormals and
    FLT_MAX (which rounds to inf)."""
    rng = np.random.RandomState(1)
    bits = (rng.randint(0, 2**23, 500) & ~0x1FFF) | 0x1000  # exact ties
    ties = (np.int64(127 + rng.randint(-30, 31, 500)) << 23) | bits
    ones = (np.int64(127 + np.arange(-30, 31)) << 23) | 0x7FFFFF
    special = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 2.0**-140, 1.0, 3.4028235e38],
                           dtype=torch.float32)
    for x in (_exponent_sweep(2), torch.from_numpy(ties.astype(np.int32)).view(torch.float32),
              torch.from_numpy(ones.astype(np.int32)).view(torch.float32), special):
        for v in (x, -x):
            assert torch.equal(tf32_rna_bits(v), tf32_rna_model(v))
    assert float(tf32_rna_bits(torch.tensor([3.4028235e38]))[0]) == float("inf")
    # a tie goes away from zero
    t = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)], dtype=torch.float32)
    assert tf32_rna_bits(t).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


# ---------------------------------------------------------------------------
# the adjoint loop's stop decisions against JAX
# ---------------------------------------------------------------------------

# (lambda_C, lambda_T, adjoint_tol, adjoint_max_iter, iterations, diverged):
# u_C and u_T scale by lambda each iteration from cotangents whose squares
# sum exactly, so every delta below is exact
EDGE_CASES = {
    "delta_at_tol2": (0.5, 0.5, 0.5, 100, 1, False),
    "delta_at_1e4": (100.0, 100.0, 1e-8, 100, 1, True),
    "delta_unchanged": (1.0, 1.0, 1e-8, 6, 6, False),
    "fourth_growth": (1.25, 1.25, 1e-8, 100, 4, True),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_adjoint_stop_edges_match_jax(name, capfd):
    """JAX's backward of ``_make_converge_frozen`` (its ``while_loop``) with a
    linear stand-in move (``abar_i = u_C + u_T``) against the
    ``adjoint_commit`` twin driven by the same vectors: the accumulated
    cotangent (which fixes the iteration count) to 1e-15, the count, and
    the divergence as JAX prints it."""
    lam_c, lam_t, tol, max_iter, n_expected, diverged = EDGE_CASES[name]
    a = jnp.asarray([0.3, -0.2, 0.1])
    cot = (jnp.asarray([1.0, 0.5, -0.25]), jnp.asarray([0.5, -1.0, 0.75]))

    def move(a_, C, T, keep=None, ad_decomp_reg=None, sg_norm=None):
        return lam_c * C + a_, lam_t * T + a_

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_frozen, "move_frozen", move)
        mp.setattr(j_frozen, "run_frozen", lambda a_, C, T, keep, **kw: (C, T, 0, 0.0))
        conv = j_frozen._make_converge_frozen.__wrapped__((), 1, 0.0, 1e-12, max_iter, tol)
        _, vjp = jax.vjp(conv, a, a, a)
        da_j = np.asarray(vjp(cot)[0])
        jax.effects_barrier()
    printed = capfd.readouterr().out

    uC, uT = (torch.tensor(np.asarray(c)) for c in cot)
    st = adjoint_state(torch.zeros(3, dtype=torch.float64), uC, uT, max_iter, tol)
    while not bool(st.ctl[1]):
        da_i = uC + uT
        uC, uT = lam_c * uC, lam_t * uT
        adjoint_commit_twin(st, da_i, uC, uT)
    i, done, _, _, grew, div = st.ctl.tolist()
    assert np.abs(st.da.numpy() - da_j).max() <= 1e-15 * np.abs(da_j).max()
    assert done == 1 and i == n_expected and bool(div) == diverged
    if diverged:
        m = re.search(r"diverging \(iter (\d+)", printed)
        assert m and int(m.group(1)) == i, printed
    else:
        assert "diverging" not in printed
