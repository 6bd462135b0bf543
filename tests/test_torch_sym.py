"""The port's block-sparse tensor core against tpeps/sym on the CPU.

The same numpy blocks (``np.random.RandomState``) go to the JAX package's
``AbelianTensor`` (numpy blocks, as its own tests use them; jnp blocks for
its batched >8-pair branch) and to the port's, whose contractions run the
K8 twins through the plans.  Tolerances: tensordot 1e-13 with equal output
keys; transposes, fusion, conjugation, charge flips and dense embedding
bit-exact; blockwise decompositions 1e-12 in values and reconstructions
with the same kept profile; the frozen forms elementwise 1e-10 after gauge
fixing; the JSON format bit-identical both ways.
"""

import numpy as np
import pytest
import torch

import tpeps  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from tpeps.ipeps.ipeps_abelian import IPEPS_ABELIAN as J_IPEPS_ABELIAN
from tpeps.sym import frozen as j_frozen
from tpeps.sym import io as j_io
from tpeps.sym import tensor as j_tensor
from tpeps_torch.io.convert import (abelian_to_numpy, abelian_to_torch, env_c4v_abelian_to_numpy,
                                    env_c4v_abelian_to_torch)
from tpeps_torch.kernels.blocksparse import PermuteTable, block_permute_twin
from tpeps_torch.sym import frozen as t_frozen
from tpeps_torch.sym import io as t_io
from tpeps_torch.sym import tensor as t_tensor
from test_torch_package import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PHYS, AUX = {-1: 1, 1: 1}, {-1: 1, 0: 1, 1: 1}


def spec(t):
    return (t.sym, t.signature, [l.charges for l in t.legs], [l.pshift for l in t.legs], t.n,
            t.fermionic, {q: np.asarray(b) for q, b in t.blocks.items()})


def port(t):
    return abelian_to_torch(spec(t), device=CPU)


def jrandom(rng, signature, dims, n=0, fermionic=False, pshifts=None, backend=np.asarray):
    pshifts = pshifts or (0,) * len(dims)
    legs = tuple(j_tensor.leg(d, p) for d, p in zip(dims, pshifts))
    t = j_tensor.AbelianTensor("U1", signature, legs, n, fermionic=fermionic)
    return t.copy_with({q: backend(rng.rand(*t.block_shape(q)) - 0.5)
                        for q in sorted(t.all_allowed_blocks())})


def assert_same_blocks(jt, tt, tol):
    """``jt``: the JAX package's tensor (the reference), ``tt`` either's."""
    jb = {q: np.asarray(b) for q, b in jt.blocks.items()}
    tb = tt.numpy_blocks() if hasattr(tt, "numpy_blocks") else \
        {q: np.asarray(b) for q, b in tt.blocks.items()}
    assert sorted(jb) == sorted(tb)
    for q in jb:
        assert jb[q].shape == tb[q].shape, q
        if tol == 0:
            np.testing.assert_array_equal(tb[q], jb[q], err_msg=str(q))
        else:
            np.testing.assert_allclose(tb[q], jb[q], rtol=0, atol=tol, err_msg=str(q))
    assert tt.signature == jt.signature and tt.n == jt.n
    assert [l.charges for l in tt.legs] == [l.charges for l in jt.legs]


D2 = {-1: 2, 0: 1, 1: 2}
# (signature a, dims a, signature b, dims b, axes, fermionic, pshifts a/b, jnp blocks)
DOT_CASES = {
    "site_double_layer": ((1,) * 5, (PHYS,) + (AUX,) * 4, (-1,) * 5, (PHYS,) + (AUX,) * 4,
                          ((0, 1, 2), (0, 1, 2)), False, None, False),
    "one_leg": ((1, -1, 1), (D2, AUX, D2), (1, -1, -1), (AUX, D2, D2), ((1,), (0,)), False, None,
                False),
    "two_legs_permuted": ((1, -1, 1, 1), (D2, AUX, D2, PHYS), (-1, 1, 1), (PHYS, D2, AUX),
                          ((3, 1), (0, 2)), False, None, False),
    "outer_product": ((1, -1), (D2, AUX), (1,), (PHYS,), ((), ()), False, None, False),
    "full_contraction": ((1, -1, 1), (D2, AUX, PHYS), (-1, 1, -1), (D2, AUX, PHYS),
                         ((0, 1, 2), (0, 1, 2)), False, None, False),
    "fermionic": ((1, -1, 1, -1), (D2, AUX, D2, PHYS), (1, 1, 1), (AUX, PHYS, D2),
                  ((1, 3), (0, 1)), True, None, False),
    "fermionic_pshift_dual_first": ((-1, 1, 1), (D2, AUX, PHYS), (1, -1, -1), (D2, PHYS, AUX),
                                    ((0, 2), (0, 1)), True, ((1, 0, 0), (1, 0, 0)), False),
    "jnp_batched_branch": ((1, -1, 1, -1), (AUX, AUX, AUX, AUX), (-1, 1, 1), (AUX, AUX, AUX),
                           ((2, 3), (0, 1)), False, None, True),
}


@pytest.mark.parametrize("name", list(DOT_CASES))
def test_tensordot_matches_jax(name):
    sa, da, sb, db, axes, ferm, pshifts, use_jnp = DOT_CASES[name]
    rng = np.random.RandomState(len(name))
    be = jnp.asarray if use_jnp else np.asarray
    pa, pb = pshifts or (None, None)
    ja = jrandom(rng, sa, da, 1, ferm, pa, be)
    jb = jrandom(rng, sb, db, 0, ferm, pb, be)
    jc = ja.tensordot(jb, axes)
    if use_jnp:
        assert len(ja.blocks) * len(jb.blocks) > 8
    tc = port(ja).tensordot(port(jb), axes)
    assert_same_blocks(jc, tc, 1e-13)
    assert tc.fermionic == jc.fermionic


def _site(rng, fermionic=False):
    return jrandom(rng, (1, 1, 1, -1, -1), (PHYS,) + (AUX,) * 4, 1, fermionic,
                   (1, 0, 0, 0, 0) if fermionic else None)


STRUCT_OPS = {
    "transpose": lambda t: t.transpose((0, 3, 1, 4, 2)),
    "transpose_fermionic": lambda t: t.transpose((4, 2, 0, 3, 1)),
    "fuse_pair": lambda t: t.tensordot(t.conj(), ((0, 1), (0, 1))).transpose(
        (0, 3, 1, 4, 2, 5)).fuse_pair(0).fuse_pair(3),
    "conj": lambda t: t.conj(),
    "conj_fermionic": lambda t: t.conj(),
    "flip_charges": lambda t: t.flip_charges((0, 1, 2)),
    "charge_conjugate": lambda t: t.charge_conjugate(),
    "add_leg": lambda t: t.add_leg(axis=2, s=1),
}


@pytest.mark.parametrize("name", list(STRUCT_OPS))
def test_structure_ops_bit_exact(name):
    ja = _site(np.random.RandomState(3), fermionic=name.endswith("fermionic"))
    assert_same_blocks(STRUCT_OPS[name](ja), STRUCT_OPS[name](port(ja)), 0)


def test_dense_embedding_bit_exact():
    ja = _site(np.random.RandomState(4))
    ta = port(ja)
    dense = ta.to_dense()
    np.testing.assert_array_equal(dense.numpy(), np.asarray(ja.to_dense()))
    back = t_tensor.AbelianTensor.from_dense(dense, "U1", ta.signature, ta.legs, ta.n)
    jback = j_tensor.AbelianTensor.from_dense(np.asarray(ja.to_dense()), "U1", ja.signature,
                                              ja.legs, ja.n)
    assert_same_blocks(jback, back, 0)


def test_block_permute_twin_is_a_permute_copy():
    """The K8 permute twin through a plan equals permute().reshape() copies."""
    ta = port(_site(np.random.RandomState(5)))
    axes = (2, 0, 4, 1, 3)
    out, table, dst_of_src = t_tensor._permute_plan(ta.struct, axes)
    assert isinstance(table, PermuteTable)
    got = block_permute_twin(ta.data, torch.empty(out.numel, dtype=torch.float64), table)
    for i, (q, b) in enumerate(ta.blocks.items()):
        j = int(dst_of_src[i])
        ref = b.permute(axes).reshape(-1)
        assert torch.equal(got[int(out.offsets[j]):int(out.offsets[j]) + ref.numel()], ref)


def _hermitian_corner(rng):
    """A hermitian rank-6 tensor M = X X^dagger over (rows | cols), with no
    symmetry between charge sectors (so the gauge fixing has no ties)."""
    x = jrandom(rng, (1, -1, 1, 1), (D2, AUX, AUX, {-2: 6, -1: 9, 0: 12, 1: 9, 2: 6}), 0)
    return x.tensordot(x.conj(), ((3,), (3,)))


def _reconstruct_eigh(U, W):
    """U diag(W) U^dagger as the dense (rows x rows) matrix."""
    Ud = np.asarray(U.to_dense())
    Ud = Ud.reshape(-1, Ud.shape[-1])
    w = np.zeros(Ud.shape[-1])
    off = 0
    for q, d in U.legs[-1].charges:
        w[off:off + d] = np.asarray(W[q])
        off += d
    return (Ud * w) @ Ud.conj().T


def test_eigh_blockwise_matches_jax():
    jm = _hermitian_corner(np.random.RandomState(6))
    tm = port(jm)
    jU, jW = j_tensor.eigh_blockwise(jm, (0, 1, 2), (3, 4, 5), chi=14, eps_multiplet=1e-12)
    tU, tW = t_tensor.eigh_blockwise(tm, (0, 1, 2), (3, 4, 5), chi=14, eps_multiplet=1e-12)
    assert tU.legs[-1].charges == jU.legs[-1].charges
    for q in jW:
        np.testing.assert_allclose(np.sort(tW[q].numpy()), np.sort(np.asarray(jW[q])), atol=1e-12)
    np.testing.assert_allclose(_reconstruct_eigh(tU, tW), _reconstruct_eigh(jU, jW), atol=1e-12)


def test_svd_blockwise_matches_jax():
    rng = np.random.RandomState(7)
    ja = jrandom(rng, (1, -1, 1, -1), (D2, AUX, D2, AUX), 1)
    jU, jS, jV = j_tensor.svd_blockwise(ja, (0, 1), (2, 3), chi=9, eps_multiplet=1e-12)
    tU, tS, tV = t_tensor.svd_blockwise(port(ja), (0, 1), (2, 3), chi=9, eps_multiplet=1e-12)
    assert tU.legs[-1].charges == jU.legs[-1].charges
    for q in jS:
        np.testing.assert_allclose(tS[q].numpy(), np.asarray(jS[q]), atol=1e-12)

    def rec(U, S, V):
        Ud = np.asarray(U.to_dense())
        Ud = Ud.reshape(-1, Ud.shape[-1])
        s = np.concatenate([np.asarray(S[q]) for q, _ in U.legs[-1].charges])
        Vd = np.asarray(V.to_dense())
        return (Ud * s) @ Vd.reshape(Vd.shape[0], -1)

    np.testing.assert_allclose(rec(tU, tS, tV), rec(jU, jS, jV), atol=1e-12)


def test_fixed_forms_match_jax_elementwise():
    """The frozen decompositions gauge-fix their vectors, so the isometries
    agree elementwise (tolerance 1e-10).  The JAX forms run compiled, as the
    frozen engine runs them (one program, not one per sector operation)."""
    jm = _hermitian_corner(np.random.RandomState(8))
    keep = dict(j_tensor.eigh_blockwise(jm, (0, 1, 2), (3, 4, 5), chi=5)[0].legs[-1].charges)
    jU, jW = jax.jit(lambda x: j_frozen.eigh_blockwise_fixed(x, (0, 1, 2), (3, 4, 5), keep))(
        jm.to_backend("jnp"))
    tU, tW = t_frozen.eigh_blockwise_fixed(port(jm), (0, 1, 2), (3, 4, 5), keep)
    assert_same_blocks(jU, tU, 1e-10)
    for q in jW:
        np.testing.assert_allclose(tW[q].numpy(), np.asarray(jW[q]), atol=1e-10)
    ja = jrandom(np.random.RandomState(9), (1, -1, 1, -1), (D2, AUX, D2, AUX), 1)
    keep = dict(j_tensor.svd_blockwise(ja, (0, 1), (2, 3), chi=4)[0].legs[-1].charges)
    jU, jS, jV = jax.jit(lambda x: j_frozen.svd_blockwise_fixed(x, (0, 1), (2, 3), keep))(
        ja.to_backend("jnp"))
    tU, tS, tV = t_frozen.svd_blockwise_fixed(port(ja), (0, 1), (2, 3), keep)
    assert_same_blocks(jU, tU, 1e-10)
    assert_same_blocks(jV, tV, 1e-10)


@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_json_round_trip_bit_identical(tmp_path, direction):
    ja = jrandom(np.random.RandomState(10), (1,) * 5, (PHYS,) + (AUX,) * 4, 1)
    path = str(tmp_path / "state.json")
    if direction == "port_reads_jax":
        j_io.write_ipeps_abelian(J_IPEPS_ABELIAN("U1", {(0, 0): ja}), path)
        back = t_io.read_ipeps_abelian(path).site((0, 0))
    else:
        t_io.write_ipeps_abelian(t_io.IPEPS_ABELIAN("U1", {(0, 0): port(ja)}), path)
        back = j_io.read_ipeps_abelian(path).site((0, 0))
    assert_same_blocks(ja, back, 0)
    # the written files are the same bytes
    other = str(tmp_path / "other.json")
    t_io.write_ipeps_abelian(t_io.read_ipeps_abelian(path), other)
    j_io.write_ipeps_abelian(j_io.read_ipeps_abelian(path), path)
    assert open(other).read() == open(path).read()


def test_convert_abelian_round_trip_is_exact():
    ja = _site(np.random.RandomState(11), fermionic=True)
    sym, sig, legs, pshifts, n, ferm, blocks = abelian_to_numpy(port(ja))
    assert (sym, sig, n, ferm) == (ja.sym, ja.signature, ja.n, ja.fermionic)
    assert list(legs) == [l.charges for l in ja.legs] and list(pshifts) == [1, 0, 0, 0, 0]
    for q, b in ja.blocks.items():
        np.testing.assert_array_equal(blocks[q], np.asarray(b))
    env = env_c4v_abelian_to_torch(7, spec(ja), spec(ja.conj()), device=CPU)
    chi, C, T = env_c4v_abelian_to_numpy(env)
    assert chi == 7 and C[1] == ja.signature and T[1] == ja.conj().signature
    for q, b in ja.blocks.items():
        np.testing.assert_array_equal(C[6][q], np.asarray(b))


def test_trace_scalar_matches_jax():
    rng = np.random.RandomState(14)
    for fermionic, sig in ((False, (1, -1)), (True, (-1, 1))):
        ja = jrandom(rng, sig, (D2, D2), 0, fermionic)
        assert abs(float(port(ja).trace_scalar()) - float(ja.trace_scalar())) < 1e-14


def test_plans_are_cached_by_structure():
    """A second tensordot over the same structures builds no plan."""
    ja = _site(np.random.RandomState(12))
    ta, tb = port(ja), port(_site(np.random.RandomState(13)))
    ta.tensordot(ta.conj(), ((0, 1), (0, 1)))
    misses = t_tensor.PLANS.misses
    out = tb.tensordot(tb.conj(), ((0, 1), (0, 1)))
    assert t_tensor.PLANS.misses == misses
    assert out.struct is ta.tensordot(ta.conj(), ((0, 1), (0, 1))).struct


def test_random_c4v_state_and_noise():
    """The port's random C4v state is A1-symmetric and normalized; noise from
    a seeded generator lands on every block and is reproducible."""
    from tpeps_torch.ipeps.ipeps_abelian import add_noise_abelian, random_c4v_abelian

    leg = t_tensor.leg
    st = random_c4v_abelian(torch.Generator().manual_seed(3), "U1", leg(PHYS), leg(AUX), 1)
    a = st.site((0, 0))
    assert abs(float(a.norm()) - 1.0) < 1e-14
    for axes in ((0, 1, 4, 3, 2), (0, 2, 3, 4, 1)):
        assert torch.allclose(a.transpose(axes).data, a.data, rtol=0, atol=1e-15)
    assert add_noise_abelian(a, torch.Generator(), 0.0) is a
    n1 = add_noise_abelian(a, torch.Generator().manual_seed(4), 0.1)
    n2 = add_noise_abelian(a, torch.Generator().manual_seed(4), 0.1)
    assert torch.equal(n1.data, n2.data) and n1.struct is a.struct
    assert bool(((n1.data - a.data).abs() > 0).all())
