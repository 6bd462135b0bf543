"""Frozen-structure C4v abelian CTMRG, forward (counterpart of
tpeps/ctm/c4v_abelian/frozen.py; the implicit adjoint of
``converge_frozen`` comes with the abelian training path).

With the per-sector chi profile frozen (``keep``), every block structure of
the move is fixed, so every plan of it is built once and reused: each move
is the corner's ``block_gemm``s, the gather of its sector matrices, the
sector eigh/SVDs (cuSOLVER), the scatter of the isometry, the ``block_gemm``s
of C' and T' written straight into the frozen block sets of C and T, and
one ``frozen_commit`` (K9: symmetrize, normalize, distance, commit, loop
test).  cuSOLVER does not capture into a CUDA graph here, so the loop stays
on the host and reads the 4-byte ``done`` once a move.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ...kernels.frozen import frozen_commit, frozen_state
from ...sym.frozen import eigh_blockwise_fixed, reindex_like
from ...sym.tensor import AbelianTensor, PLANS, Struct, make_struct
from ..generic_abelian.components import c2x2_lu
from .env import ENV_C4V_ABELIAN, flip_signature

C_PARTNER, T_PARTNER = (1, 0), (3, 1, 2, 0)


def _move_raw(a, C, T, keep, ad_decomp_reg=1.0e-12, out_like=True, timers=None):
    """The frozen move up to its epilogue: ``(C', T')`` unsymmetrized and
    unnormalized, laid out in the block sets of ``C`` and ``T`` (when
    ``out_like``; else as produced)."""
    def phase(name):
        return timers.phase(name, a.device) if timers is not None else nullcontext()

    with phase("corner"):
        M = c2x2_lu(C, T, T.transpose((0, 3, 1, 2)), a)
    with phase("decomposition"):
        P, _W = eigh_blockwise_fixed(M, (0, 1, 2), (3, 4, 5), keep, ad_decomp_reg=ad_decomp_reg)
    with phase("absorb"):
        nC = P.conj().tensordot(M, ((0, 1, 2), (0, 1, 2)))
        nC = nC.tensordot(flip_signature(P), ((1, 2, 3), (0, 1, 2)),
                          out_like=C if out_like else None)
        Tf = flip_signature(T)
        af = flip_signature(a)
        z = P.tensordot(Tf, ((0,), (0,)))
        z = z.tensordot(af, ((0, 3), (1, 2)))
        z = z.tensordot(af.conj(), ((0, 2, 4), (1, 2, 0)))
        nT = z.tensordot(P, ((1, 2, 4), (0, 1, 2)), out_like=T if out_like else None)
    return nC, nT


def partner_index(struct: Struct, axes, device) -> torch.Tensor:
    """Per element of ``struct``'s flat layout, the flat index of the element
    that ``transpose(axes)`` puts there (-1 where that block is absent).
    ``axes`` must be an involution (C's (1, 0), T's (3, 1, 2, 0))."""

    def build():
        out = np.full(struct.numel, -1, dtype=np.int64)
        for b, (k, off, size) in enumerate(zip(struct.keys, struct.offsets, struct.sizes)):
            pb = struct.index.get(tuple(k[i] for i in axes))
            if pb is None:
                continue
            src = np.arange(int(struct.sizes[pb])).reshape(struct.shapes[pb]).transpose(axes)
            out[off:off + size] = struct.offsets[pb] + src.reshape(-1)
        return out

    host = PLANS.get_or(("partner", struct, tuple(axes)), build)
    return PLANS.get_or(("partner_dev", struct, tuple(axes), str(device)),
                        lambda: torch.from_numpy(host).to(device))


def move_frozen(a, C, T, keep, ad_decomp_reg: float = 1.0e-12):
    """One C4v move at the frozen sector profile ``keep``: the same corner
    and sublattice bookkeeping as ``ctm_move_sl``, truncation by
    ``eigh_blockwise_fixed``, symmetrized, normalized and reindexed onto the
    block sets of ``C`` and ``T`` (by ``frozen_commit`` on a scratch state).
    ``C`` and ``T`` must hold every block the move produces
    (:func:`close_structure`)."""
    nC, nT = _move_raw(a, C, T, dict(keep), ad_decomp_reg)
    st = frozen_state(C.data, T.data, 1, 0.0)
    frozen_commit(st, nC.data, nT.data, partner_index(C.struct, C_PARTNER, C.device),
                  partner_index(T.struct, T_PARTNER, T.device))
    return AbelianTensor._flat(C, C.struct, st.C), AbelianTensor._flat(T, T.struct, st.T)


def _grown(t: AbelianTensor, extra: AbelianTensor) -> AbelianTensor:
    """``t`` on the union of its blocks and ``extra``'s (zeros for the new ones)."""
    keys = list(t.struct.keys) + [k for k in extra.struct.keys if k not in t.struct.index]
    shapes = list(t.struct.shapes) + [extra.struct.shapes[extra.struct.index[k]]
                                      for k in keys[len(t.struct.keys):]]
    ref = AbelianTensor._flat(t, make_struct(t.struct.rank, t.struct.nsym, keys, shapes),
                              torch.empty(0, device="meta"))
    return reindex_like(t, ref)


def close_structure(a, C, T, keep, n_max: int = 6):
    """Grow the (C, T) block sets until they hold every block the frozen move
    produces, so that the move maps the sets into themselves.  The output
    block sets follow from the input ones alone: the move runs on ``meta``
    tensors (plans, no data, no launch), as the JAX package runs it under
    ``jax.eval_shape``; the symmetrization's block set is the union of the
    raw output's and its transpose partner's.  No arithmetic runs on a meta
    tensor (its first use imports torch's meta kernels, seconds).  Missing
    blocks are filled with zeros."""
    keep = dict(keep)
    am = a.to("meta")
    for _ in range(n_max):
        Cm, Tm = C.to("meta"), T.to("meta")
        nC, nT = _move_raw(am, Cm, Tm, keep, out_like=False)
        nC, nT = (nC, nC.transpose(C_PARTNER)), (nT, nT.transpose(T_PARTNER))
        if all(set(x.struct.keys) <= set(C.struct.keys) for x in nC) and \
                all(set(x.struct.keys) <= set(T.struct.keys) for x in nT):
            return C, T
        C, T = _grown(_grown(C, nC[0]), nC[1]), _grown(_grown(T, nT[0]), nT[1])
    raise RuntimeError("abelian env structure failed to close under the move")


def run_frozen(a, C, T, keep, max_iter: int = 200, conv_tol: float = 1.0e-10,
               ad_decomp_reg: float = 1.0e-12, timers=None):
    """Iterate the frozen move to the elementwise fixed point: the loop test
    on the card (``frozen_commit``), one 4-byte read of ``done`` per move.

    :param keep: frozen chi profile, ``{charge: dim}`` or ``((charge, dim), ...)``
    :param timers: optional :class:`~tpeps_torch.profiling.PhaseTimers`; gets
        the phases "corner", "decomposition", "absorb" and "commit" per move
    :return: ``(C*, T*, n_iter, dist2)``
    """
    kd = dict(keep)
    pC = partner_index(C.struct, C_PARTNER, C.device)
    pT = partner_index(T.struct, T_PARTNER, T.device)
    st = frozen_state(C.data, T.data, max_iter, conv_tol)
    Cs, Ts = AbelianTensor._flat(C, C.struct, st.C), AbelianTensor._flat(T, T.struct, st.T)
    while not bool(st.ctl[1]):
        nC, nT = _move_raw(a, Cs, Ts, kd, ad_decomp_reg, timers=timers)
        with timers.phase("commit", a.device) if timers is not None else nullcontext():
            frozen_commit(st, nC.data, nT.data, pC, pT)
    return (AbelianTensor._flat(C, C.struct, st.C.clone()),
            AbelianTensor._flat(T, T.struct, st.T.clone()), int(st.ctl[0]), float(st.dist2))


def freeze_from_env(env: ENV_C4V_ABELIAN):
    """The frozen chi profile of a (dynamically) converged env: the sector
    table of the corner's first leg, as a hashable tuple."""
    return tuple(sorted(env.C.legs[0].charges))


def converge_frozen(a, env: ENV_C4V_ABELIAN, keep=None, max_iter: int = 200,
                    conv_tol: float = 1.0e-10, ad_decomp_reg: float = 1.0e-12):
    """Converged environment from a warm (dynamic) env at a frozen profile:
    ``close_structure`` then ``run_frozen``.  Forward only: the implicit
    adjoint comes with the abelian training path, so an ``a`` that requires
    grad raises."""
    if a.data.requires_grad:
        raise NotImplementedError(
            "converge_frozen is forward-only in tpeps_torch: its implicit adjoint (abelian "
            "training, tpeps/optim/abelian.py) is not ported yet; pass a detached site")
    if keep is None:
        keep = freeze_from_env(env)
    C, T = close_structure(a, env.C, env.T, dict(keep))
    Cf, Tf, _, _ = run_frozen(a, C, T, keep, max_iter=max_iter, conv_tol=conv_tol,
                              ad_decomp_reg=ad_decomp_reg)
    return ENV_C4V_ABELIAN(env.chi, Cf, Tf)
