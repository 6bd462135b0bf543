"""Fixed-structure (frozen) block-sparse decompositions (counterpart of
tpeps/sym/frozen.py): the per-sector kept dimensions are given
(``keep: {sector_charge: kept_dim}``), so every decomposition is a full
per-sector eigh/SVD sliced to ``keep[q]`` columns, with deterministic gauge
fixing, and the output structure does not depend on the data.

Part of K9: the sector matrices are gathered and the isometry scattered by
``block_permute`` (K8); the decompositions are cuSOLVER's (``eigh_desc``,
``svd_reg``); gauge fixing and the slices are plain torch.  Everything is
differentiable: the gathers and scatters through :func:`permute_flat`, the
decompositions through their regularized VJPs, and the gauge fixing takes
its pivots from detached values (the JAX package's ``stop_gradient``).
"""

from __future__ import annotations

import numpy as np

from ..kernels.blocksparse import PermuteTable
from ..linalg.eigh import eigh_desc, fix_eigvec_phase
from ..linalg.svd import fix_svd_signs, svd_reg
from .tensor import PLANS, AbelianTensor, _finish_svd, _isometry, _qscale, _rows_pshift, \
    _sector_matrices, leg, permute_flat


def _check_keep(keep, sector_mats, what):
    missing = [q for q in keep if q not in sector_mats]
    if missing:
        raise ValueError(
            f"frozen structure drift: sectors {missing} in keep but absent from the {what} — "
            "re-run the host (dynamic) CTMRG to refresh the frozen structure")
    for q, k in keep.items():
        if k > min(sector_mats[q][6].shape):
            raise ValueError(f"frozen keep[{q}]={k} exceeds the {what} sector size "
                             f"{tuple(sector_mats[q][6].shape)} — refresh the frozen structure")


def eigh_blockwise_fixed(t: AbelianTensor, row_axes, col_axes, keep: dict,
                         ad_decomp_reg: float = 1.0e-12):
    """Spectral decomposition of a hermitian AbelianTensor truncated to a
    frozen per-sector profile: one eigh for the self-paired sector, one SVD
    per +-q pair (the partner's isometry is the right-singular basis of the
    same block, gauge-linked by ``fix_svd_signs``).

    :return: ``(U, W_dict)`` as ``eigh_blockwise``'s.
    """
    plan, sector_mats = _sector_matrices(t, row_axes, col_axes)
    _check_keep(keep, sector_mats, "corner")
    cols, W_out, done = {}, {}, set()
    for qsec in sorted(keep):
        if qsec in done:
            continue
        M = sector_mats[qsec][6]
        k = keep[qsec]
        qneg = _qscale(t.sym, -1, qsec)
        if M.is_meta:  # a structure-only run: shapes, no decomposition
            for q in (qsec, qneg) if qneg in keep else (qsec,):
                R = sector_mats[q][6].shape[0]
                cols[q], W_out[q] = M.new_empty((R, keep[q])), M.new_empty((keep[q],))
                done.add(q)
        elif qneg == qsec:
            D, U = eigh_desc(0.5 * (M + M.mH), ad_decomp_reg)
            W_out[qsec] = D[:k]
            cols[qsec] = fix_eigvec_phase(U[:, :k])
            done.add(qsec)
        else:
            U, S, Vh = svd_reg(M, ad_decomp_reg)
            U, Vh = fix_svd_signs(U, Vh)
            W_out[qsec] = S[:k]
            cols[qsec] = U[:, :k]
            done.add(qsec)
            if qneg in keep:
                k2 = keep[qneg]
                W_out[qneg] = S[:k2]
                cols[qneg] = Vh[:k2, :].mH
                done.add(qneg)
    new_leg = leg(dict(keep), _rows_pshift(plan))
    return _isometry(t, plan, cols, new_leg), W_out


def svd_blockwise_fixed(t: AbelianTensor, row_axes, col_axes, keep: dict,
                        ad_decomp_reg: float = 1.0e-12):
    """Truncated SVD with a frozen per-sector profile (``svd_blockwise``'s
    return convention)."""
    plan, sector_mats = _sector_matrices(t, row_axes, col_axes)
    _check_keep(keep, sector_mats, "projector matrix")
    ucols, vrows, S_out = {}, {}, {}
    for qsec in sorted(keep):
        M, k = sector_mats[qsec][6], keep[qsec]
        if M.is_meta:  # a structure-only run: shapes, no decomposition
            ucols[qsec], S_out[qsec] = M.new_empty((M.shape[0], k)), M.new_empty((k,))
            vrows[qsec] = M.new_empty((k, M.shape[1]))
            continue
        U, S, Vh = svd_reg(M, ad_decomp_reg)
        U, Vh = fix_svd_signs(U, Vh)
        k = keep[qsec]
        S_out[qsec] = S[:k]
        ucols[qsec], vrows[qsec] = U[:, :k], Vh[:k, :]
    return _finish_svd(t, plan, ucols, S_out, vrows)


def reindex_like(t: AbelianTensor, ref: AbelianTensor) -> AbelianTensor:
    """``t`` on ``ref``'s exact block set and leg metadata: blocks missing
    from ``t`` are zero, blocks absent from ``ref`` are dropped (one
    ``block_permute`` through a table cached by the two structures)."""
    if t.struct is ref.struct:
        return AbelianTensor._flat(ref, ref.struct, t.data, dtype=t.data.dtype)
    src, dst = t.struct, ref.struct

    def build():
        pairs = [(src.index[k], j) for j, k in enumerate(dst.keys) if k in src.index]
        si = np.array([p[0] for p in pairs], dtype=np.int64)
        di = np.array([p[1] for p in pairs], dtype=np.int64)
        if any(src.shapes[i] != dst.shapes[j] for i, j in pairs):
            raise ValueError("reindex_like: a shared block has another shape")
        sizes = dst.sizes[di].reshape(-1, 1)
        ones = np.ones_like(sizes)
        return PermuteTable(src.offsets[si], dst.offsets[di], sizes, ones, ones), \
            len(pairs) < len(dst.keys)

    table, partial = PLANS.get_or(("reindex", src, dst), build)
    data = permute_flat(t.data, table, dst.numel, zero_fill=partial)
    return AbelianTensor._flat(ref, ref.struct, data, dtype=t.data.dtype)
