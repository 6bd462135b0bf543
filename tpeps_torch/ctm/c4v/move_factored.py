"""Factored C4v CTMRG move on the K1-K4 kernels (counterpart of
tpeps/ctm/c4v/move_tpu.py).

The same move as the JAX package's ``ctm_move_sl_tpu``: the edge is kept
in the internal layout ``T[k, b, chi0, chi1]`` (ket, bra, chi, chi), the
enlarged corner is never formed as a dense product of the environment
pieces but built layer by layer, and the projector comes from a
warm-started subspace iteration.  The kernels:

* K1 ``_c2x2_factored``: the corner as the matrix ``M2[(j,e,f),(i,r,g)]``
  (ket and bra layers: :func:`~tpeps_torch.kernels.layer.layer_contract`);
* K2 ``_m_apply``: ``Y = M2 @ P`` (:func:`~tpeps_torch.kernels.corner.corner_apply`);
* K3 ``_subspace_eigh_op``: CholeskyQR2 on
  :mod:`tpeps_torch.kernels.cholqr`, Rayleigh-Ritz with a cuSOLVER eigh;
* K4 ``_absorb_T_int`` (layers on ``layer_contract``) and its epilogue
  (:func:`~tpeps_torch.kernels.epilogue.t_epilogue`).

The chi-contractions around the layers (C.T_top, T_left.ct, T.P and the
closing conj(P)) are plain large matrix products and stay ``torch.matmul``.
Forward only: the move and ``run_ctmrg`` run under ``torch.inference_mode()``.
"""

from __future__ import annotations

import contextlib
from functools import partial

import numpy as np
import torch

from ...kernels.corner import corner_apply
from ...kernels.epilogue import t_epilogue
from ...kernels.layer import layer_contract
from ...linalg.eigh import eigh_desc, multiplet_mask
from ...linalg.power import cholesky_qr2, cold_start_basis, procrustes_align
from .env import EnvC4v


def to_int_layout(T, D: int):
    """Public ``T[chi0, chi1, D^2]`` -> internal ``T[k, b, chi0, chi1]``."""
    chi = T.shape[0]
    return T.reshape(chi, chi, D, D).permute(2, 3, 0, 1).contiguous()


def from_int_layout(T_int):
    """Internal ``T[k, b, chi0, chi1]`` -> public ``T[chi0, chi1, D^2]``."""
    D, _, chi, _ = T_int.shape
    return T_int.permute(2, 3, 0, 1).reshape(chi, chi, D * D)


def _double_layer(a, X6, out, slice_phys: bool):
    """``out[f,g,e,r,j,i] = sum conj(a)[s,v,m,f,g] a[s,u,l,e,r] X6[l,m,j,u,v,i]``
    through two layer_contract launches (ket, then bra) per physical slice.

    ``X6`` is any strided (l,m,j,u,v,i) tensor; ``out`` is a view in
    (f,g,e,r,j,i) order of the caller's output buffer, so the bra launch
    writes the caller's layout directly.
    """
    d, D = a.shape[0], a.shape[1]
    _, _, nj, _, _, ni = X6.shape
    Xk = X6.permute(3, 0, 1, 2, 4, 5)  # (u,l) | (m,j,v,i)
    if not slice_phys:
        Wk = a.permute(0, 3, 4, 1, 2).reshape(d * D * D, D * D).contiguous()  # (s,e,r) x (u,l)
        q = torch.empty((d, D, D, D, nj, D, ni), dtype=a.dtype, device=a.device)
        layer_contract(Wk, Xk, q, n_k=2)  # q[s,e,r,m,j,v,i]
        Wb = a.conj().permute(3, 4, 0, 1, 2).reshape(D * D, d * D * D).contiguous()
        layer_contract(Wb, q.permute(0, 5, 3, 1, 2, 4, 6), out, n_k=3)  # (s,v,m) | (e,r,j,i)
        return out
    qs = torch.empty((D, D, D, nj, D, ni), dtype=a.dtype, device=a.device)
    for s in range(d):
        # a[s] is (u,l,e,r) for the ket and (v,m,f,g) for the bra
        Wk = a[s].permute(2, 3, 0, 1).reshape(D * D, D * D).contiguous()
        layer_contract(Wk, Xk, qs, n_k=2)  # qs[e,r,m,j,v,i]
        Wb = a[s].conj().permute(2, 3, 0, 1).reshape(D * D, D * D).contiguous()
        layer_contract(Wb, qs.permute(4, 2, 0, 1, 3, 5), out, n_k=2, accumulate=s > 0)
    return out


def _c2x2_factored(a, C, T_int, slice_phys: bool = False):
    """K1: the enlarged corner as the matrix ``M2[(j,e,f),(i,r,g)]``
    (rows: down-chi, ket, bra; cols: right-chi, ket, bra), which is
    ``M6[f,g,e,r,j,i]`` of the JAX package with its axes permuted."""
    D = a.shape[1]
    chi = C.shape[0]
    # top edge (chi0=i right, chi1=y left): ct[x,(u,v,i)] = C[x,y] Tt[u,v,i,y]
    ct = C @ T_int.permute(3, 0, 1, 2).reshape(chi, D * D * chi)
    # left edge (chi0=x up, chi1=j down): q1[(l,m,j),(u,v,i)]
    q1 = T_int.permute(0, 1, 3, 2).reshape(D * D * chi, chi) @ ct
    M2 = torch.empty((chi, D, D, chi, D, D), dtype=a.dtype, device=a.device)  # j,e,f,i,r,g
    _double_layer(a, q1.view(D, D, chi, D, D, chi), M2.permute(2, 5, 1, 4, 0, 3), slice_phys)
    return M2.view(chi * D * D, chi * D * D)


def _m_apply(M2, P):
    """K2: ``Y = M2 @ P`` with P rows (i,r,g) and Y rows (j,e,f)."""
    return corner_apply(M2, P)


def _subspace_eigh_op(m_apply, P0, chi: int, n_power: int,
                      eps_multiplet: float, ad_decomp_reg: float):
    """K3: warm-started subspace iteration with CholeskyQR2 and a
    Rayleigh-Ritz step; returns the multiplet-masked ``(D, P)``."""
    n = P0.shape[0]
    colnorm = torch.linalg.vector_norm(P0, dim=0)
    fallback = torch.eye(n, chi, dtype=P0.dtype, device=P0.device)
    P = torch.where(colnorm[None, :] > 1e-12, P0, fallback)
    P = cholesky_qr2(P)
    for _ in range(n_power):
        P = cholesky_qr2(m_apply(P))
    Y = m_apply(P)
    H = P.mH @ Y
    H = 0.5 * (H + H.mH)
    Dv, U = eigh_desc(H, ad_decomp_reg)
    P = P @ U
    Dpad = torch.cat([Dv, Dv.new_zeros(1)])
    mask = multiplet_mask(Dpad, chi, eps_multiplet=eps_multiplet)
    return Dv * mask, P * mask[None, :].to(P.dtype)


def _absorb_T_int(a, T_int, P, chi: int, chi_n: int, slice_phys: bool = False):
    """K4 body: ``T' = P^H (T a a*) P`` in internal layout ``T'[k,b,chi',chi']``
    (before the epilogue)."""
    D = a.shape[1]
    # z1[(l,m,d),(u,v,p)] = T[l,m,c,d] P[(c,u,v),p]
    z1 = T_int.permute(0, 1, 3, 2).reshape(D * D * chi, chi) @ P.reshape(chi, D * D * chi_n)
    # Z[(d,e,f),(r,g,p)]: rows match P's rows (c,u,v) for the closing product
    Z = torch.empty((chi, D, D, D, D, chi_n), dtype=a.dtype, device=a.device)  # d,e,f,r,g,p
    _double_layer(a, z1.view(D, D, chi, D, D, chi_n), Z.permute(2, 4, 1, 3, 0, 5), slice_phys)
    # nT[(r,g,p), q] = Z^T conj(P): internal layout (k=r, b=g, top=p, bottom=q)
    nT = Z.view(chi * D * D, D * D * chi_n).transpose(0, 1) @ P.conj()
    return nT.view(D, D, chi_n, chi_n)


@torch.inference_mode()
def ctm_move_sl_factored(
    a,
    C,
    T_int,
    P_ref,
    *,
    n_power: int = 2,
    eps_multiplet: float = 1.0e-12,
    ad_decomp_reg: float = 1.0e-12,
    absorb_normalization: str = "inf",
    slice_phys: bool = False,
):
    """One C4v move in internal layout.  Returns ``(C', T'_int, spec, P)``.

    ``slice_phys`` runs the two layers once per physical index and
    accumulates, which halves the largest intermediate at d=2.
    """
    chi = C.shape[0]
    M2 = _c2x2_factored(a, C, T_int, slice_phys=slice_phys)
    Dspec, P = _subspace_eigh_op(partial(_m_apply, M2), P_ref, chi, n_power,
                                 eps_multiplet, ad_decomp_reg)
    del M2
    cmask = Dspec.abs() > 0
    P, W = procrustes_align(P, P_ref, col_mask=cmask)
    spec = Dspec / Dspec[0].abs()
    nC = (W.mH * spec.to(C.dtype)[None, :]) @ W
    nT = _absorb_T_int(a, T_int, P, chi, chi, slice_phys=slice_phys)
    nT = t_epilogue(nT, absorb_normalization)
    return nC, nT, spec, P


@torch.inference_mode()
def run_ctmrg(
    a,
    env: EnvC4v,
    *,
    max_iter: int = 100,
    conv_tol: float = 1.0e-8,
    n_power: int = 2,
    slice_phys: bool = False,
    timers=None,
    stall_window: int = 0,
    P0=None,
    **move_kwargs,
):
    """Host-driven CTMRG loop over :func:`ctm_move_sl_factored`
    (counterpart of ``run_ctmrg_tpu``, move_tpu.py:337-450).

    Convergence is the 2-norm distance between consecutive normalized
    corner spectra (|spec|), read to the host after every move.

    :param timers: optional :class:`tpeps_torch.profiling.PhaseTimers`
        accumulating the "move" and "conv_check" phases
    :param stall_window: if > 0, stop early when the spectra distance has
        not improved by 30% for this many consecutive checks
    :param P0: optional warm-start subspace basis ``(chi D^2, chi)``
    :return: ``(env, n_iter, dist, P)``; ``P`` is the final projector basis,
        reusable as the next call's ``P0``
    :raises RuntimeError: if a move yields a non-finite corner spectrum
    """
    def phase(name):
        if timers is None:
            return contextlib.nullcontext()
        return timers.phase(name, device=a.device)

    D = a.shape[1]
    chi = env.C.shape[0]
    T_int = to_int_layout(env.T, D)
    if P0 is not None:
        P = torch.as_tensor(P0, dtype=env.C.dtype, device=env.C.device).contiguous()
    else:
        P = cold_start_basis(chi * D * D, chi, env.C.dtype, env.C.device)
    C = env.C
    spec_prev = None
    dist = float("inf")
    best_dist = float("inf")
    no_improve = 0
    it = 0
    for it in range(1, max_iter + 1):
        with phase("move"):
            C, T_int, spec, P = ctm_move_sl_factored(
                a, C, T_int, P, n_power=n_power, slice_phys=slice_phys, **move_kwargs)
        with phase("conv_check"):
            spec_h = np.abs(spec.cpu().numpy())
        if not np.isfinite(spec_h).all():
            raise RuntimeError(f"CTMRG corner spectrum non-finite at iteration {it}")
        if spec_prev is not None:
            dist = float(np.linalg.norm(spec_h - spec_prev))
            if dist < conv_tol:
                break
            if stall_window > 0:
                if dist < 0.7 * best_dist:
                    best_dist = dist
                    no_improve = 0
                else:
                    no_improve += 1
                    if no_improve >= stall_window:
                        break
        spec_prev = spec_h
    return EnvC4v(C, from_int_layout(T_int)), it, dist, P
