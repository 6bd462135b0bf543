"""C4v single-layer CTMRG in the reference layout: the differentiable move,
the host-driven fixed-point loop and the two ways a gradient crosses it
(counterpart of tpeps/ctm/c4v/ctmrg.py).

* ``ctm_move_sl``: one move ``(a, C, T) -> (C', T', spec, P)`` with the
  SYMEIG, POWER or QR projector; autograd flows through it.  The enlarged
  corner is built layer by layer as fused-dimension matrix products
  (``torch.matmul``, cuBLAS on the card).  The POWER projector's CholeskyQR
  and the Procrustes alignment run on the K3 and K6 kernels.
* ``run_fixed_point``: CTMRG to convergence without a graph, one host read
  of the distance per move.
* ``converge_env``: implicit differentiation of the fixed point (the
  adjoint solved by a Neumann series of move VJPs over one retained graph)
  or a checkpointed window of moves (``torch.utils.checkpoint``).

Index conventions follow :mod:`tpeps_torch.ctm.c4v.env`.
"""

from __future__ import annotations

import logging
import time
import warnings
from functools import partial
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ...linalg.eigh import fix_eigvec_phase, truncated_eigh_sym
from ...linalg.power import cold_start_basis, procrustes_align, subspace_eigh
from .env import EnvC4v

log = logging.getLogger(__name__)


def _ct_tl(a, C, T):
    """Shared C-Ttop-Tleft prefix as ``q[(j,m,v,i), (u,l)]`` ready for the
    ket-layer matmul."""
    chi = C.shape[0]
    D = a.shape[1]
    # ct[x, (u,v,i)] = C[x,y] Ttop[y,(u,v,i)]; top T stored [i,y,u,v]
    Tt = T.reshape(chi, chi, D, D).permute(1, 2, 3, 0).reshape(chi, D * D * chi)
    ct = C @ Tt
    # q[(j,l,m),(u,v,i)] = Tl[x,(j,l,m)]^T ct[x,(u,v,i)]
    Tl = T.reshape(chi, chi * D * D)
    q = Tl.transpose(0, 1) @ ct
    q = q.reshape(chi, D, D, D, D, chi)  # j,l,m,u,v,i
    return q.permute(0, 2, 4, 5, 3, 1).reshape(chi * D * D * chi, D * D)


def c2x2_sl(a, C, T):
    """Single-layer enlarged upper-left corner as a (chi D^2, chi D^2) matrix:
    rows (down-chi, down-ket, down-bra), columns (right-chi, right-ket,
    right-bra)."""
    chi = C.shape[0]
    D = a.shape[1]
    d = a.shape[0]
    q = _ct_tl(a, C, T)  # [(j,m,v,i),(u,l)]
    a_k = a.permute(1, 2, 0, 3, 4).reshape(D * D, d * D * D)
    q = q @ a_k  # [(j,m,v,i),(s,e,r)]
    q = q.reshape(chi, D, D, chi, d, D, D)  # j,m,v,i,s,e,r
    q = q.permute(0, 3, 5, 6, 1, 2, 4).reshape(chi * chi * D * D, D * D * d)
    a_b = a.conj().permute(2, 1, 0, 3, 4).reshape(D * D * d, D * D)
    q = q @ a_b  # [(j,i,e,r),(f,g)]
    q = q.reshape(chi, chi, D, D, D, D)  # j,i,e,r,f,g
    return q.permute(0, 2, 4, 1, 3, 5).reshape(chi * D * D, chi * D * D)


def open_c2x2_sl(a, C, T):
    """Enlarged upper-left corner with open physical indices:
    ``[(down-chi, dk, db), (right-chi, rk, rb), s, s']`` with ``s`` from the
    ket (non-conjugated) layer."""
    chi = C.shape[0]
    D = a.shape[1]
    d = a.shape[0]
    q = _ct_tl(a, C, T)
    a_k = a.permute(1, 2, 0, 3, 4).reshape(D * D, d * D * D)
    q = q @ a_k
    # bra layer keeping both physical indices open: contract (m,v) only
    q = q.reshape(chi, D, D, chi, d, D, D)  # j,m,v,i,s,e,r
    q = q.permute(0, 3, 4, 5, 6, 1, 2).reshape(chi * chi * d * D * D, D * D)
    a_b = a.conj().permute(2, 1, 0, 3, 4).reshape(D * D, d * D * D)
    q = q @ a_b  # [(j,i,s,e,r),(z,f,g)]
    q = q.reshape(chi, chi, d, D, D, d, D, D)  # j,i,s,e,r,z,f,g
    return q.permute(0, 3, 6, 1, 4, 7, 2, 5).reshape(chi * D * D, chi * D * D, d, d)


def _absorb_T(a, T, P4):
    """Renormalized half-row tensor ``T' = P^H (T a a*) P``, layer by layer,
    hermitian-symmetrized over its two environment indices."""
    chi = T.shape[0]
    D = a.shape[1]
    d = a.shape[0]
    chi_n = P4.shape[-1]
    # z[(u,v,p),(d,l,m)] = P[c,(u,v,p)]^T T[c,(d,l,m)]
    z = P4.reshape(chi, D * D * chi_n).transpose(0, 1) @ T.reshape(chi, chi * D * D)
    z = z.reshape(D, D, chi_n, chi, D, D)  # u,v,p,d,l,m
    z = z.permute(1, 2, 3, 5, 0, 4).reshape(D * chi_n * chi * D, D * D)
    a_k = a.permute(1, 2, 0, 3, 4).reshape(D * D, d * D * D)
    z = z @ a_k  # [(v,p,d,m),(s,e,r)]
    z = z.reshape(D, chi_n, chi, D, d, D, D)  # v,p,d,m,s,e,r
    z = z.permute(1, 2, 5, 6, 3, 0, 4).reshape(chi_n * chi * D * D, D * D * d)
    a_b = a.conj().permute(2, 1, 0, 3, 4).reshape(D * D * d, D * D)
    z = z @ a_b  # [(p,d,e,r),(f,g)]
    z = z.reshape(chi_n, chi, D, D, D, D)  # p,d,e,r,f,g
    z = z.permute(0, 3, 5, 1, 2, 4).reshape(chi_n * D * D, chi * D * D)
    nT = z @ P4.conj().reshape(chi * D * D, chi_n)  # [(p,r,g), q]
    nT = nT.reshape(chi_n, D * D, chi_n).permute(0, 2, 1)  # p,q,(r,g)
    return 0.5 * (nT + nT.permute(1, 0, 2).conj())


def fix_phase_continuity(P, P_ref):
    """Phase-fix projector columns against a reference projector: each
    column's overlap with its reference column made real positive; columns
    with ~zero overlap fall back to the pivot gauge."""
    ov = (P_ref.conj() * P).sum(dim=0)
    if P.is_complex():
        phase = ov / torch.clamp(ov.abs(), min=1e-300)
    else:
        phase = torch.sign(ov)
    P_pivot = fix_eigvec_phase(P)
    small = ov.detach().abs() < 1e-12
    return torch.where(small[None, :], P_pivot, P * phase.conj()[None, :])


def ctm_move_sl(
    a,
    env: EnvC4v,
    P_ref=None,
    *,
    keep_multiplets: bool = True,
    eps_multiplet: float = 1.0e-12,
    ad_decomp_reg: float = 1.0e-12,
    absorb_normalization: str = "inf",
    sg_norm: bool = True,
    gauge_fix: bool = True,
    projector_method: str = "SYMEIG",
    n_power: int = 2,
):
    """One C4v CTMRG move: enlarged corner, truncated projector ``P``,
    ``C' = diag(spec)`` (rotated by the Procrustes ``W``), ``T' = P^H (T a
    a*) P``, normalized.

    :param P_ref: previous/converged projector for the continuity gauge;
        ``None`` uses the pivot gauge
    :param sg_norm: treat the normalization scales as constants under
        autograd; the implicit adjoint uses ``False`` so the differentiated
        map is exactly the iterated one
    :param projector_method: "SYMEIG" (dense eigh), "POWER" (warm-started
        subspace iteration on the K3/K6 kernels) or "QR" (half-corner QR)
    :return: ``(EnvC4v(C', T'), spec, P)``
    """
    C, T = env
    chi = C.shape[0]
    D = a.shape[1]

    M = c2x2_sl(a, C, T)
    M = 0.5 * (M + M.mH)
    if projector_method == "QR":
        C1x2 = torch.tensordot(C, T, dims=([1], [1]))  # (x, w, D^2)
        C1x2 = C1x2.permute(0, 2, 1).reshape(chi * D * D, chi)
        P, _ = torch.linalg.qr(C1x2)
        if gauge_fix:
            P = fix_eigvec_phase(P) if P_ref is None else procrustes_align(P, P_ref)[0]
        nC = P.mH @ (M @ P)
        nC = 0.5 * (nC + nC.mH)
        Dspec = torch.linalg.eigvalsh(nC)
        Dspec = Dspec[torch.argsort(-Dspec.abs(), stable=True)]
        scale_C = Dspec[0].abs()
        if sg_norm:
            scale_C = scale_C.detach()
        spec = Dspec / scale_C
        nC = nC / scale_C
        nT = _absorb_T(a, T, P.reshape(chi, D, D, chi))
        scale_T = nT.abs().max() if absorb_normalization == "inf" else torch.linalg.vector_norm(nT)
        if sg_norm:
            scale_T = scale_T.detach()
        return EnvC4v(nC, nT / scale_T), spec, P
    if projector_method == "POWER":
        P0 = P_ref if P_ref is not None else cold_start_basis(M.shape[0], chi, M.dtype, M.device)
        Dspec, P = subspace_eigh(M, P0, n_power=n_power, keep_multiplets=keep_multiplets,
                                 eps_multiplet=eps_multiplet, ad_decomp_reg=ad_decomp_reg)
    elif projector_method == "SYMEIG":
        Dspec, P = truncated_eigh_sym(M, chi, keep_multiplets=keep_multiplets,
                                      ad_decomp_reg=ad_decomp_reg, eps_multiplet=eps_multiplet)
    else:
        raise ValueError(f"Unsupported projector_method {projector_method}")
    W = None
    if gauge_fix:
        if P_ref is None:
            P = fix_eigvec_phase(P)
        else:
            # full-basis Procrustes continuity: pins phases and rotations
            # inside degenerate multiplets, block-diagonal w.r.t. the
            # multiplet-safe truncation
            cmask = Dspec.detach().abs() > 0
            P, W = procrustes_align(P, P_ref, col_mask=cmask)

    scale_C = Dspec[0].abs()
    if sg_norm:
        scale_C = scale_C.detach()
    spec = Dspec / scale_C
    if W is None:
        nC = torch.diag(spec.to(C.dtype))
    else:
        nC = (W.mH * spec.to(C.dtype)[None, :]) @ W
    nT = _absorb_T(a, T, P.reshape(chi, D, D, chi))
    scale_T = nT.abs().max() if absorb_normalization == "inf" else torch.linalg.vector_norm(nT)
    if sg_norm:
        scale_T = scale_T.detach()
    return EnvC4v(nC, nT / scale_T), spec, P


@torch.no_grad()
def run_fixed_point(
    a,
    env: EnvC4v,
    *,
    max_iter: int = 50,
    conv_tol: float = 1.0e-8,
    keep_multiplets: bool = True,
    eps_multiplet: float = 1.0e-12,
    ad_decomp_reg: float = 1.0e-12,
    absorb_normalization: str = "inf",
    conv_on: str = "spec",
    projector_method: str = "SYMEIG",
    n_power: int = 2,
):
    """CTMRG to convergence without a graph: a host loop over moves in the
    continuity gauge (the previous projector is carried and each new one is
    aligned to it), so the environment converges elementwise.

    Convergence, read to the host after every move:

    * ``conv_on="spec"``: l2 distance of successive normalized corner spectra
      (|spec|), gauge-invariant;
    * ``conv_on="env"``: max-norm distance of successive (C, T) elementwise,
      as the implicit adjoint needs.

    A non-finite distance counts as infinite.

    :return: ``(env, n_iter, dist, P)`` with ``P`` the last projector (the
        gauge reference of the implicit adjoint)
    """
    move = partial(
        ctm_move_sl, keep_multiplets=keep_multiplets, eps_multiplet=eps_multiplet,
        ad_decomp_reg=ad_decomp_reg, absorb_normalization=absorb_normalization,
        sg_norm=True, gauge_fix=True, projector_method=projector_method, n_power=n_power)
    chi = env.C.shape[0]
    D = a.shape[1]
    # full-rank gauge reference: the Procrustes alignment needs a
    # non-degenerate overlap with the first projector
    P = cold_start_basis(chi * D * D, chi, env.C.dtype, env.C.device)
    spec_prev = None
    dist = float("inf")
    n_iter = 0
    while n_iter < max_iter and dist > conv_tol:
        env2, spec, P = move(a, env, P)
        if conv_on == "env":
            d = torch.maximum((env2.C - env.C).abs().max(), (env2.T - env.T).abs().max())
        elif spec_prev is None:
            d = torch.full((), float("inf"), dtype=spec.real.dtype, device=spec.device)
        else:
            d = torch.linalg.vector_norm(spec.abs() - spec_prev)
        dist = float(d)
        if dist != dist or dist == float("inf"):  # NaN or inf
            dist = float("inf")
        env, spec_prev = env2, spec.abs()
        n_iter += 1
    return env, n_iter, dist, P


class ImplicitSettings(NamedTuple):
    """Static settings of the implicit fixed-point gradient."""

    keep_multiplets: bool = True
    eps_multiplet: float = 1.0e-12
    ad_decomp_reg: float = 1.0e-12
    absorb_normalization: str = "inf"
    max_iter: int = 50
    conv_tol: float = 1.0e-8
    adjoint_max_iter: int = 100
    adjoint_tol: float = 1.0e-8
    projector_method: str = "SYMEIG"
    n_power: int = 2


def _norm2(ts):
    return sum(float(torch.vdot(t.reshape(-1), t.reshape(-1)).real) for t in ts)


class _ConvergeImplicit(torch.autograd.Function):
    """Forward: the fixed point without a graph.  Backward: the adjoint
    fixed-point equation ``u = (df/denv)^T u + ybar`` by Neumann iteration,
    accumulating ``abar = sum_k (df/da)^T u_k`` from one move graph built at
    the fixed point and kept (``retain_graph=True``).

    The series converges only where the move's Jacobian is contracting;
    near criticality it can diverge.  The loop stops once ``||u||`` has
    grown twice in a row and warns: a silently wrong gradient becomes a
    loudly truncated one.  Use ``grad_mode="scan"`` near criticality.
    """

    @staticmethod
    def forward(ctx, a, C0, T0, cfg: ImplicitSettings, stats):
        t0 = time.perf_counter()
        env, n_iter, dist, P = run_fixed_point(
            a.detach(), EnvC4v(C0.detach(), T0.detach()), max_iter=cfg.max_iter,
            conv_tol=cfg.conv_tol, keep_multiplets=cfg.keep_multiplets,
            eps_multiplet=cfg.eps_multiplet, ad_decomp_reg=cfg.ad_decomp_reg,
            absorb_normalization=cfg.absorb_normalization, conv_on="env",
            projector_method=cfg.projector_method, n_power=cfg.n_power)
        ctx.save_for_backward(a, env.C, env.T, P)
        ctx.cfg, ctx.stats = cfg, stats
        if stats is not None:
            stats.update(fwd_moves=n_iter, fwd_dist=dist, t_fwd=time.perf_counter() - t0)
        return env.C, env.T

    @staticmethod
    def backward(ctx, gC, gT):
        t0 = time.perf_counter()
        a, C, T, P_star = ctx.saved_tensors
        cfg = ctx.cfg
        with torch.enable_grad():
            a_ = a.detach().requires_grad_()
            C_ = C.detach().requires_grad_()
            T_ = T.detach().requires_grad_()
            # the move in the converged continuity gauge: the gauge reference
            # is the fixed-point projector itself, held constant
            env2, _, _ = ctm_move_sl(
                a_, EnvC4v(C_, T_), P_star.detach(), keep_multiplets=cfg.keep_multiplets,
                eps_multiplet=cfg.eps_multiplet, ad_decomp_reg=cfg.ad_decomp_reg,
                absorb_normalization=cfg.absorb_normalization, sg_norm=False, gauge_fix=True,
                projector_method=cfg.projector_method, n_power=cfg.n_power)
        outs = (env2.C, env2.T)
        u = (torch.zeros_like(C) if gC is None else gC, torch.zeros_like(T) if gT is None else gT)
        cot_norm = _norm2(u)
        stop = cfg.adjoint_tol ** 2 * cot_norm
        da = torch.zeros_like(a)
        delta, grew, n_adj = cot_norm, 0, 0
        while n_adj < cfg.adjoint_max_iter and delta > stop and grew < 2:
            da_i, uC, uT = torch.autograd.grad(outs, (a_, C_, T_), grad_outputs=u,
                                               retain_graph=True)
            da = da + da_i
            u = (uC, uT)
            delta_next = _norm2(u)
            grew = grew + 1 if delta_next > delta else 0
            delta = delta_next
            n_adj += 1
        diverged = grew >= 2 and delta > stop
        if diverged:
            msg = (f"implicit CTMRG adjoint diverging (|u| grew twice, iter {n_adj}, "
                   f"|u|^2={delta:.3e}); gradient truncated - use grad_mode='scan'")
            log.warning(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        if ctx.stats is not None:
            ctx.stats.update(adj_iters=n_adj, adj_diverged=diverged,
                             t_adj=time.perf_counter() - t0)
        return da, None, None, None, None


def _cfg_projector(ctm_cfg):
    """``(projector_method, n_power)`` from the CTM settings: DEFAULT/SYMEIG
    (dense symmetric eigh), POWER (warm-started subspace iteration) or QR."""
    method = ctm_cfg.projector_svd_method
    if method in ("DEFAULT", "SYMEIG"):
        method = "SYMEIG"
    elif method not in ("POWER", "QR"):
        raise ValueError(f"Unsupported projector_svd_method {method}")
    return method, getattr(ctm_cfg, "n_power", 2)


def converge_env(a, env: EnvC4v, ctm_cfg, stats: dict | None = None) -> EnvC4v:
    """Differentiable converged environment with the strategy selected by
    ``ctm_cfg.grad_mode`` ("implicit" or "scan", see
    :class:`tpeps_torch.config.CtmArgs`).

    :param stats: optional dict; the implicit mode records in it the forward
        moves and distance, the adjoint iterations, whether the divergence
        guard fired, and the seconds of both halves
    """
    method, n_power = _cfg_projector(ctm_cfg)
    if ctm_cfg.grad_mode == "implicit":
        # the adjoint differentiates the decompositions at the fixed point,
        # where exact multiplets make weakly regularized gap inverses
        # explode; the regularizer conditions only the gradient, so floor it
        cfg = ImplicitSettings(
            True, 1.0e-12, max(ctm_cfg.ad_decomp_reg, ctm_cfg.grad_adjoint_decomp_reg),
            ctm_cfg.ctm_absorb_normalization, ctm_cfg.ctm_max_iter, ctm_cfg.ctm_conv_tol,
            ctm_cfg.grad_adjoint_max_iter, ctm_cfg.grad_adjoint_tol, method, n_power)
        C, T = _ConvergeImplicit.apply(a, env.C, env.T, cfg, stats)
        return EnvC4v(C, T)
    if ctm_cfg.grad_mode == "scan":
        e0, *_ = run_fixed_point(
            a.detach(), env, max_iter=ctm_cfg.ctm_max_iter, conv_tol=ctm_cfg.ctm_conv_tol,
            ad_decomp_reg=ctm_cfg.ad_decomp_reg,
            absorb_normalization=ctm_cfg.ctm_absorb_normalization,
            projector_method=method, n_power=n_power)
        return run_scan(a, EnvC4v(e0.C.detach(), e0.T.detach()), ctm_cfg.grad_tail_iter, ctm_cfg)
    raise ValueError(f"Unknown grad_mode {ctm_cfg.grad_mode}")


def run_scan(a, env: EnvC4v, n_iter: int, ctm_cfg) -> EnvC4v:
    """Differentiable fixed window of ``n_iter`` moves, each recomputed in
    the backward pass (``torch.utils.checkpoint``), so memory is one
    environment plus one move whatever ``n_iter``."""
    method, n_power = _cfg_projector(ctm_cfg)
    move = partial(
        ctm_move_sl, ad_decomp_reg=ctm_cfg.ad_decomp_reg,
        absorb_normalization=ctm_cfg.ctm_absorb_normalization,
        sg_norm=True, gauge_fix=True, projector_method=method, n_power=n_power)

    def step(a_, C, T, P_prev):
        e2, _, P = move(a_, EnvC4v(C, T), P_prev)
        return e2.C, e2.T, P

    chi = env.C.shape[0]
    D = a.shape[1]
    C, T = env
    P = cold_start_basis(chi * D * D, chi, C.dtype, C.device)
    for _ in range(n_iter):
        C, T, P = checkpoint(step, a, C, T, P, use_reentrant=False)
    return EnvC4v(C, T)
