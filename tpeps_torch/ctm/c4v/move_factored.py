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
  :mod:`tpeps_torch.kernels.cholqr`, Rayleigh-Ritz with
  :func:`~tpeps_torch.linalg.eigh.eigh_desc`;
* K4 ``_absorb_T_int`` (layers on ``layer_contract``) and its epilogue
  (:func:`~tpeps_torch.kernels.epilogue.t_epilogue`).

The chi-contractions around the layers (C.T_top, T_left.ct, T.P and the
closing conj(P)) are plain large matrix products and stay ``torch.matmul``.
The Rayleigh-Ritz eigh of a real move is the on-card Jacobi kernel
``eigh_small`` (chi <= 169, as for K6), so the move reads nothing to the
host and captures into a CUDA graph (K5, :mod:`tpeps_torch.ctm.c4v.move_graph`).

``dot_impl="ozaki[:s]"`` (move_tpu.py:36-72) runs a real float64 move as the
JAX package does: every contraction ``move_tpu.py`` routes through ``_dot``
(the chi products, both layers, the closing conj(P)) is an Ozaki product
(K7, :mod:`tpeps_torch.linalg.ozaki`), and the corner operator is split into
its int8 digits once per move for the subspace iteration.  Forward only: the
move and the drivers run under ``torch.inference_mode()``.
"""

from __future__ import annotations

import contextlib
import time
from functools import partial

import numpy as np
import torch

from ...kernels.corner import corner_apply
from ...kernels.epilogue import t_epilogue
from ...kernels.layer import layer_contract
from ...linalg.eigh import eigh_desc, multiplet_mask
from ...linalg.ozaki import ozaki_dot_general, ozaki_matmul_presplit, ozaki_presplit
from ...linalg.power import cholesky_qr2, cold_start_basis, procrustes_align
from .env import EnvC4v

MATMUL_PRECISIONS = (None, "highest")


def _ozaki_slices(impl: str):
    """Parse ``"ozaki"`` / ``"ozaki:<s>"`` -> slice count, or None for
    ``"xla"``.  Strict: anything else raises."""
    if impl == "ozaki" or impl.startswith("ozaki:"):
        s = 8
        if ":" in impl:
            suffix = impl.split(":", 1)[1]
            if not suffix.isdigit() or int(suffix) < 1:
                raise ValueError(
                    f"dot_impl {impl!r}: expected 'ozaki' or 'ozaki:<positive int>'"
                )
            s = int(suffix)
        return s
    if impl != "xla":
        raise ValueError(
            f"unknown dot_impl {impl!r}: expected 'xla', 'ozaki' or 'ozaki:<int>'"
        )
    return None


def _dot(x, y, dn, impl: str):
    """``lax.dot_general`` dispatcher (no batch axes; output: free axes of
    ``x``, then of ``y``): ``impl="ozaki[:s]"`` routes real-f64 contractions
    through the Ozaki product with ``s`` digits, anything else is
    ``torch.tensordot``."""
    s = _ozaki_slices(impl)
    if s is not None and x.dtype == torch.float64 and y.dtype == torch.float64:
        return ozaki_dot_general(x, y, dn, slices=s)
    (cx, cy), _ = dn
    return torch.tensordot(x, y, dims=(list(cx), list(cy)))


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


def _c2x2_dots(a, C, T_int, slice_phys: bool, dot_impl: str):
    """``_c2x2_factored`` as move_tpu.py:87-118 writes it, every contraction
    through :func:`_dot`; returns ``M6[f,g,e,r,j,i]``."""
    D, d, chi = a.shape[1], a.shape[0], C.shape[0]
    Tt_r = T_int.permute(3, 0, 1, 2).reshape(chi, D * D * chi)  # y,(u,v,i)
    ct = _dot(C, Tt_r, (((1,), (0,)), ((), ())), dot_impl).reshape(chi, D, D, chi)
    q1 = _dot(T_int, ct, (((2,), (0,)), ((), ())), dot_impl)  # (l,m,j)+(u,v,i)
    if not slice_phys:
        q = _dot(a, q1, (((1, 2), (3, 0)), ((), ())), dot_impl)  # (s,e,r)+(m,j,v,i)
        return _dot(a.conj(), q, (((0, 1, 2), (0, 5, 3)), ((), ())), dot_impl)
    M6 = None
    for s in range(d):
        qs = _dot(a[s], q1, (((0, 1), (3, 0)), ((), ())), dot_impl)  # (e,r)+(m,j,v,i)
        ms = _dot(a[s].conj(), qs, (((0, 1), (4, 2)), ((), ())), dot_impl)
        M6 = ms if M6 is None else M6 + ms
    return M6  # (f,g)+(e,r,j,i)


def _absorb_T_dots(a, T_int, P, chi: int, chi_n: int, slice_phys: bool, dot_impl: str):
    """``_absorb_T_int`` as move_tpu.py:154-182 writes it, every contraction
    through :func:`_dot`; returns ``T'[k,b,chi',chi']`` before the epilogue."""
    D, d = a.shape[1], a.shape[0]
    P4 = P.reshape(chi, D, D, chi_n)  # (c, u, v, p)
    z1 = _dot(T_int, P4, (((2,), (0,)), ((), ())), dot_impl)  # (l,m,d)+(u,v,p)
    if not slice_phys:
        z = _dot(a, z1, (((1, 2), (3, 0)), ((), ())), dot_impl)  # (s,e,r)+(m,d,v,p)
        z = _dot(a.conj(), z, (((0, 1, 2), (0, 5, 3)), ((), ())), dot_impl)
    else:
        z = None
        for s in range(d):
            zs = _dot(a[s], z1, (((0, 1), (3, 0)), ((), ())), dot_impl)  # (e,r)+(m,d,v,p)
            zs = _dot(a[s].conj(), zs, (((0, 1), (4, 2)), ((), ())), dot_impl)
            z = zs if z is None else z + zs  # (f,g)+(e,r,d,p)
    nT = _dot(P4.conj(), z, (((0, 1, 2), (4, 2, 0)), ((), ())), dot_impl)  # (q)+(g,r,p)
    return nT.permute(2, 1, 3, 0)


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
def ctm_move_sl_factored(a, C, T_int, P_ref, **move_kwargs):
    """One C4v move in internal layout.  Returns ``(C', T'_int, spec, P)``.

    Keywords: ``n_power``, ``eps_multiplet``, ``ad_decomp_reg``,
    ``absorb_normalization``; ``slice_phys`` runs the two layers once per
    physical index and accumulates, which halves the largest intermediate at
    d=2; ``dot_impl="ozaki[:s]"`` runs a real float64 move on Ozaki products
    (see the module docstring); other dtypes ignore it, as in the JAX package.
    """
    return ctm_move_w(a, C, T_int, P_ref, None, **move_kwargs)[:4]


@torch.inference_mode()
def ctm_move_w(
    a,
    C,
    T_int,
    P_ref,
    W_ref=None,
    *,
    n_power: int = 2,
    eps_multiplet: float = 1.0e-12,
    ad_decomp_reg: float = 1.0e-12,
    absorb_normalization: str = "inf",
    slice_phys: bool = False,
    dot_impl: str = "xla",
):
    """:func:`ctm_move_sl_factored` that also takes and returns the Procrustes
    rotation ``W`` (``P = P_eig W``, ``C' = W^H diag(spec) W``): returns
    ``(C', T'_int, spec, P, W)``.

    With the previous move's ``W_ref`` the subspace iteration starts from
    ``P_ref W_ref^H``, the previous move's eigenbasis.  It spans the same
    space as ``P_ref``, so the Ritz pairs are the same to rounding, but the
    Rayleigh-Ritz matrix comes out near-diagonal (off-diagonal norm 1e-3 to
    1e-7 of the whole at D=3 after 5-30 moves, against 0.9 from ``P_ref``),
    and the Jacobi eigh needs few sweeps.
    """
    chi = C.shape[0]
    oz_s = _ozaki_slices(dot_impl)
    ozaki = oz_s is not None and a.dtype == torch.float64
    if ozaki:
        n = chi * a.shape[1] ** 2
        # the corner as M2[(j,e,f),(i,r,g)], split once for the n_power + 1
        # applications of the subspace iteration (move_tpu.py:205-222)
        M6 = _c2x2_dots(a, C, T_int, slice_phys, dot_impl)
        M2c, ea = ozaki_presplit(M6.permute(4, 2, 0, 5, 3, 1).reshape(n, n), oz_s)
        del M6
        m_apply = partial(ozaki_matmul_presplit, M2c, ea, slices=oz_s)
    else:
        M2 = _c2x2_factored(a, C, T_int, slice_phys=slice_phys)
        m_apply = partial(_m_apply, M2)
    P_start = P_ref if W_ref is None else P_ref @ W_ref.mH
    Dspec, P = _subspace_eigh_op(m_apply, P_start, chi, n_power, eps_multiplet, ad_decomp_reg)
    del m_apply
    cmask = Dspec.abs() > 0
    P, W = procrustes_align(P, P_ref, col_mask=cmask)
    spec = Dspec / Dspec[0].abs()
    nC = (W.mH * spec.to(C.dtype)[None, :]) @ W
    if ozaki:
        nT = _absorb_T_dots(a, T_int, P, chi, chi, slice_phys, dot_impl).contiguous()
    else:
        nT = _absorb_T_int(a, T_int, P, chi, chi, slice_phys=slice_phys)
    nT = t_epilogue(nT, absorb_normalization)
    return nC, nT, spec, P, W


@contextlib.contextmanager
def matmul_precision_scope(matmul_precision):
    """``"highest"``: full-f32 cuBLAS products (TF32 off) for the scope, the
    caller's setting restored after; ``None`` leaves the caller's setting."""
    if matmul_precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision={matmul_precision!r}: expected None or 'highest'")
    before = torch.backends.cuda.matmul.allow_tf32
    if matmul_precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


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
    moves_per_sync: int = 1,
    matmul_precision=None,
    stall_window: int = 0,
    P0=None,
    **move_kwargs,
):
    """Host-driven CTMRG loop over :func:`ctm_move_sl_factored`
    (counterpart of ``run_ctmrg_tpu``, move_tpu.py:337-450).

    Convergence is the 2-norm distance between the normalized corner spectra
    (|spec|) of consecutive host reads.  With ``moves_per_sync`` = N > 1,
    each read follows one replay of a CUDA graph of N moves
    (:class:`~tpeps_torch.ctm.c4v.move_graph.MoveGraph`; on the CPU the same
    N moves run eagerly) and the iteration count advances by N, as
    ``run_ctmrg_tpu`` counts them.

    :param timers: optional :class:`tpeps_torch.profiling.PhaseTimers`
        accumulating the "move" and "conv_check" phases
    :param matmul_precision: ``"highest"`` turns TF32 off for the call's
        cuBLAS float32 products (``torch.backends.cuda.matmul.allow_tf32``,
        restored after); ``None`` leaves the caller's setting.  The hand
        kernels' float32 variants compute in full float32 either way.
    :param stall_window: if > 0, stop early when the spectra distance has
        not improved by 30% for this many consecutive checks
    :param P0: optional warm-start subspace basis ``(chi D^2, chi)``
    :param move_kwargs: further keywords of the move, e.g. ``dot_impl``
    :return: ``(env, n_iter, dist, P)``; ``P`` is the final projector basis,
        reusable as the next call's ``P0``
    :raises RuntimeError: if a move yields a non-finite corner spectrum
        (the JAX package's retry from a cold basis is a workaround for its
        emulated f64 and is not ported)
    """
    from .move_graph import CHAIN_CONV_TOL, CHAIN_MAX_ITER, MoveGraph

    def phase(name):
        if timers is None:
            return contextlib.nullcontext()
        return timers.phase(name, device=a.device)

    if moves_per_sync < 1:
        raise ValueError(f"moves_per_sync={moves_per_sync} must be >= 1")
    D = a.shape[1]
    chi = env.C.shape[0]
    T_int = to_int_layout(env.T, D)
    if P0 is not None:
        P = torch.as_tensor(P0, dtype=env.C.dtype, device=env.C.device).contiguous()
    else:
        P = cold_start_basis(chi * D * D, chi, env.C.dtype, env.C.device)
    C, W = env.C, None
    spec_prev = None
    dist = float("inf")
    best_dist = float("inf")
    no_improve = 0
    it = 0
    n_sync = max(1, -(-max_iter // moves_per_sync))
    with matmul_precision_scope(matmul_precision):
        graph = None
        if moves_per_sync > 1:
            graph = MoveGraph(a, chi, n_moves=moves_per_sync, n_power=n_power,
                              slice_phys=slice_phys, **move_kwargs)
            graph.load(a, C, T_int, P, max_iter=CHAIN_MAX_ITER, conv_tol=CHAIN_CONV_TOL)
        for it_s in range(1, n_sync + 1):
            it = it_s * moves_per_sync
            with phase("move"):
                if graph is None:
                    C, T_int, spec, P, W = ctm_move_w(
                        a, C, T_int, P, W, n_power=n_power, slice_phys=slice_phys, **move_kwargs)
                else:
                    graph.run()
                    spec = graph.state.spec  # |spec| of the chunk's last move
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
        if graph is not None:
            C, T_int, P = (t.clone() for t in (graph.state.C, graph.state.T, graph.state.P))
    return EnvC4v(C, from_int_layout(T_int)), it, dist, P


@torch.inference_mode()
def run_ctmrg_mixed(
    a,
    env: EnvC4v,
    *,
    max_iter: int = 100,
    conv_tol: float = 1.0e-8,
    switch_tol: float = 1.0e-5,
    n_power: int = 2,
    slice_phys: bool = False,
    slice_phys32: bool = False,
    timers=None,
    moves_per_sync: int = 1,
    f64_dot_impl: str = "ozaki",
    stats=None,
    **move_kwargs,
):
    """Mixed-precision CTMRG (counterpart of ``run_ctmrg_tpu_mixed``,
    move_tpu.py:453-520): converge in float32, push further with full-f32
    products, then polish to ``conv_tol`` in float64.

    Phase 1: float32, ``conv_tol = max(switch_tol, conv_tol)``, stall window
    4.  Phase 2: float32 with ``matmul_precision="highest"``, ``conv_tol =
    max(conv_tol, 3e-7)``, stall window 3, warm-started from phase 1's
    projector.  Phase 3: float64 with ``dot_impl=f64_dot_impl``,
    warm-started from phase 2's projector.  The float32 phases slice the
    physical index where ``slice_phys32``, the float64 one where ``slice_phys``.
    On the H100 (native FP64) this is an API-parity option, not a speed lever.

    :param stats: optional list; one dict per phase is appended (``phase``,
        ``moves``, ``dist``, ``seconds`` of host wall time)
    :return: ``(env, n_iter_total, dist)`` with env in float64
    """
    def run(name, *args, **kw):
        t0 = time.perf_counter()
        out = run_ctmrg(*args, **kw)
        if stats is not None:
            stats.append({"phase": name, "moves": out[1], "dist": out[2],
                          "seconds": time.perf_counter() - t0})
        return out

    a32 = a.to(torch.complex64 if a.is_complex() else torch.float32)
    env32 = EnvC4v(env.C.to(a32.dtype), env.T.to(a32.dtype))
    common = dict(max_iter=max_iter, n_power=n_power, timers=timers,
                  moves_per_sync=moves_per_sync, **move_kwargs)
    env32, it32, _, P32 = run("f32", a32, env32, conv_tol=max(switch_tol, conv_tol),
                              slice_phys=slice_phys32, stall_window=4, **common)
    env32, it32b, _, P32 = run("f32 highest", a32, env32, conv_tol=max(conv_tol, 3.0e-7),
                               slice_phys=slice_phys32, matmul_precision="highest",
                               stall_window=3, P0=P32, **common)
    env64 = EnvC4v(env32.C.to(env.C.dtype), env32.T.to(env.T.dtype))
    env_out, it64, dist, _ = run("f64", a, env64, conv_tol=conv_tol, slice_phys=slice_phys,
                                 dot_impl=f64_dot_impl, P0=P32, **common)
    return env_out, it32 + it32b + it64, dist
