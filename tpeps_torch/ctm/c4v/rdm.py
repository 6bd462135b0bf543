"""Reduced density matrices of the 1-site C4v iPEPS (counterpart of
tpeps/ctm/c4v/rdm.py).

Output convention: ``rho[s_0..s_n, s'_0..s'_n]`` with unprimed indices
from the ket layer.  The (chi D^2)^2 x d^2 contractions of the 2x2 RDMs are
plain matrix products and stay ``torch.matmul`` (cuBLAS on the card).  The
full plaquette RDM ``rdm2x2`` holds two (chi D^2)^2 d^4 tensors at once:
at D=7, chi=147 that is 2 x 6.6 GB.
"""

from __future__ import annotations

import warnings

import torch

from .ctmrg import open_c2x2_sl
from .env import EnvC4v


def _cast_to_real(t, imag_eps: float = 1.0e-8):
    """Drop a (checked-small) imaginary part; warn if it is not small."""
    if t.is_complex():
        im, re = float(t.imag.abs().max()), float(t.real.abs().max())
        if im > imag_eps * max(re, 1.0):
            warnings.warn(
                f"_cast_to_real: imaginary part {im:.3e} exceeds {imag_eps:.1e}x real "
                f"part {re:.3e} — environment may be broken", stacklevel=2)
        return t.real
    return t


def _sym_pos_def_matrix(rho, sym_pos_def: bool = False):
    """Hermitize, optionally project to positive semidefinite, normalize
    by the trace."""
    rho = 0.5 * (rho + rho.mH)
    if sym_pos_def:
        w, u = torch.linalg.eigh(rho.detach())
        rho_pos = (u * w.clamp(min=0.0)[None, :].to(u.dtype)) @ u.mH
        # straight-through: forward is the clamped matrix, backward identity
        rho = rho + (rho_pos - rho.detach())
    return rho / _cast_to_real(torch.trace(rho))


def _sym_pos_def_rdm(rho, sym_pos_def: bool = False):
    """:func:`_sym_pos_def_matrix` on a rank-2n RDM."""
    nsites = rho.dim() // 2
    orig = rho.shape
    dim = 1
    for s in orig[:nsites]:
        dim *= s
    return _sym_pos_def_matrix(rho.reshape(dim, dim), sym_pos_def=sym_pos_def).reshape(orig)


def _open_c2x2_6(a, env: EnvC4v):
    """Open enlarged corner as ``[down-chi, d^2, right-chi, r^2, s, s']``."""
    chi = env.C.shape[0]
    D = a.shape[1]
    d = a.shape[0]
    return open_c2x2_sl(a, env.C, env.T).reshape(chi, D * D, chi, D * D, d, d)


def rdm1x1_sl(a, env: EnvC4v, sym_pos_def: bool = False):
    """1-site RDM, layer by layer."""
    C, T = env
    chi = C.shape[0]
    D = a.shape[1]
    T4 = T.reshape(chi, chi, D, D)
    # left column C-T-C [y: top-right chi, (l1,l2): right D pair, v: bottom-right chi]
    ctc = torch.einsum("xy,xwlm->ywlm", C, T4)
    ctc = torch.einsum("ywlm,wv->ylmv", ctc, C)
    # bottom edge, then the ket and bra layers over (l, d)
    q = torch.einsum("ylmv,vbef->ylmbef", ctc, T4)
    q = torch.einsum("ylmbef,suler->ymbfsur", q, a)
    q = torch.einsum("ymbfsur,zgmfh->ybsurzgh", q, a.conj())
    # top edge, then the mirrored right column
    q = torch.einsum("ybsurzgh,yiug->ibsrzh", q, T4)
    rho = torch.einsum("ibsrzh,brhi->sz", q, ctc)
    return _sym_pos_def_rdm(rho, sym_pos_def=sym_pos_def)


def rdm2x1_sl(a, env: EnvC4v, sym_pos_def: bool = False):
    """2-site nearest-neighbour RDM via left-half reuse."""
    C, T = env
    oc = _open_c2x2_6(a, env)
    cb = torch.einsum("xy,ybn->xbn", C, T)
    lh = torch.einsum("xbm,xmirsz->birsz", cb, oc)
    rho = torch.einsum("birsz,ibrwv->szwv", lh, lh)
    return _sym_pos_def_rdm(rho.permute(0, 2, 1, 3), sym_pos_def=sym_pos_def)


def rdm3x1_sl(a, env: EnvC4v, sym_pos_def: bool = False):
    """Distance-2 2-site RDM: left half + central T-aa*-T column + mirrored
    right half.  Physical order ``s0 (center traced) s1``."""
    C, T = env
    D = a.shape[1]
    D2 = D * D
    oc = _open_c2x2_6(a, env)
    A = torch.einsum("suldr,svmfg->uvlmdfrg", a, a.conj()).reshape(D2, D2, D2, D2)
    cb = torch.einsum("xy,ybn->xbn", C, T)
    lh = torch.einsum("xbm,xmirsz->birsz", cb, oc)
    q = torch.einsum("bcn,birsz->cnirsz", T, lh)
    q = torch.einsum("uvnw,cnivsz->uwcisz", A, q)
    q = torch.einsum("tiu,uwcisz->twcsz", T, q)
    rho = torch.einsum("twcsz,tcwef->szef", q, lh)
    return _sym_pos_def_rdm(rho.permute(0, 2, 1, 3), sym_pos_def=sym_pos_def)


def _open_corner_and_trace(a, env: EnvC4v):
    """``oc[(x), (y), (s,s')]`` as a (chi D^2, chi D^2, d^2) tensor and its
    physical trace ``cc[x, y]``."""
    chi = env.C.shape[0]
    D = a.shape[1]
    d = a.shape[0]
    N = chi * D * D
    oc = open_c2x2_sl(a, env.C, env.T)
    cc = oc.diagonal(dim1=2, dim2=3).sum(-1)
    return oc.reshape(N, N, d * d), cc


def rdm2x2_NN_lowmem_sl(a, env: EnvC4v, sym_pos_def: bool = False):
    """Nearest-neighbour 2-site RDM from 2x2 quadrants::

        C2x2--C2x2c        s0 c
        C2x2--C2x2c        s1 c
    """
    d = a.shape[0]
    oc, cc = _open_corner_and_trace(a, env)
    N = oc.shape[0]
    r1 = (cc @ oc.reshape(N, -1)).reshape(N, N, d * d)
    r2 = (cc @ r1.reshape(N, -1)).reshape(N, N, d * d)
    del r1
    # rho[j, i] = sum_{x,y} oc[x, y, j] r2[y, x, i]
    rho = oc.reshape(N * N, d * d).transpose(0, 1) @ r2.transpose(0, 1).reshape(N * N, d * d)
    rho = rho.reshape(d, d, d, d).permute(0, 2, 1, 3)
    return _sym_pos_def_rdm(rho, sym_pos_def=sym_pos_def)


def rdm2x2_NNN_lowmem_sl(a, env: EnvC4v, sym_pos_def: bool = False):
    """Next-nearest (diagonal) 2-site RDM from 2x2 quadrants::

        C2x2---C2x2c       s0 c
        C2x2c--C2x2        c  s1
    """
    d = a.shape[0]
    oc, cc = _open_corner_and_trace(a, env)
    N = oc.shape[0]
    r1 = (cc @ oc.reshape(N, -1)).reshape(N, N, d * d)
    del oc
    # rho[i, j] = sum_{a,c} r1[a, c, i] r1[c, a, j]
    rho = r1.reshape(N * N, d * d).transpose(0, 1) @ r1.transpose(0, 1).reshape(N * N, d * d)
    rho = rho.reshape(d, d, d, d).permute(0, 2, 1, 3)
    return _sym_pos_def_rdm(rho, sym_pos_def=sym_pos_def)


# the double-layer variants agree in value with the single-layer ones
def rdm1x1(a, env: EnvC4v, sym_pos_def: bool = False):
    return rdm1x1_sl(a, env, sym_pos_def=sym_pos_def)


def rdm2x1(a, env: EnvC4v, sym_pos_def: bool = False):
    return rdm2x1_sl(a, env, sym_pos_def=sym_pos_def)


def rdm3x1(a, env: EnvC4v, sym_pos_def: bool = False):
    return rdm3x1_sl(a, env, sym_pos_def=sym_pos_def)


def rdm2x2(a, env: EnvC4v, sym_pos_def: bool = False):
    """Full 2x2 plaquette RDM, physical order ``s0 s1 / s2 s3``: the upper
    half joins two open corners left-right, the (identical) lower half
    closes it."""
    d = a.shape[0]
    N = env.C.shape[0] * a.shape[1] ** 2
    oc = open_c2x2_sl(a, env.C, env.T)  # [x, y, s, s']
    # uh[x, a, b, y, c, d] = sum_i oc[x, i, a, b] oc[i, y, c, d]
    uh = oc.permute(0, 2, 3, 1).reshape(N * d * d, N) @ oc.reshape(N, N * d * d)
    del oc
    # rho[abcd, efgh] = sum_{x,y} uh[x,y,abcd] uh[y,x,efgh]
    m1 = uh.reshape(N, d, d, N, d, d).permute(1, 2, 4, 5, 0, 3).reshape(d**4, N * N)
    del uh
    m2 = m1.reshape(d**4, N, N).transpose(1, 2).reshape(d**4, N * N)
    rho = (m1 @ m2.transpose(0, 1)).reshape((d,) * 8)
    # [s0,z0,s1,z1,s2',z2',s3',z3'] -> (s0,s1,s2,s3; s0',s1',s2',s3')
    rho = rho.permute(0, 2, 6, 4, 1, 3, 7, 5)
    return _sym_pos_def_rdm(rho, sym_pos_def=sym_pos_def)


def aux_rdm1x1(env: EnvC4v, D: int):
    """Auxiliary (virtual-index) RDM of a 1x1 patch: the boundary ring
    C-T-C-T-C-T-C-T with its four D^2 legs opened into (ket, bra) pairs,
    ``rho[u l d r, u' l' d' r']``; contracting it with the site's ket and bra
    layers gives the unnormalized ``rdm1x1``."""
    C = env.C
    chi = C.shape[0]
    Tl = env.T.reshape(chi, chi, D, D)
    Tt = env.T.permute(0, 2, 1).reshape(chi, D, D, chi)
    Tb = env.T.permute(2, 0, 1).reshape(D, D, chi, chi)
    Tr = env.T.permute(0, 2, 1).reshape(chi, D, D, chi)
    L = torch.einsum("xy,xblk->yblk", C, Tl)
    L = torch.einsum("yblk,bw->ylkw", L, C)
    q = torch.einsum("ylkw,yuvi->lkwuvi", L, Tt)
    q = torch.einsum("lkwuvi,dewj->lkuvidej", q, Tb)
    R = torch.einsum("pq,qmnb->pmnb", C, Tr)
    R = torch.einsum("pmnb,bj->pmnj", R, C)
    rho = torch.einsum("lkuvidej,imnj->uvlkdemn", q, R)
    # [u,u', l,l', d,d', r,r'] -> kets then bras
    return rho.permute(0, 2, 4, 6, 1, 3, 5, 7)


def ddA_rdm1x1(a, env: EnvC4v):
    """The boundary ring contracted with the BRA layer only, ket slots open:
    ``rho[s, u, l, d, r]``, the environment-weighted frame
    d<psi|psi>/dA (up to conjugation) through the fixed environment."""
    frame = aux_rdm1x1(env, a.shape[1])  # [uk lk dk rk, ub lb db rb]
    return torch.einsum("uldrULDR,sULDR->suldr", frame, a.conj())


def rdm2x1_tiled(a, env: EnvC4v, sym_pos_def: bool = False):
    """API alias of the tiled 2x1 RDM: the layer-by-layer ``rdm2x1_sl``
    already keeps the peak memory down."""
    return rdm2x1_sl(a, env, sym_pos_def=sym_pos_def)


def rdm2x2_NN_tiled(a, env: EnvC4v, sym_pos_def: bool = False):
    """API alias: the low-memory NN 2x2 RDM."""
    return rdm2x2_NN_lowmem_sl(a, env, sym_pos_def=sym_pos_def)


def rdm2x2_NNN_tiled(a, env: EnvC4v, sym_pos_def: bool = False):
    """API alias: the low-memory NNN 2x2 RDM."""
    return rdm2x2_NNN_lowmem_sl(a, env, sym_pos_def=sym_pos_def)
