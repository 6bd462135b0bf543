"""Reduced density matrices over abelian environments (counterpart of
tpeps/ctm/generic_abelian/rdm.py): the dense RDM networks written
block-sparsely, each returning a dense rho ``rho[s..., s'...]`` (unprimed =
ket; 2x2 site order row-major from ``coord``).  Every contraction is an
``AbelianTensor.tensordot`` (K8 on the card).
"""

from __future__ import annotations

from ..c4v.rdm import _sym_pos_def_rdm
from .components import corner_ld, corner_lu, corner_rd, corner_ru


def rdm1x1(coord, state, env, sym_pos_def: bool = False, raw: bool = False):
    """1-site RDM (dense mirror: rdm.rdm1x1; reference rdm.py:71-258)."""
    c = state.vertexToSite(coord)
    a = state.sites[c]
    C, T = env.C, env.T
    Tl, Tt = T[(c, (-1, 0))], T[(c, (0, -1))]
    Tb, Tr = T[(c, (0, 1))], T[(c, (1, 0))]

    L = C[(c, (-1, -1))].tensordot(Tl, ((0,), (0,)))        # (y,b,lk,lb)
    L = L.tensordot(C[(c, (-1, 1))], ((1,), (0,)))          # (y,lk,lb,w)
    q = L.tensordot(Tt, ((0,), (0,)))                       # (lk,lb,w,uk,ub,i)
    q = q.tensordot(Tb, ((2,), (2,)))                       # (lk,lb,uk,ub,i,dk,eb,j)
    q = q.tensordot(a, ((0, 2, 5), (2, 1, 3)))              # (k,v,i,e,j,s,r)
    q = q.tensordot(a.conj(), ((1, 0, 3), (1, 2, 3)))       # (i,j,s,r,z,g)
    R = C[(c, (1, -1))].tensordot(Tr, ((1,), (0,)))         # (p,mk,nb,b)
    R = R.tensordot(C[(c, (1, 1))], ((3,), (0,)))           # (p,m,n,j)
    rho = q.tensordot(R, ((0, 3, 5, 1), (0, 1, 2, 3)))      # (s,z)
    if raw:
        return rho
    return _sym_pos_def_rdm(rho.to_dense(), sym_pos_def=sym_pos_def)


def rdm2x1(coord, state, env, sym_pos_def: bool = False, raw: bool = False):
    """Horizontal 2-site RDM of (coord, coord+(1,0))
    (dense mirror: rdm.rdm2x1; reference rdm.py:304-570)."""
    site_of = state.vertexToSite
    c0 = site_of(coord)
    c1 = site_of((coord[0] + 1, coord[1]))
    C, T = env.C, env.T

    lu = corner_lu(coord, state, env, open_phys=True)
    ru = corner_ru((coord[0] + 1, coord[1]), state, env, open_phys=True)

    cb0 = C[(c0, (-1, 1))].tensordot(T[(c0, (0, 1))], ((1,), (2,)))  # (x,dk,eb,j)
    lh = lu.tensordot(cb0, ((0, 1, 2), (0, 1, 2)))          # (i,r,g,s,z,j)

    cb1 = T[(c1, (0, 1))].tensordot(C[(c1, (1, 1))], ((3,), (1,)))   # (d,e,l,x)
    rh = ru.tensordot(cb1, ((3, 4, 5), (3, 0, 1)))          # (l,e,f,s,z,lcb)

    rho = lh.tensordot(rh, ((0, 1, 2, 5), (0, 1, 2, 5)))    # (s,z,w,v)
    if raw:
        return rho  # (s0, z0, s1, z1)
    return _sym_pos_def_rdm(
        rho.to_dense().permute(0, 2, 1, 3), sym_pos_def=sym_pos_def
    )


def rdm1x2(coord, state, env, sym_pos_def: bool = False, raw: bool = False):
    """Vertical 2-site RDM of (coord, coord+(0,1))
    (dense mirror: rdm.rdm1x2; reference rdm.py:571-960)."""
    site_of = state.vertexToSite
    c0 = site_of(coord)
    c1 = site_of((coord[0], coord[1] + 1))
    C, T = env.C, env.T

    lu = corner_lu(coord, state, env, open_phys=True)
    ld = corner_ld((coord[0], coord[1] + 1), state, env, open_phys=True)

    rt0 = C[(c0, (1, -1))].tensordot(T[(c0, (1, 0))], ((1,), (0,)))  # (p,mk,nb,b)
    th = lu.tensordot(rt0, ((3, 4, 5), (0, 1, 2)))          # (j,e,f,s,z,b)

    rb1 = T[(c1, (1, 0))].tensordot(C[(c1, (1, 1))], ((3,), (0,)))   # (t,m,n,l)
    bh = ld.tensordot(rb1, ((3, 4, 5), (3, 1, 2)))          # (t,e,f,s,z,t2)

    rho = th.tensordot(bh, ((0, 1, 2, 5), (0, 1, 2, 5)))    # (s,z,w,v)
    if raw:
        return rho  # (s0, z0, s1, z1)
    return _sym_pos_def_rdm(
        rho.to_dense().permute(0, 2, 1, 3), sym_pos_def=sym_pos_def
    )


def _four_corners(coord, state, env, open_flags):
    x, y = coord
    lu = corner_lu((x, y), state, env, open_phys=open_flags[0])
    ru = corner_ru((x + 1, y), state, env, open_phys=open_flags[1])
    ld = corner_ld((x, y + 1), state, env, open_phys=open_flags[2])
    rd = corner_rd((x + 1, y + 1), state, env, open_phys=open_flags[3])
    return lu, ru, ld, rd


def rdm2x2(coord, state, env, sym_pos_def: bool = False):
    """Full 2x2 RDM, sites (s0,s1;s2,s3) row-major from ``coord``
    (dense mirror: rdm.rdm2x2; reference rdm.py:1306-1593)."""
    lu, ru, ld, rd = _four_corners(coord, state, env, (1, 1, 1, 1))
    uh = lu.tensordot(ru, ((3, 4, 5), (0, 1, 2)))   # (r3, s0,z0, c3, s1,z1)
    lh = ld.tensordot(rd, ((3, 4, 5), (3, 4, 5)))   # (r3, s2,z2, r3', s3,z3)
    rho = uh.tensordot(lh, ((0, 1, 2, 5, 6, 7), (0, 1, 2, 5, 6, 7)))
    rho = rho.to_dense().permute(0, 2, 4, 6, 1, 3, 5, 7)
    return _sym_pos_def_rdm(rho, sym_pos_def=sym_pos_def)


def rdm2x2_NNN_11(coord, state, env, sym_pos_def: bool = False, raw: bool = False):
    """Diagonal pair (coord, coord+(1,1)) (dense mirror:
    rdm.rdm2x2_NNN_11; reference rdm.py:962-1143)."""
    lu, ru, ld, rd = _four_corners(coord, state, env, (1, 0, 0, 1))
    uh = lu.tensordot(ru, ((3, 4, 5), (0, 1, 2)))   # (r3, s0,z0, c3)
    lh = ld.tensordot(rd, ((3, 4, 5), (3, 4, 5)))   # (r3, r3', s3,z3)
    rho = uh.tensordot(lh, ((0, 1, 2, 5, 6, 7), (0, 1, 2, 3, 4, 5)))
    if raw:
        return rho  # (s0, z0, s3, z3): upper-left first, lower-right second
    return _sym_pos_def_rdm(
        rho.to_dense().permute(0, 2, 1, 3), sym_pos_def=sym_pos_def
    )


def rdm2x2_NNN_1n1(coord, state, env, sym_pos_def: bool = False, raw: bool = False):
    """Anti-diagonal pair (coord, coord+(1,-1)); site order
    (lower-left, upper-right) (dense mirror: rdm.rdm2x2_NNN_1n1)."""
    coord = (coord[0], coord[1] - 1)
    lu, ru, ld, rd = _four_corners(coord, state, env, (0, 1, 1, 0))
    uh = lu.tensordot(ru, ((3, 4, 5), (0, 1, 2)))   # (r3, c3, s1,z1)
    lh = ld.tensordot(rd, ((3, 4, 5), (3, 4, 5)))   # (r3, s2,z2, r3')
    rho = uh.tensordot(lh, ((0, 1, 2, 3, 4, 5), (0, 1, 2, 5, 6, 7)))
    if raw:
        return rho  # (s1, z1, s2, z2): upper-right FIRST, lower-left second
    # td order (s1,z1,s2,z2) -> (s2,s1,z2,z1)
    return _sym_pos_def_rdm(
        rho.to_dense().permute(2, 0, 3, 1), sym_pos_def=sym_pos_def
    )
