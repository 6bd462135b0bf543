"""Enlarged 2x2 corners and the half-systems of the abelian CTM
(counterpart of tpeps/ctm/generic_abelian/components.py).

Corners are rank-6 AbelianTensors grouped as (row-triple | col-triple),
each triple = (chi, Dket, Dbra); ``open_phys=True`` appends (s, z) =
(ket, bra) physical legs::

    c2x2_lu:  rows (down-chi, dk, db)   cols (right-chi, rk, rb)
    c2x2_ru:  rows (left-chi, lk, lb)   cols (down-chi, dk, db)
    c2x2_rd:  rows (up-chi, uk, ub)     cols (left-chi, lk, lb)
    c2x2_ld:  rows (up-chi, uk, ub)     cols (right-chi, rk, rb)

Every contraction is an ``AbelianTensor.tensordot`` (K8 on the card).
"""

from __future__ import annotations


def c2x2_lu(C, Tt, Tl, a, open_phys: bool = False):
    """Upper-left corner (dense mirror: components.c2x2_lu)."""
    q = C.tensordot(Tt, ((1,), (0,)))                 # (x,u,v,i)
    q = q.tensordot(Tl, ((0,), (0,)))                 # (u,v,i,j,l,k)
    q = q.tensordot(a, ((0, 4), (1, 2)))              # (v,i,j,k,s,e,r)
    ac = a.conj()
    if open_phys:
        out = q.tensordot(ac, ((0, 3), (1, 2)))       # (i,j,s,e,r,z,f,g)
        return out.transpose((1, 3, 6, 0, 4, 7, 2, 5))
    out = q.tensordot(ac, ((4, 0, 3), (0, 1, 2)))     # (i,j,e,r,f,g)
    return out.transpose((1, 2, 4, 0, 3, 5))


def c2x2_ru(C, Tr, Tt, a, open_phys: bool = False):
    """Upper-right corner (dense mirror: components.c2x2_ru)."""
    q = C.tensordot(Tr, ((1,), (0,)))                 # (x,w,v,b)
    q = q.tensordot(Tt, ((0,), (3,)))                 # (w,v,b,l,m,n)
    q = q.tensordot(a, ((0, 4), (4, 1)))              # (v,b,l,n,s,e,g)
    ac = a.conj()
    if open_phys:
        out = q.tensordot(ac, ((3, 0), (1, 4)))       # (b,l,s,e,g,z,f,h)
        return out.transpose((1, 3, 6, 0, 4, 7, 2, 5))
    out = q.tensordot(ac, ((4, 3, 0), (0, 1, 4)))     # (b,l,e,g,f,h)
    return out.transpose((1, 2, 4, 0, 3, 5))


def c2x2_rd(C, Tb, Tr, a, open_phys: bool = False):
    """Lower-right corner (dense mirror: components.c2x2_rd)."""
    q = C.tensordot(Tb, ((1,), (3,)))                 # (x,m,n,l)
    q = q.tensordot(Tr, ((0,), (3,)))                 # (m,n,l,t,w,v)
    q = q.tensordot(a, ((0, 4), (3, 4)))              # (n,l,t,v,s,e,g)
    ac = a.conj()
    if open_phys:
        out = q.tensordot(ac, ((0, 3), (3, 4)))       # (l,t,s,e,g,z,f,h)
        return out.transpose((1, 3, 6, 0, 4, 7, 2, 5))
    out = q.tensordot(ac, ((4, 0, 3), (0, 3, 4)))     # (l,t,e,g,f,h)
    return out.transpose((1, 2, 4, 0, 3, 5))


def c2x2_ld(C, Tl, Tb, a, open_phys: bool = False):
    """Lower-left corner (dense mirror: components.c2x2_ld)."""
    q = C.tensordot(Tl, ((0,), (1,)))                 # (y,t,w,v)
    q = q.tensordot(Tb, ((0,), (2,)))                 # (t,w,v,m,n,r)
    q = q.tensordot(a, ((1, 3), (2, 3)))              # (t,v,n,r,s,e,g)
    ac = a.conj()
    if open_phys:
        out = q.tensordot(ac, ((1, 2), (2, 3)))       # (t,r,s,e,g,z,f,h)
        return out.transpose((0, 3, 6, 1, 4, 7, 2, 5))
    out = q.tensordot(ac, ((4, 1, 2), (0, 2, 3)))     # (t,r,e,g,f,h)
    return out.transpose((0, 2, 4, 1, 3, 5))


def corner_lu(coord, state, env, open_phys=False):
    c = state.vertexToSite(coord)
    return c2x2_lu(env.C[(c, (-1, -1))], env.T[(c, (0, -1))], env.T[(c, (-1, 0))],
                   state.sites[c], open_phys)


def corner_ru(coord, state, env, open_phys=False):
    c = state.vertexToSite(coord)
    return c2x2_ru(env.C[(c, (1, -1))], env.T[(c, (1, 0))], env.T[(c, (0, -1))],
                   state.sites[c], open_phys)


def corner_rd(coord, state, env, open_phys=False):
    c = state.vertexToSite(coord)
    return c2x2_rd(env.C[(c, (1, 1))], env.T[(c, (0, 1))], env.T[(c, (1, 0))],
                   state.sites[c], open_phys)


def corner_ld(coord, state, env, open_phys=False):
    c = state.vertexToSite(coord)
    return c2x2_ld(env.C[(c, (-1, 1))], env.T[(c, (-1, 0))], env.T[(c, (0, 1))],
                   state.sites[c], open_phys)


def halves_up(coord, state, env):
    """R, Rt for the UP move; ``coord`` is the upper-right site."""
    x, y = coord
    ru = corner_ru(coord, state, env)
    rd = corner_rd((x, y + 1), state, env)
    lu = corner_lu((x - 1, y), state, env)
    ld = corner_ld((x - 1, y + 1), state, env)
    R = ru.tensordot(rd, ((3, 4, 5), (0, 1, 2)))      # (ru-rows, rd-cols)
    Rt = lu.tensordot(ld, ((0, 1, 2), (0, 1, 2)))     # (lu-cols, ld-cols)
    return R, Rt


def halves_left(coord, state, env):
    """R, Rt for the LEFT move; ``coord`` is the upper-left site."""
    x, y = coord
    lu = corner_lu(coord, state, env)
    ru = corner_ru((x + 1, y), state, env)
    ld = corner_ld((x, y + 1), state, env)
    rd = corner_rd((x + 1, y + 1), state, env)
    R = lu.tensordot(ru, ((3, 4, 5), (0, 1, 2)))      # (lu-rows, ru-cols)
    Rt = ld.tensordot(rd, ((3, 4, 5), (3, 4, 5)))     # (ld-rows, rd-rows)
    return R, Rt


def halves_down(coord, state, env):
    """R, Rt for the DOWN move; ``coord`` is the lower-left site."""
    x, y = coord
    ld = corner_ld(coord, state, env)
    lu = corner_lu((x, y - 1), state, env)
    rd = corner_rd((x + 1, y), state, env)
    ru = corner_ru((x + 1, y - 1), state, env)
    R = ld.tensordot(lu, ((0, 1, 2), (0, 1, 2)))      # (ld-cols, lu-cols)
    Rt = rd.tensordot(ru, ((0, 1, 2), (3, 4, 5)))     # (rd-cols, ru-rows)
    return R, Rt


def halves_right(coord, state, env):
    """R, Rt for the RIGHT move; ``coord`` is the lower-right site."""
    x, y = coord
    rd = corner_rd(coord, state, env)
    ld = corner_ld((x - 1, y), state, env)
    ru = corner_ru((x, y - 1), state, env)
    lu = corner_lu((x - 1, y - 1), state, env)
    R = rd.tensordot(ld, ((3, 4, 5), (3, 4, 5)))      # (rd-rows, ld-rows)
    Rt = ru.tensordot(lu, ((0, 1, 2), (3, 4, 5)))     # (ru-cols, lu-rows)
    return R, Rt


HALVES = {
    (0, -1): halves_up,
    (-1, 0): halves_left,
    (0, 1): halves_down,
    (1, 0): halves_right,
}
