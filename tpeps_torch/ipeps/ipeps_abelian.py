"""Abelian-symmetric iPEPS (counterpart of tpeps/ipeps/ipeps_abelian.py):
:class:`~tpeps_torch.sym.tensor.AbelianTensor` on-site tensors in the
``a[s,u,l,d,r]`` convention."""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..sym.tensor import AbelianTensor

_SIG = (1, 1, 1, -1, -1)  # (s, u, l, d, r): the canonical generic signature


class IPEPS_ABELIAN:
    """iPEPS over an arbitrary unit cell with abelian-symmetric tensors."""

    def __init__(self, sym, sites, vertexToSite=None, lX=None, lY=None):
        self.sym = sym
        self.sites = OrderedDict(sites)
        for t in self.sites.values():
            assert isinstance(t, AbelianTensor) and t.ndim == 5
        if lX is None or lY is None:
            xs = [c[0] for c in self.sites]
            ys = [c[1] for c in self.sites]
            lX = max(xs) - min(xs) + 1
            lY = max(ys) - min(ys) + 1
        self.lX, self.lY = lX, lY
        if vertexToSite is not None:
            self.vertexToSite = vertexToSite
        else:

            def vertexToSite(coord):
                x, y = coord
                return ((x + abs(x) * self.lX) % self.lX, (y + abs(y) * self.lY) % self.lY)

            self.vertexToSite = vertexToSite

    def site(self, coord=(0, 0)):
        return self.sites[self.vertexToSite(coord)]

    def get_parameters(self):
        """Variational parameters: ``{coord: flat block buffer}`` (the charge
        structure stays with the sites)."""
        return {c: t.data for c, t in self.sites.items()}

    def set_parameters(self, params):
        """The same state over new flat block buffers ``{coord: tensor}``."""
        sites = OrderedDict((c, AbelianTensor._flat(t, t.struct, params[c]))
                            for c, t in self.sites.items())
        return IPEPS_ABELIAN(self.sym, sites, self.vertexToSite, self.lX, self.lY)

    def to(self, device) -> "IPEPS_ABELIAN":
        sites = OrderedDict((c, t.to(device)) for c, t in self.sites.items())
        return IPEPS_ABELIAN(self.sym, sites, self.vertexToSite, self.lX, self.lY)

    def __str__(self):
        s = f"IPEPS_ABELIAN[{self.sym}] lX x lY: {self.lX} x {self.lY}\n"
        for coord, t in self.sites.items():
            s += f"  {coord}: legs {[l.total_dim() for l in t.legs]} blocks {len(t.struct.keys)}\n"
        return s


def make_staggered_signature_site(generator: torch.Generator, sym, phys_leg, aux_leg, n=0,
                                  dtype=torch.float64, device="cpu") -> AbelianTensor:
    """Random symmetric on-site tensor with the canonical signature: uniform
    [-0.5, 0.5) per block, drawn from ``generator`` in sorted key order."""
    return AbelianTensor.random(generator, sym, _SIG,
                                (phys_leg, aux_leg, aux_leg, aux_leg, aux_leg), n, dtype=dtype,
                                device=device)


def make_c4v_symm_A1_abelian(a: AbelianTensor) -> AbelianTensor:
    """Project a 1-site abelian tensor ``a[s,u,l,d,r]`` (uniform aux leg
    tables) onto the A1 irrep of C4v: the reflection/rotation average of
    the JAX package."""
    a = 0.5 * (a + a.transpose((0, 1, 4, 3, 2)))  # left-right reflection
    a = 0.5 * (a + a.transpose((0, 3, 2, 1, 4)))  # up-down reflection
    a = 0.5 * (a + a.transpose((0, 4, 1, 2, 3)))  # pi/2 anti-clockwise
    a = 0.5 * (a + a.transpose((0, 2, 3, 4, 1)))  # pi/2 clockwise
    return a


def add_noise_abelian(a: AbelianTensor, generator: torch.Generator, noise: float) -> AbelianTensor:
    """``a + noise * r`` with ``r`` uniform in [-0.5, 0.5) on every block,
    drawn from ``generator`` block after block in sorted key order."""
    if noise == 0:
        return a
    blocks = {}
    for q, b in a.blocks.items():
        r = torch.rand(b.shape, generator=generator, dtype=torch.float64,
                       device=generator.device) - 0.5
        blocks[q] = b + noise * r.to(dtype=b.dtype, device=b.device)
    return a.copy_with(blocks)


def random_c4v_abelian(generator: torch.Generator, sym, phys_leg, aux_leg, n=0,
                       dtype=torch.float64, device="cpu") -> IPEPS_ABELIAN:
    """A random 1-site C4v state with the uniform +1 signature of C4v state
    files: uniform [-0.5, 0.5) per block (sorted key order, from
    ``generator``), projected by :func:`make_c4v_symm_A1_abelian`, normalized
    to unit 2-norm (the JAX package's benchmark recipe, other random numbers)."""
    a = AbelianTensor.random(generator, sym, (1, 1, 1, 1, 1),
                             (phys_leg, aux_leg, aux_leg, aux_leg, aux_leg), n, dtype=dtype,
                             device=device)
    a = make_c4v_symm_A1_abelian(a)
    return IPEPS_ABELIAN(sym, {(0, 0): a * (1.0 / float(a.norm()))})


def bipartite(coord):
    """The bipartite tiling of a 2-site cell: ``(x + y) mod 2`` on the x axis."""
    vx = (coord[0] + abs(coord[0]) * 2) % 2
    return ((vx + abs(coord[1])) % 2, 0)


def random_bipartite_abelian(generator: torch.Generator, sym, phys_leg, aux_leg, n=0,
                             neel: bool = False, dtype=torch.float64,
                             device="cpu") -> IPEPS_ABELIAN:
    """A random 2-site bipartite state in the canonical signature: site (0, 0)
    uniform [-0.5, 0.5) per block (sorted key order, from ``generator``),
    projected onto C4v's A1 in the uniform +1 signature, its (d, r) legs
    flipped (``flip_charges``) and normalized; site (1, 0) another such site,
    or with ``neel`` its Neel partner (the charge conjugate with the phase -1
    on the physical charge +1, total charge ``-n``).  Independent random
    sites make a CTMRG that does not converge; the projection makes each
    site's double layer reflection-symmetric."""
    def site():
        a = AbelianTensor.random(generator, sym, (1, 1, 1, 1, 1),
                                 (phys_leg, aux_leg, aux_leg, aux_leg, aux_leg), n, dtype=dtype)
        a = make_c4v_symm_A1_abelian(a).flip_charges((3, 4))
        return a * (1.0 / float(a.norm()))

    A = site()
    if neel:
        B = A.charge_conjugate()
        B = B.copy_with({qs: (-b if qs[0] == 1 else b) for qs, b in B.blocks.items()})
    else:
        B = site()
    st = IPEPS_ABELIAN(sym, {(0, 0): A, (1, 0): B}, vertexToSite=bipartite, lX=2, lY=1)
    return st.to(device)
