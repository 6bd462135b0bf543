"""Abelian-symmetric iPEPS (counterpart of tpeps/ipeps/ipeps_abelian.py):
:class:`~tpeps_torch.sym.tensor.AbelianTensor` on-site tensors in the
``a[s,u,l,d,r]`` convention."""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..sym.tensor import AbelianTensor


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

    def to(self, device) -> "IPEPS_ABELIAN":
        sites = OrderedDict((c, t.to(device)) for c, t in self.sites.items())
        return IPEPS_ABELIAN(self.sym, sites, self.vertexToSite, self.lX, self.lY)

    def __str__(self):
        s = f"IPEPS_ABELIAN[{self.sym}] lX x lY: {self.lX} x {self.lY}\n"
        for coord, t in self.sites.items():
            s += f"  {coord}: legs {[l.total_dim() for l in t.legs]} blocks {len(t.struct.keys)}\n"
        return s


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
