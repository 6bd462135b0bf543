"""Abelian block-sparse CTM environment container for generic unit cells
(counterpart of ``ENV_ABELIAN`` in tpeps/ctm/generic_abelian/env.py; the
generic initializations and move are not ported yet).

* ``C[(coord,(dx,dy))]`` rank-2 (chi, chi)
* ``T[(c,(0,-1))]`` top:    (chi_left, Dk_down, Db_down, chi_right)
* ``T[(c,(-1,0))]`` left:   (chi_up, chi_down, Dk_right, Db_right)
* ``T[(c,(0,1))]``  bottom: (Dk_up, Db_up, chi_left, chi_right)
* ``T[(c,(1,0))]``  right:  (chi_up, Dk_left, Db_left, chi_down)
"""

from __future__ import annotations

import torch

CORNER_VECS = ((-1, -1), (1, -1), (1, 1), (-1, 1))
EDGE_VECS = ((0, -1), (-1, 0), (0, 1), (1, 0))


class ENV_ABELIAN:
    """Container of AbelianTensor corners and edges."""

    def __init__(self, chi: int, C=None, T=None):
        self.chi = chi
        self.C = dict(C) if C else {}
        self.T = dict(T) if T else {}

    def get_spectra(self):
        """Sorted singular values of every corner (dense embedding)."""
        return {k: torch.linalg.svdvals(c.to_dense()) for k, c in self.C.items()}
