"""SU(2) irrep operator algebra (counterpart of tpeps/groups/su2.py).

Operators are built in numpy and returned as tensors of the requested
dtype and device; they are tiny (m x m) constants of the Hamiltonians.
"""

from __future__ import annotations

from math import sqrt

import numpy as np
import torch


class SU2:
    """Spin irrep of dimension ``J`` (physical spin S = (J-1)/2)."""

    def __init__(self, J: int, dtype=torch.float64, device="cuda"):
        self.J = J
        self.dtype = dtype
        self.device = device

    def _t(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def I(self):
        return self._t(np.eye(self.J))

    def I_N(self, N: int):
        """Identity over N irreps as a rank-2N tensor."""
        return self._t(np.eye(self.J**N)).reshape([self.J] * (2 * N))

    def SZ(self):
        m = self.J
        return self._t(np.diag([-0.5 * (-(m - 1) + 2 * i) for i in range(m)]))

    def SP(self):
        """S^+ raising operator."""
        m = self.J
        res = np.zeros((m, m))
        for i in range(m - 1):
            res[i, i + 1] = sqrt(
                0.5 * (m - 1) * (0.5 * (m - 1) + 1)
                - (-0.5 * (m - 1) + i) * (-0.5 * (m - 1) + i + 1)
            )
        return self._t(res)

    def SM(self):
        """S^- lowering operator."""
        m = self.J
        res = np.zeros((m, m))
        for i in range(1, m):
            res[i, i - 1] = sqrt(
                0.5 * (m - 1) * (0.5 * (m - 1) + 1)
                - (-0.5 * (m - 1) + i) * (-0.5 * (m - 1) + i - 1)
            )
        return self._t(res)

    def BP_rot(self):
        return get_rot_op(self.J, dtype=self.dtype, device=self.device)

    def S(self):
        """Rank-3 stack [S^z, S^x, (S^y)]; S^y is zero for a real dtype."""
        ops = [self.SZ(), 0.5 * (self.SP() + self.SM())]
        if self.dtype.is_complex:
            ops.append(-0.5j * (self.SP() - self.SM()))
        else:
            ops.append(torch.zeros((self.J, self.J), dtype=self.dtype, device=self.device))
        return torch.stack(ops)

    def SS(self, xyz=(1.0, 1.0, 1.0)):
        """Two-site ``S.S`` as rank-4 tensor ``[i,a,j,b]``:
        ``xyz0 Sz Sz + xyz1/2 S+ S- + xyz2/2 S- S+``."""
        kron = lambda x, y: torch.einsum("ij,ab->iajb", x, y)
        return (
            xyz[0] * kron(self.SZ(), self.SZ())
            + 0.5 * xyz[1] * kron(self.SP(), self.SM())
            + 0.5 * xyz[2] * kron(self.SM(), self.SP())
        )


def get_rot_op(m: int, dtype=torch.float64, device="cuda"):
    """Bipartite sublattice-rotation operator."""
    res = np.zeros((m, m))
    for i in range(m):
        res[i, m - 1 - i] = (-1) ** i
    return torch.as_tensor(res, dtype=dtype, device=device)
