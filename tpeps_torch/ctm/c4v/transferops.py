"""Transfer-operator spectra of the C4v iPEPS (counterpart of
tpeps/ctm/c4v/transferops.py), through the Krylov loop of
:mod:`tpeps_torch.linalg.arnoldi` on the environment's device.  Spectra
come back as (n, 2) numpy arrays of (re, im)."""

from __future__ import annotations

import numpy as np
import torch

from ...linalg.arnoldi import arnoldi_eigs, seeded_start
from ..generic.transferops import get_EH_spec_Ttensor
from .corrf import _aXa, _column, apply_TM_1sO_2
from .env import EnvC4v, env_c4v_to_generic


def _spectrum(matvec, size, n, a, normalize, m):
    w = arnoldi_eigs(matvec, seeded_start(size, a), n, m=m)
    if normalize:
        w = w / np.abs(w[0])
    return np.stack([w.real, w.imag], axis=1)


def top_matvec(a, env: EnvC4v):
    """The width-1 transfer operator as a matvec on flat ``[chi, D^2, chi]``
    vectors (the double-layer site built once)."""
    chi = env.chi
    D2 = a.shape[1] ** 2
    A = _aXa(a)
    return lambda v: _column(A, env.T, v.reshape(chi, D2, chi)).reshape(-1)


@torch.no_grad()
def get_Top_spec_c4v(n: int, a, env: EnvC4v, normalize: bool = True, m: int | None = None):
    """Leading ``n`` eigenvalues of the width-1 transfer operator."""
    size = env.chi * a.shape[1] ** 2 * env.chi
    return _spectrum(top_matvec(a, env), size, n, a, normalize, m)


@torch.no_grad()
def get_EH_spec_Ttensor_c4v(n, L, a, env: EnvC4v, m: int | None = None):
    """Entanglement-Hamiltonian spectrum of a width-L cylinder, through the
    generic evaluator on the expanded single-site environment."""
    _, site_of, C, T = env_c4v_to_generic(a, env)

    class _St:
        lX = lY = 1

        def site(self, coord=(0, 0)):
            return a

        vertexToSite = staticmethod(site_of)

    class _Env:
        chi = env.C.shape[0]

    _e = _Env()
    _e.C, _e.T = C, T
    return get_EH_spec_Ttensor(n, L, (0, 0), (1, 0), _St(), _e, m=m)


@torch.no_grad()
def get_Top2_spec_c4v(n: int, a, env: EnvC4v, normalize: bool = True, m: int | None = None):
    """Leading ``n`` eigenvalues of the WIDTH-2 transfer operator."""
    chi = env.chi
    D2 = a.shape[1] ** 2
    shape = (chi, D2, D2, chi)

    def matvec(v):
        return apply_TM_1sO_2(a, env, v.reshape(shape)).reshape(-1)

    return _spectrum(matvec, chi * D2 * D2 * chi, n, a, normalize, m)
