"""Carry a state and environment across between the JAX package and the port.

The JAX package's arrays go in as numpy arrays (``np.asarray`` of a jax
array), so this module needs neither package: the site tensor
``a[s,u,l,d,r]`` and optionally an environment ``(C, T)`` in public layout
(``C[chi,chi]``, ``T[chi,chi,D^2]``) become tensors on a given device and
dtype, and back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ctm.c4v.env import EnvC4v


def to_torch(a, env=None, *, device="cpu", dtype=torch.float64):
    """numpy ``a`` (and ``env=(C, T)``) -> tensors; returns ``a`` or ``(a, EnvC4v)``."""
    conv = lambda x: torch.as_tensor(np.array(x, copy=True), device=device).to(dtype)
    if env is None:
        return conv(a)
    C, T = env
    return conv(a), EnvC4v(conv(C), conv(T))


def to_numpy(a, env=None):
    """Tensors -> numpy arrays; returns ``a`` or ``(a, (C, T))``."""
    conv = lambda x: x.detach().cpu().numpy()
    if env is None:
        return conv(a)
    return conv(a), (conv(env.C), conv(env.T))
