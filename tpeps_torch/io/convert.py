"""Carry a state, an environment and a configuration across between the
JAX package and the port.

The JAX package's arrays go in as numpy arrays (``np.asarray`` of a jax
array), so this module needs neither package: the site tensor
``a[s,u,l,d,r]`` (also the optimizer's input ``A0``) and optionally an
environment ``(C, T)`` in public layout (``C[chi,chi]``, ``T[chi,chi,D^2]``)
become tensors on a given device (the card unless the caller says
otherwise) and dtype, and back.  A configuration goes in as the nested
dict of ``dataclasses.asdict``; a state goes across as its JSON file, which
both packages read and write bit for bit.  Abelian tensors, C4v and generic
environments and multi-site abelian states go across as block specs
(numpy block dicts with their charge metadata, :func:`abelian_to_torch`).
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .. import config as _config
from ..ctm.c4v.env import EnvC4v


def to_torch(a, env=None, *, device="cuda", dtype=torch.float64):
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


_GROUPS = {"main": _config.MainArgs, "global_args": _config.GlobalArgs,
           "peps": _config.PepsArgs, "ctm": _config.CtmArgs, "opt": _config.OptArgs}


def config_from_dict(d: dict) -> _config.Config:
    """The port's :class:`~tpeps_torch.config.Config` from a nested dict
    ``{group: {field: value}}`` with the JAX package's group and field names
    (``dataclasses.asdict`` of its ``Config``); missing groups or fields
    keep their defaults, unknown ones raise."""
    kwargs = {}
    for group, values in d.items():
        cls = _GROUPS[group]
        unknown = set(values) - {f.name for f in fields(cls)}
        if unknown:
            raise KeyError(f"{group}: unknown fields {sorted(unknown)}")
        kwargs[group] = cls(**values)
    return _config.Config(**kwargs)


def abelian_to_torch(spec, *, device="cuda", dtype=None):
    """An :class:`~tpeps_torch.sym.tensor.AbelianTensor` from ``(sym,
    signature, legs, pshifts, n, fermionic, blocks)``: ``legs`` as
    ``((charge, dim), ...)`` per leg, ``blocks`` as ``{charges: np.ndarray}``
    (the JAX package's tensor goes in as ``(t.sym, t.signature,
    [l.charges for l in t.legs], [l.pshift for l in t.legs], t.n,
    t.fermionic, {q: np.asarray(b)})``)."""
    from ..sym.tensor import AbelianTensor, LegCharges

    sym, signature, legs, pshifts, n, fermionic, blocks = spec
    blocks = {tuple(q): torch.as_tensor(np.array(b, copy=True)) for q, b in blocks.items()}
    if dtype is None:
        dtype = torch.complex128 if any(b.is_complex() for b in blocks.values()) else torch.float64
    legs = tuple(LegCharges(tuple((q, int(d)) for q, d in l), int(p)) for l, p in zip(legs, pshifts))
    return AbelianTensor(sym, tuple(signature), legs, n, blocks, dtype, fermionic=fermionic,
                         device=device)


def abelian_to_numpy(t):
    """Inverse of :func:`abelian_to_torch`."""
    return (t.sym, t.signature, tuple(l.charges for l in t.legs), tuple(l.pshift for l in t.legs),
            t.n, t.fermionic, t.numpy_blocks())


def env_c4v_abelian_to_torch(chi, C, T, *, device="cuda"):
    """An ``ENV_C4V_ABELIAN`` from the specs of ``C`` and ``T`` (see
    :func:`abelian_to_torch`)."""
    from ..ctm.c4v_abelian.env import ENV_C4V_ABELIAN

    return ENV_C4V_ABELIAN(chi, abelian_to_torch(C, device=device),
                           abelian_to_torch(T, device=device))


def env_c4v_abelian_to_numpy(env):
    """``(chi, C spec, T spec)`` of an ``ENV_C4V_ABELIAN``."""
    return env.chi, abelian_to_numpy(env.C), abelian_to_numpy(env.T)


def env_abelian_to_torch(chi, C, T, *, device="cuda"):
    """A generic ``ENV_ABELIAN`` from ``{key: spec}`` dicts of its corners and
    edges (see :func:`abelian_to_torch`)."""
    from ..ctm.generic_abelian.env import ENV_ABELIAN

    return ENV_ABELIAN(chi, {k: abelian_to_torch(s, device=device) for k, s in C.items()},
                       {k: abelian_to_torch(s, device=device) for k, s in T.items()})


def env_abelian_to_numpy(env):
    """``(chi, {key: C spec}, {key: T spec})`` of a generic ``ENV_ABELIAN``."""
    return (env.chi, {k: abelian_to_numpy(t) for k, t in env.C.items()},
            {k: abelian_to_numpy(t) for k, t in env.T.items()})


def ipeps_abelian_to_torch(sym, sites, vertexToSite=None, lX=None, lY=None, *, device="cuda"):
    """An ``IPEPS_ABELIAN`` from ``{coord: spec}`` (see :func:`abelian_to_torch`)
    and the cell's geometry."""
    from ..ipeps.ipeps_abelian import IPEPS_ABELIAN

    return IPEPS_ABELIAN(sym, {c: abelian_to_torch(s, device=device) for c, s in sites.items()},
                         vertexToSite=vertexToSite, lX=lX, lY=lY)


def ipeps_abelian_to_numpy(state):
    """``(sym, {coord: spec}, vertexToSite, lX, lY)`` of an ``IPEPS_ABELIAN``."""
    return (state.sym, {c: abelian_to_numpy(t) for c, t in state.sites.items()},
            state.vertexToSite, state.lX, state.lY)
