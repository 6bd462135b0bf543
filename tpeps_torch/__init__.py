"""tpeps_torch — the PyTorch/CUDA port of tpeps for NVIDIA Hopper.

Module paths mirror :mod:`tpeps` so each function's counterpart is easy
to find.  The package imports ``torch`` and never ``jax`` (nor ``tpeps``,
whose ``__init__`` imports jax); the JAX package stays the reference the
port is tested against.

Conventions: plain functions on tensors; every constructor takes explicit
``device=`` and ``dtype=`` (``DTYPE`` is the stated default, float64) and
no global torch default is changed.  This slice is the forward C4v CTMRG
path (factored move + RDMs + J1-J2 energy), run under
``torch.inference_mode()``; its device kernels live in
:mod:`tpeps_torch.kernels` with sources in ``tpeps_torch/csrc``.
"""

import torch

DTYPE = torch.float64

__all__ = ["DTYPE"]
