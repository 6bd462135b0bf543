"""tpeps_torch — the PyTorch/CUDA port of tpeps for NVIDIA Hopper.

Module paths mirror :mod:`tpeps` so each function's counterpart is easy
to find.  The package imports ``torch`` and never ``jax`` (nor ``tpeps``,
whose ``__init__`` imports jax); the JAX package stays the reference the
port is tested against.

Conventions: plain functions on tensors; every constructor takes explicit
``device=`` and ``dtype=`` (``DTYPE`` is the stated default, float64) and
no global torch default is changed; entry points put their tensors on the
card unless given ``device="cpu"``.  The port holds the C4v main path: the
factored CTMRG move (forward) with the JAX package's large-D drivers (CUDA
graphs of moves, the int8 Ozaki float64 product, the mixed-precision
driver), the differentiable reference-layout move with implicit and
checkpointed gradients, the J1-J2 energy, L-BFGS and the example driver
(:mod:`tpeps_torch.examples`); and the U(1)/Z2 block-sparse tensors
(:mod:`tpeps_torch.sym`) with the C4v abelian CTMRG, dynamic and frozen,
forward.  Its device kernels live in
:mod:`tpeps_torch.kernels` with sources in ``tpeps_torch/csrc``.
"""

import torch

DTYPE = torch.float64

__all__ = ["DTYPE"]
