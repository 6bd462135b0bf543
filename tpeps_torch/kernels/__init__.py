"""Hand-written Hopper kernels of the C4v move and of its gradient, and of
the abelian (block-sparse) CTMRG, each with a plain PyTorch twin.

Every wrapper routes by the device of its inputs: CPU tensors go to the
twin (the same math in plain torch ops, used by the CPU tests), CUDA
tensors launch the kernel or raise.  There is no fallback from a CUDA
tensor to the twin.  A wrapper computes one function, not its derivative:
it raises on an input that requires grad.  Gradients go through
``torch.autograd.Function``s (in :mod:`tpeps_torch.linalg.power`,
:mod:`tpeps_torch.sym.tensor`, :mod:`tpeps_torch.ctm.c4v_abelian.frozen`)
whose ``forward`` and ``backward`` call the wrappers on detached tensors;
the backward ones are kernels of their own (``trsm_right_lower``, ``gram``,
``polar_vjp``; ``block_gemm`` on transposed tables and ``block_permute`` on
inverse ones; ``frozen_epilogue_vjp``) or, for the implicit adjoint's loop
step, ``adjoint_commit``.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else.  A launch recorded into a CUDA
graph counts once per replay of the graph, not at capture
(:class:`tpeps_torch.ctm.c4v.move_graph.MoveGraph`).
"""

from __future__ import annotations

import torch

KERNELS = ("layer_contract", "corner_apply", "gram_ridge", "gram", "trsm_right_lower_h",
           "trsm_right_lower", "t_epilogue", "polar_unitary", "polar_vjp", "eigh_small",
           "ozaki_split", "ozaki_gemm", "ctm_commit", "block_permute", "block_gemm",
           "frozen_commit", "frozen_epilogue_vjp", "adjoint_commit", "block_permute_grad",
           "block_gemm_grad")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def route(name: str, *tensors: torch.Tensor, check_dtype: bool = True) -> bool:
    """Validate a wrapper's inputs; return True to launch the kernel
    (CUDA inputs), False for the twin (CPU inputs).  ``check_dtype=False``
    leaves the dtypes to a wrapper whose inputs mix them."""
    for t in tensors:
        if t.requires_grad:
            raise RuntimeError(f"{name} is forward-only: an input requires grad "
                               "(call it on detached tensors inside an autograd.Function)")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not check_dtype:
        return True
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64 inputs of one "
                        f"dtype, got {sorted(map(str, dtypes))}")
    return True


def suffix(t: torch.Tensor) -> str:
    return "f64" if t.dtype == torch.float64 else "f32"


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
