"""K5: several factored C4v moves as one CUDA graph, with the convergence
test on the card (counterpart of ``_jit_move`` with ``n_moves`` and
``run_fixed_point_tpu``, tpeps/ctm/c4v/move_tpu.py:258-334).

A :class:`MoveGraph` holds the loop state on static buffers
(:class:`~tpeps_torch.kernels.ctm_loop.LoopState`; it carries each move's
Procrustes rotation to the next, see
:func:`~tpeps_torch.ctm.c4v.move_factored.ctm_move_w`) and a chunk of
``n_moves`` factored moves, each followed by the ``ctm_commit`` kernel,
which commits the move only while the loop has not ended.  On the card the
chunk is captured once into a ``torch.cuda.CUDAGraph`` and replayed; a
replay launches every kernel of the chunk with no host read and no Python
in between.  On the CPU the same chunk runs eagerly (with the commit twin).

A capture bakes in the device, dtype and sizes, the move's options,
``n_moves`` and the TF32 setting in force.  The loop's limits are not among
them: they live in the state on the card, set by :meth:`MoveGraph.load`.
The drivers own their graph for the call, so its memory pool is released
when they return.
"""

from __future__ import annotations

import math
import traceback

import torch

from ...kernels import LAUNCHES
from ...kernels.ctm_loop import LoopState, ctm_commit, loop_state, reset
from ...kernels.eigh_small import EIGH_SMALL_MAX
from ...linalg.power import cold_start_basis
from .env import EnvC4v
from .move_factored import ctm_move_w, from_int_layout, to_int_layout

# a chunk that only chains moves (run_ctmrg's moves_per_sync): every move
# commits, the loop never ends on the card
CHAIN_MAX_ITER = 2**31 - 1
CHAIN_CONV_TOL = -1.0


def _failing_frame(exc: BaseException) -> str:
    """The innermost frame of the first exception in ``exc``'s chain: the op
    whose call broke the capture."""
    first = exc
    while first.__context__ is not None:
        first = first.__context__
    frames = traceback.extract_tb(first.__traceback__)
    if not frames:
        return repr(first)
    f = frames[-1]
    return f"{f.filename}:{f.lineno} `{(f.line or '').strip()}` ({type(first).__name__}: {first})"


class MoveGraph:
    """``n_moves`` factored moves, each followed by ``ctm_commit``, on static
    buffers; captured into one CUDA graph at the first :meth:`run` on the
    card (after that run has executed the chunk eagerly, so that every lazy
    set-up of cuBLAS, cuSOLVER and the kernels happens outside the capture),
    replayed at every later one.

    A launch recorded in the graph counts once per replay in
    :data:`tpeps_torch.kernels.LAUNCHES`; the capture itself counts nothing.

    :raises ValueError: on the card for chi > ``EIGH_SMALL_MAX`` (169), past
        the kernels of the move's Rayleigh-Ritz eigh and of K6
    """

    @torch.inference_mode()
    def __init__(self, a, chi: int, *, n_moves: int, conv_on: str = "spec", **move_kwargs):
        if n_moves < 1:
            raise ValueError(f"n_moves={n_moves} must be >= 1")
        if a.device.type == "cuda" and chi > EIGH_SMALL_MAX:
            raise ValueError(f"MoveGraph: chi={chi} > {EIGH_SMALL_MAX}: the factored move's "
                             "eigh_small and polar_unitary kernels take no larger chi")
        D = a.shape[1]
        self.n_moves, self.conv_on = n_moves, conv_on
        self.move_kwargs = move_kwargs
        self.a = a.clone()
        C = torch.zeros((chi, chi), dtype=a.dtype, device=a.device)
        T = torch.zeros((D, D, chi, chi), dtype=a.dtype, device=a.device)
        P = cold_start_basis(chi * D * D, chi, a.dtype, a.device)
        self.state: LoopState = loop_state(C, T, P, max_iter=0, conv_tol=0.0)
        self.graph = None
        self.launches: dict | None = None  # kernel launches per replay

    @torch.inference_mode()
    def load(self, a, C, T_int, P, *, max_iter: int, conv_tol: float, W=None) -> None:
        """Start the loop from ``(C, T_int, P)`` on the on-site tensor ``a``
        (and the Procrustes rotation ``W`` that produced ``P``, if known), to
        end after ``max_iter`` committed moves or at ``dist <= conv_tol``."""
        self.a.copy_(a)
        reset(self.state, C, T_int, P, max_iter, conv_tol, W)

    def _chunk(self) -> None:
        st = self.state
        for _ in range(self.n_moves):
            C2, T2, spec2, P2, W2 = ctm_move_w(self.a, st.C, st.T, st.P, st.W, **self.move_kwargs)
            ctm_commit(st, C2, T2, P2, W2, spec2, conv_on=self.conv_on)

    def _capture(self) -> None:
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._chunk()
        except Exception as exc:
            raise RuntimeError("MoveGraph: stream capture of the factored move failed at "
                               f"{_failing_frame(exc)}") from exc
        finally:
            recorded = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)
        self.graph, self.launches = graph, recorded

    @torch.inference_mode()
    def run(self) -> None:
        """Advance the loop by one chunk of ``n_moves`` moves."""
        if self.a.device.type != "cuda":
            self._chunk()
            return
        if self.graph is None:
            side = torch.cuda.Stream(self.a.device)
            side.wait_stream(torch.cuda.current_stream(self.a.device))
            with torch.cuda.stream(side):
                self._chunk()
            torch.cuda.current_stream(self.a.device).wait_stream(side)
            self._capture()
            return
        self.graph.replay()
        for k, v in self.launches.items():
            LAUNCHES[k] += v

    def done(self) -> bool:
        """Whether the loop has ended (one 4-byte read from the card)."""
        return bool(self.state.ctl[1].item())


@torch.inference_mode()
def run_fixed_point_factored(
    a,
    env: EnvC4v,
    *,
    max_iter: int = 100,
    conv_tol: float = 1.0e-8,
    n_power: int = 2,
    eps_multiplet: float = 1.0e-12,
    ad_decomp_reg: float = 1.0e-12,
    absorb_normalization: str = "inf",
    conv_on: str = "spec",
    slice_phys: bool = False,
    dot_impl: str = "xla",
    moves_per_sync: int = 4,
):
    """CTMRG to convergence with the factored move and the loop on the card
    (counterpart of ``run_fixed_point_tpu``): chunks of ``moves_per_sync``
    moves, one read of the ``done`` flag per chunk.  Moves of a chunk after
    the loop ended are discarded, so ``n_iter`` is exact, as the
    ``while_loop``'s.

    :param conv_on: ``"spec"``: the 2-norm of the change of |spec|;
        ``"env"``: the largest elementwise change of C and T
    :return: ``(env, n_iter, dist, P)``, public layout, from the cold-start basis
    """
    chi = env.C.shape[0]
    D = a.shape[1]
    g = MoveGraph(a, chi, n_moves=moves_per_sync, conv_on=conv_on, n_power=n_power,
                  eps_multiplet=eps_multiplet, ad_decomp_reg=ad_decomp_reg,
                  absorb_normalization=absorb_normalization, slice_phys=slice_phys,
                  dot_impl=dot_impl)
    g.load(a, env.C, to_int_layout(env.T, D),
           cold_start_basis(chi * D * D, chi, env.C.dtype, env.C.device),
           max_iter=max_iter, conv_tol=conv_tol)
    for _ in range(max(1, math.ceil(max_iter / moves_per_sync))):
        if g.done():
            break
        g.run()
    st = g.state
    n_iter, dist = int(st.ctl[0].item()), float(st.dist.item())
    return EnvC4v(st.C.clone(), from_int_layout(st.T).clone()), n_iter, dist, st.P.clone()
