#!/usr/bin/env python3
"""Smoke run of the tpeps_torch port on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card and ``nvcc`` (CUDA_HOME, PATH or the toolkit's default
prefix).  It needs no network and no JAX.  ``python3 chip_smoke.py --ablate``
runs phases 0 and 1 and then only :func:`ablate`, the timing breakdown of
K3's Gram and solves, K7's ``ozaki_gemm`` and ``eigh_small``.

Phases (any failed check exits non-zero; there is no CPU fallback):

0. the card: name and power limit (nvidia-smi), torch/CUDA versions;
   TF32 off for matmuls and cuDNN.
1. build: nvcc compiles ``tpeps_torch/csrc/*.cu`` into
   ``tpeps_torch/_build/``; prints the build seconds.
2. kernels vs their plain torch twins on the card at the slice's shapes
   (J1-J2 C4v, D=7, chi=147), in float64 (max relative error <= 1e-12)
   and float32 (<= 1e-5, summation order differs), K1/K4 with and without
   the physical-index slicing, K6 on a near-orthogonal overlap from the
   D=7 path and on a random well-conditioned one, and with its Jacobi
   sweeps capped below convergence (the guard must give I); kernel, twin and
   library times from CUDA events, and each kernel's bound: the bytes its
   function must move at 3.35 TB/s or its FP64 operations at 67 TFLOP/s on
   the tensor cores (34 TFLOP/s off them, elementwise work), counting only
   what a symmetric result needs.  K3's ``gram_ridge`` and ``gram`` also at
   k = chi and chi + 8 in both dtypes, ``gram_ridge`` on an orthonormal
   basis and on M2 P (not orthonormal) with the path's ridge and a large
   one: against the twins, two calls bit-identical, timed against
   ``torch.matmul`` at the same precision, both in CUDA graphs (device
   time; an eager call to a ~30 us kernel is mostly host launch cost).
   K3's two solves at k = chi and chi + 8 on the L of an orthonormal basis
   (against the twins, two calls bit-identical) and on the L of
   CholeskyQR2's first pass on M2 P, on the cold start (k = chi) and on a
   graded basis of cond 1e7 (:func:`solve_checks`: kernel and twin each to
   a normwise backward error <= 1e-14 in float64, 1e-6 in float32, the
   kernel to the twin in forward error <= 2 k u cond(L)).
3. the forward slice: the D=7, chi=147 float64 state of the benchmark case
   (RandomState(0), C4v-symmetrized), init_env("CTMRG"), run_ctmrg
   (max_iter=48, conv_tol=1e-8, n_power=2), energy_1x1_lowmem (j2=0.3)
   and eval_obs.  Every forward kernel must have launched, the energy must
   be finite.  Then 4 moves of the same path with the twins (K6 included),
   against 4 moves with the kernels.
4. D=2, chi=16 end to end on the card and on the CPU (twins): energies
   agree to 1e-10.
5. the training slice at full width: 2 L-BFGS epochs of the port's entry
   point (``optimize_c4v``) on the D=7, chi=147 float64 state, POWER
   projector, implicit gradient (48 forward moves, 24 adjoint iterations),
   backtracking line search with POWER, observables and final energy with
   SYMEIG (reference-layout fixed points throughout, as the JAX script).
   Loss and gradient finite, the loss not rising, every K3 and K6 kernel
   launched, forward and backward; seconds per part, peak memory, launches.
6. D=2, chi=16 card vs CPU from one initial environment: the implicit
   gradient (POWER and SYMEIG) of RandomState(1), a state whose gradient
   the inputs fix to ~1e-10, to 1e-8 relative, and of RandomState(0),
   whose gradient an exact alternative eigensolver moves by ~2e-8, to
   1e-7; the losses of 3 L-BFGS epochs (``optimize_state``) to 1e-8.
7. the large-D slice on the benchmark state at D=7, chi=147: (a) 48 moves
   through ``run_fixed_point_factored`` (CUDA graphs of 4 moves, the loop on
   the card) against ``run_ctmrg`` with one move per host read: equal move
   counts, corner spectra <= 1e-12 apart, ms/move of both and of the graph's
   replays alone; (b) ``run_ctmrg(moves_per_sync=4)`` against the same; (c)
   one float64 move with ``dot_impl="ozaki"`` against the FP64 move from the
   same start (spectrum <= 1e-11, C and T <= 1e-10), and its ``ozaki_gemm``
   launches by shape; (d) ``MoveGraph``
   refuses chi=170, past the move's kernels on the card; (e)
   ``run_ctmrg_mixed`` with the JAX package's ``bench_case`` arguments
   (max_iter 48, conv_tol 1e-8, moves_per_sync 4, physical-index slicing
   for the float64 moves only): per-phase moves, ms/move and distance, the
   energy, peak memory and the launches; ``ozaki_split``, ``ozaki_gemm``
   and ``ctm_commit`` must launch; then the float64 ``run_ctmrg``
   (``dot_impl="xla"``) for as many moves from the same start: energies
   within 1e-8, corner spectra within 1e-5.

8. the abelian slice, U(1) C4v J1-J2 (j2=0.3) at D=8 (aux sectors
   {-2:1,-1:2,0:2,1:2,2:1}), chi=160, float64, a random state from a seeded
   generator (C4v-projected, normalized) written to JSON: (a) K8
   ``block_permute`` (bit-exact) and ``block_gemm`` on each of a dynamic
   move's ten tensordots (<= 1e-12 relative) and K9 ``frozen_commit`` (C, T
   bit-exact, dist2 <= 1e-12 relative) against their twins at the move's
   shapes, with kernel, twin and bound times (``block_gemm``'s twin is the
   JAX package's design: one ``torch.bmm`` per shape group and
   ``index_add_``); the sector SVD drivers timed on the largest +-q sector;
   (b) the entry point ``tpeps_torch.examples.j1j2.abelian.ctmrg_j1j2_c4v_u1``
   on that file (8 dynamic moves): ms/move, host planning, the device busy
   share over two more moves, energy, observables, peak memory, the chi
   profile; (c) the JAX package's benchmark case: 4 dynamic moves, freeze,
   ``close_structure``, ``run_frozen(max_iter=10, conv_tol=0)`` (ms per
   frozen move, split into corner, decompositions, absorption and commit),
   the same 10 moves dynamic against it (energies within AB_E_FROZEN_TOL,
   the dynamic profile against ``keep``), ``converge_frozen`` to 1e-8 or 24
   moves with its energy; (d) D=3, chi=18 card against the CPU twins: 6
   dynamic moves' spectra and the energy (1e-10), one more move's busy share
   read three ways, 10 frozen moves (C elementwise, T's magnitudes
   elementwise, 1e-10).
9. the abelian training slice on phase 8's D=8 chi=160 state: (a) at a
   frozen move's shapes, the backward tables of its ten tensordots
   (``block_gemm`` on the dA and dB tables, <= 1e-12 relative;
   ``block_permute`` on the largest operand's inverse table, bit-exact),
   ``frozen_epilogue_vjp`` (<= 1e-12 relative) and ``adjoint_commit`` (one
   step <= 1e-12 relative; the loop on crafted |u|^2 sequences, counters
   bit-exact) against their twins, with
   kernel, twin and bound times; (b) one closure of
   ``optimize_c4v_abelian`` (the context: AB_CLOSURE_MOVES dynamic moves and
   plans; the frozen forward; the adjoint's iterations, ms each, converged or
   diverged, R != 1; the energy forward and backward; peak memory; the
   central difference along the gradient, > 0, next to |g|; at the
   closure's frozen fixed point the kept sector gaps, one more move's drift
   and one move's VJP norm; the backward's device busy share on a second
   closure); (c) two L-BFGS epochs
   of the entry point ``tpeps_torch.examples.j1j2.abelian.optim_j1j2_c4v_u1``
   (``--chi 160 --j2 0.3 --opt_max_iter 2 --OPTARGS_line_search
   backtracking --CTMARGS_ctm_max_iter AB_GRAD_MOVES``) on the written state:
   losses finite and not rising, every kernel of the path launched; (d)
   U(1) D=3 chi=9: the gradient on the card against the CPU twins' from one
   CPU-built closed (C0, T0), 1e-8 relative.
10. the generic-cell abelian slice, a U(1) 2-site bipartite J1-J2 state
   (j2=0.3) at D=8 (bench's aux profile), chi=160, float64: two random sites
   from one seeded generator, each C4v-projected and flipped to the canonical
   signature, written to JSON.  (b) the entry point
   ``tpeps_torch.examples.j1j2.abelian.ctmrg_j1j2_u1 --tiling BIPARTITE`` for
   GEN_ENTRY_SWEEPS sweeps (ms per sweep, host planning, energy, observables,
   chi profiles, peak memory) and one more directional move's busy share;
   (e) GEN_TRAIN_EPOCHS L-BFGS epoch(s) of
   ``tpeps_torch.examples.j1j2.abelian.optim_j1j2_u1`` on the same file
   (GEN_TRAIN_SWEEPS sweeps per context and frozen fixed point, the adjoint
   at most GEN_ADJ_MAX_ITER iterations; losses and gradients finite, every
   kernel of the path launched), whose first gradient closure is (d)
   (frozen forward, adjoint, energy both ways, peak memory); on the closed
   context of (e)'s epoch, (a) K10 against its twins at one frozen move's
   shapes (``generic_epilogue`` bit-exact, ``sweep_commit``'s state
   bit-exact and dist2 <= 1e-12 relative, ``generic_epilogue_vjp`` both ways
   <= 1e-12 relative) with kernel, twin and bound times, and (c) the frozen
   sweep (ms per sweep split into halves, decompositions, absorption,
   epilogue/commit; busy share; no plan built) and the same sweeps
   dynamically (energies within AB_E_FROZEN_TOL); (f) D=3: chi=18 dynamic
   spectra and energy (GEN_SMALL_DYN sweeps) and 3 frozen sweeps (C, |T|)
   card vs CPU (1e-10), the chi=9 gradient from a converged context card vs
   CPU (1e-8 relative) and, on the card, the central difference along g/|g|
   (> 0) next to |g|.

Phase 2 also holds the kernels of the large-D slice against their twins at
its shapes: ``eigh_small`` on the Rayleigh-Ritz H of moves 4 and 31 of the
D=7 path, at subspace_eigh's width (155), on a dense 64 (the D=2 SYMEIG
shape), on an H with exactly degenerate pairs and on a dense random matrix
of its largest k, 169 (converged, eigenvalues <= 1e-12 relative, residual
and orthogonality <= 1e-12, two calls bit-identical), ``ozaki_split`` on
the corner M2 (7203 x 7203), a basis P (7203 x 147) and a layer's operands
(98 x 49, 49 x 1.06M) (digit planes and exponents bit-identical),
``ozaki_gemm`` bit-identical to its twin (``torch.equal``) at every product
shape of the Ozaki move (M2 P; C T, 147 x 147 by 147 x 7203; T (C T) and T P,
7203 x 147 by 147 x 7203; the sliced layer, 49 x 49 by 49 x 1.06M; P^T Z, 147
x 7203 by 7203 x 7203) and at the unsliced ket and bra layers (98 x 49 by
49 x 1.06M, 49 x 98 by 98 x 1.06M), each timed against FP64
``torch.matmul`` with its own bound, ``ctm_commit``
in both convergence modes (state identical, dist <= 1e-12 relative), a loop
that ended, and one that reaches max_iter.

The last two lines of stdout are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

D, CHI, D_SMALL, CHI_SMALL = 7, 147, 2, 16
MAX_ITER, CONV_TOL, N_POWER = 48, 1e-8, 2
J1, J2 = 1.0, 0.3
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the solves' normwise backward error on ill-conditioned L (solve_checks)
BWD_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}
TWIN_MOVES, TWIN_SPEC_TOL = 4, 1e-8
E_SMALL_TOL = 1e-10
TRAIN_EPOCHS, TRAIN_MAX_ITER, TRAIN_ADJ_ITER = 2, 48, 24
LOSS_SMALL_TOL, SMALL_EPOCHS = 1e-8, 3
# phase 6's states and their gradient tolerances: an exact alternative
# eigensolver moves RandomState(1)'s implicit gradient by 1.2e-10 (POWER),
# 2.7e-11 (SYMEIG) on the CPU, RandomState(0)'s by 1.1e-8 / 2.0e-8
SMALL_SEED = 1
GRAD_SMALL_TOL = {1: 1e-8, 0: 1e-7}
SOURCES = {  # kernel -> (source, TPU-path function it replaces)
    "layer_contract": ("tpeps_torch/csrc/layer_contract.cu", "tpeps/ctm/c4v/move_tpu.py:87"),
    "corner_apply": ("tpeps_torch/csrc/corner_apply.cu", "tpeps/ctm/c4v/move_tpu.py:121"),
    "gram_ridge": ("tpeps_torch/csrc/cholqr.cu", "tpeps/linalg/power.py:133"),
    "gram": ("tpeps_torch/csrc/cholqr.cu", "tpeps/linalg/power.py:86"),
    "trsm_right_lower_h": ("tpeps_torch/csrc/cholqr.cu", "tpeps/linalg/power.py:133"),
    "trsm_right_lower": ("tpeps_torch/csrc/cholqr.cu", "tpeps/linalg/power.py:145"),
    "t_epilogue": ("tpeps_torch/csrc/t_epilogue.cu", "tpeps/ctm/c4v/move_tpu.py:239"),
    "polar_unitary": ("tpeps_torch/csrc/polar.cu", "tpeps/linalg/power.py:32"),
    "polar_vjp": ("tpeps_torch/csrc/polar.cu", "tpeps/linalg/power.py:124"),
    "eigh_small": ("tpeps_torch/csrc/eigh_small.cu", "tpeps/ctm/c4v/move_tpu.py:147"),
    "ozaki_split": ("tpeps_torch/csrc/ozaki.cu", "tpeps/linalg/ozaki.py:39"),
    "ozaki_gemm": ("tpeps_torch/csrc/ozaki.cu", "tpeps/linalg/ozaki.py:92"),
    "ctm_commit": ("tpeps_torch/csrc/ctm_commit.cu", "tpeps/ctm/c4v/move_tpu.py:258"),
    "block_permute": ("tpeps_torch/csrc/block_sparse.cu", "tpeps/sym/tensor.py:294"),
    "block_gemm": ("tpeps_torch/csrc/block_sparse.cu", "tpeps/sym/tensor.py:342"),
    "frozen_commit": ("tpeps_torch/csrc/frozen_commit.cu",
                      "tpeps/ctm/c4v_abelian/frozen.py:128"),
    # the abelian training path: K8 on backward tables, K9's backward
    "block_permute_grad": ("tpeps_torch/csrc/block_sparse.cu", "tpeps/sym/tensor.py:294"),
    "block_gemm_grad": ("tpeps_torch/csrc/block_sparse.cu", "tpeps/sym/tensor.py:435"),
    "frozen_epilogue_vjp": ("tpeps_torch/csrc/frozen_commit.cu",
                            "tpeps/ctm/c4v_abelian/frozen.py:73"),
    "adjoint_commit": ("tpeps_torch/csrc/frozen_commit.cu",
                       "tpeps/ctm/c4v_abelian/frozen.py:201"),
    # the generic abelian frozen loop (K10)
    "generic_epilogue": ("tpeps_torch/csrc/frozen_generic.cu",
                         "tpeps/ctm/generic_abelian/frozen.py:35"),
    "sweep_commit": ("tpeps_torch/csrc/frozen_generic.cu",
                     "tpeps/ctm/generic_abelian/frozen.py:179"),
    "generic_epilogue_vjp": ("tpeps_torch/csrc/frozen_generic.cu",
                             "tpeps/ctm/generic_abelian/frozen.py:198"),
}
FORWARD = ("layer_contract", "corner_apply", "gram_ridge", "gram", "trsm_right_lower_h",
           "t_epilogue", "polar_unitary", "eigh_small")
# the large-D slice (phase 7): the on-card loop and the Ozaki polish
LARGE_D = ("ozaki_split", "ozaki_gemm", "ctm_commit")
OZ_MOVE_SPEC_TOL, OZ_MOVE_ENV_TOL = 1e-11, 1e-10
GRAPH_SPEC_TOL, MOVES_PER_SYNC = 1e-12, 4
EIGH_BIG = 169  # eigh_small's largest k, the factored move's largest chi on the card
# the mixed driver against the float64 driver for as many moves from the same
# start (neither converged): one reading on the H100 gave |dE| 1.3e-10 and
# spectra 3.6e-7 apart
MIXED_E_TOL, MIXED_SPEC_TOL = 1e-8, 1e-5
# the training path (reference-layout moves and their VJPs): K3 and K6
TRAIN = ("gram_ridge", "gram", "trsm_right_lower_h", "trsm_right_lower", "polar_unitary",
         "polar_vjp")
# the abelian slice (phase 8): bench.py's U(1) C4v D=8 profile at chi=160
AB_PHYS, AB_AUX, AB_CHI = {-1: 1, 1: 1}, {-2: 1, -1: 2, 0: 2, 1: 2, 2: 1}, 160
AB_ENTRY_MOVES, AB_WARM_MOVES, AB_FROZEN_MOVES = 8, 4, 10
AB_CONVERGE_ITER, AB_CONVERGE_TOL = 24, 1e-8  # 48 before phase 10 needed the time
AB_PK = dict(svd_reltol=1e-12, eps_multiplet=1e-12)  # bench.py's projector arguments
AB_SMALL_AUX, AB_SMALL_CHI, AB_SMALL_TOL = {-1: 1, 0: 1, 1: 1}, 18, 1e-10
# the frozen against the dynamic engine over the same 10 moves from the
# frozen start (neither converged): one reading on the H100 gave |dE| 3.3e-6
AB_E_FROZEN_TOL = 1e-4
ABELIAN = ("block_permute", "block_gemm", "frozen_commit")
# the abelian training path (phase 9): ctm_max_iter of its contexts and
# frozen fixed points (the dynamic moves per context and the frozen moves per
# loss) in the two epochs and in the one closure, the D=3 card-vs-CPU
# gradient's chi, frozen moves and tolerance
AB_GRAD_MOVES, AB_CLOSURE_MOVES = 24, 12
AB_TRAIN = ("block_permute", "block_gemm", "block_permute_grad", "block_gemm_grad",
            "frozen_commit", "frozen_epilogue_vjp", "adjoint_commit")
AB_GRAD_SMALL_CHI, AB_GRAD_SMALL_ITER, AB_GRAD_SMALL_TOL = 9, 40, 1e-8
# crafted adjoint sequences: (lambda_C, lambda_T, |ybar_T| / |ybar_C|, max_iter)
AB_ADJ_CASES = {"converging": (0.5, 0.5, 1.0, 100), "four_growths": (1.2, 1.2, 1.0, 100),
                "blow_up": (200.0, 0.5, 1.0, 100), "max_iter": (0.99, 0.99, 1.0, 7),
                "decay_then_growth": (0.3, 1.5, 1e-3, 100)}
# the generic abelian slice (phase 10): a U(1) 2-site bipartite state at bench's
# D=8 profile, chi=160; sweeps of the entry point (b), of the frozen run and of
# its dynamic twin (c), and of the training entry point's contexts and frozen
# fixed points (e), whose adjoint takes at most GEN_ADJ_MAX_ITER iterations,
# and its epochs: a D=8 chi=160 sweep takes 15-27 s on the H100, an epoch
# makes two gradients, and two epochs did not fit the script's 1200 s; the
# D=3 card-vs-CPU check (f): chi, dynamic sweeps, frozen sweeps, gradient
# tolerance
GEN_ENTRY_SWEEPS, GEN_FROZEN_SWEEPS, GEN_TRAIN_SWEEPS, GEN_ADJ_MAX_ITER = 1, 1, 1, 1
GEN_TRAIN_EPOCHS = 1
GEN_SMALL_CHI, GEN_SMALL_DYN, GEN_SMALL_FROZEN = 18, 3, 3
GEN_GRAD_SMALL_CHI, GEN_GRAD_SMALL_TOL = 9, 1e-8
GENERIC = ("block_permute", "block_gemm", "generic_epilogue", "sweep_commit")
GEN_TRAIN = ("block_permute", "block_gemm", "block_permute_grad", "block_gemm_grad",
             "generic_epilogue", "sweep_commit", "generic_epilogue_vjp", "adjoint_commit")
GEN_K10 = ("generic_epilogue", "sweep_commit", "generic_epilogue_vjp")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP64 on the tensor cores
# (DMMA) and on the CUDA cores
HBM_BPS, FP64_TC, FP64_CC, INT8_TC = 3.35e12, 67e12, 34e12, 1979e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {msg}", flush=True)
    if not ok:
        fail(msg)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call, from a CUDA graph of ``reps``
    calls replayed ``replays`` times, after one eager warm-up: no host
    launch cost, which is most of an eager call to a ~30 us kernel."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del g
    return ms


def rel_err(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def bound(nbytes: float, flops: float, peak: float):
    """Least time (ms) for the work: bytes over HBM rate vs operations over
    ``peak``; returns ``(ms, "bytes" | "operations")``."""
    t_b, t_o = nbytes / HBM_BPS, flops / peak
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@contextlib.contextmanager
def twins_on_card():
    """Route every kernel call of the move and of its gradient to its plain
    twin (comparison only); fails if a kernel launches inside.  Launch
    counts are restored after."""
    from tpeps_torch.ctm.c4v import move_factored, move_graph
    from tpeps_torch.kernels import (LAUNCHES, cholqr, corner, ctm_loop, eigh_small, epilogue,
                                     layer, ozaki, polar)
    from tpeps_torch.linalg import eigh, power
    from tpeps_torch.linalg import ozaki as ozaki_linalg

    def commit_twin(st, C2, T2, P2, W2, spec2, *, conv_on="spec"):
        ctm_loop.ctm_commit_twin(st, C2, T2, P2, W2, spec2, conv_on)

    before = dict(LAUNCHES)
    with mock.patch.object(eigh, "eigh_small", eigh_small.eigh_small_twin), \
            mock.patch.object(ozaki_linalg, "ozaki_split", ozaki.ozaki_split_twin), \
            mock.patch.object(ozaki_linalg, "ozaki_gemm", ozaki.ozaki_gemm_twin), \
            mock.patch.object(move_graph, "ctm_commit", commit_twin), \
            mock.patch.object(move_factored, "layer_contract", layer.layer_contract_twin), \
            mock.patch.object(move_factored, "corner_apply", corner.corner_apply_twin), \
            mock.patch.object(move_factored, "t_epilogue", epilogue.t_epilogue_twin), \
            mock.patch.object(power, "gram_ridge", cholqr.gram_ridge_twin), \
            mock.patch.object(power, "gram", cholqr.gram_twin), \
            mock.patch.object(power, "trsm_right_lower_h", cholqr.trsm_right_lower_h_twin), \
            mock.patch.object(power, "trsm_right_lower", cholqr.trsm_right_lower_twin), \
            mock.patch.object(power, "polar_unitary_kernel", polar.polar_unitary_twin), \
            mock.patch.object(power, "polar_vjp", polar.polar_vjp_twin):
        yield
    if LAUNCHES != before:
        fail(f"a kernel launched on the twin path: {before} -> {LAUNCHES}")


def bench_state(D_, device, dtype=torch.float64, seed=0):
    from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v

    rng = np.random.RandomState(seed)
    a = torch.as_tensor(rng.rand(2, D_, D_, D_, D_) - 0.5, dtype=torch.float64)
    return symmetrize_c4v(a, normalize=True).to(device=device, dtype=dtype)


def phase0() -> str:
    print("== phase 0: device", flush=True)
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs one GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 disabled for matmul and cuDNN (torch.backends.*.allow_tf32 = False)")
    return smi


def phase1() -> None:
    print("== phase 1: build", flush=True)
    from tpeps_torch.kernels.build import build

    lib = build()
    print(f"  built {lib.path.name} in {lib.build_seconds:.1f} s")
    for name, line in ptxas_lines(lib.build_log):
        print(f"  ptxas: {name}: {line}")


def ptxas_lines(log: str):
    """(kernel, line) for each ptxas register or spill line of an nvcc log."""
    name = ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:  # the kernel's name: after the file's 8-digit hash, a length, the identifier
            name = entry.group(1)
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
            if m:
                n = int(m.group(1))
                name = name[m.end():m.end() + n + 12]  # and the start of its template arguments
        elif "registers" in line or "spill" in line:
            yield name, line.strip()


def near_unitary_overlap(a, C, T_int, n_moves: int = 3):
    """The Procrustes overlap ``O = P^T P_prev`` (masked, ridged) of move
    ``n_moves + 1`` of the D=7 path from the cold start: what K6 sees there."""
    from tpeps_torch.ctm.c4v import move_factored as mf
    from functools import partial

    P = mf.cold_start_basis(CHI * D * D, CHI, a.dtype, a.device)
    for _ in range(n_moves):
        C, T_int, _, P = mf.ctm_move_sl_factored(a, C, T_int, P, n_power=N_POWER)
    M2 = mf._c2x2_factored(a, C, T_int)
    Dspec, Pn = mf._subspace_eigh_op(partial(mf._m_apply, M2), P, CHI, N_POWER, 1e-12, 1e-12)
    m = (Dspec.abs() > 0).to(a.dtype)
    eye = torch.eye(CHI, dtype=a.dtype, device=a.device)
    O = (Pn.mT @ P) * (m[:, None] * m[None, :]) + (1.0 - m)[:, None] * eye
    return (O + 1e-12 * eye).contiguous()


def well_conditioned(k, gen, dtype, dev):
    """Random ``Q1 diag(s) Q2`` with singular values in [0.5, 2]."""
    q = lambda: torch.linalg.qr(torch.randn(k, k, generator=gen, device=dev,
                                            dtype=torch.float64)).Q
    s = 0.5 + 1.5 * torch.rand(k, generator=gen, device=dev, dtype=torch.float64)
    return ((q() * s) @ q()).to(dtype).contiguous()


def graded(n, k, cond, gen, dev):
    """A tall float64 ``Q1 diag(s) Q2^T`` (n, k) with singular values
    log-spaced from 1 to ``1 / cond``."""
    q = lambda m: torch.linalg.qr(torch.randn(m, k, generator=gen, device=dev,
                                              dtype=torch.float64)).Q
    s = torch.logspace(0, -math.log10(cond), k, dtype=torch.float64, device=dev)
    return ((q(n) * s) @ q(k).mT).contiguous()


def time_case(rec, name, kern, twin, lib, nb, ops, peak):
    """Kernel, twin and library times (kernel, twin, twin, kernel: a drift of
    clocks hits both alike), the bound, and the kernel's max abs error
    against the twin (outputs cloned: K1's layers reuse their buffer)."""
    as_tuple = lambda x: tuple(t.clone() for t in (x if isinstance(x, tuple) else (x,)))
    ref = as_tuple(twin())
    out = as_tuple(kern())
    err = max(float((x.double() - y.double()).abs().max()) for x, y in zip(out, ref))
    ms, plain_ms = cuda_ms(kern), cuda_ms(twin)
    plain_ms2, ms2 = cuda_ms(twin), cuda_ms(kern)
    bound_ms, bound_by = bound(nb, ops, peak)
    rec[name] = {"max_abs_err": err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": cuda_ms(lib) if lib is not None else None}
    lib_txt = f", library {rec[name]['library_ms']:.3f} ms" if lib is not None else ""
    print(f"  {name}: kernel {rec[name]['ms']:.3f} ms, twin {rec[name]['plain_ms']:.3f} ms"
          f"{lib_txt}, bound {bound_ms:.4f} ms ({bound_by}), max abs err {err:.2e}")


def solve_orthonormal(L, P, tol, tag) -> None:
    """K3's two solves on the L of an orthonormal basis (near I) against the
    twins to ``tol``; two calls bit-identical."""
    from tpeps_torch.kernels import cholqr

    for name in ("trsm_right_lower_h", "trsm_right_lower"):
        kern, twin = getattr(cholqr, name), getattr(cholqr, f"{name}_twin")
        Q1, Q2 = kern(L, P), kern(L, P)
        e = rel_err(Q1, twin(L, P))
        check(e <= tol and torch.equal(Q1, Q2), f"K3 {name} {tag}, L of an orthonormal "
              f"basis: rel err {e:.2e} <= {tol:.0e}, two calls bit-identical")


def solve_checks(label, L0, P0, dtype) -> None:
    """K3's two solves on the ``L0`` of a basis that is not orthonormal
    (float64; rounded with ``P0`` to ``dtype``).  Kernel and twin each to a
    backward error ``||Q L^T - P||_F / (||Q||_F ||L||_F) <= BWD_TOL``
    (``X L - B`` for the backward solve; in float64), the kernel to the twin
    in forward error
    ``||Q - Q_twin||_F / ||Q_twin||_F <= 2 k u cond(L)``: each is backward
    stable to about k u, and a backward error e moves the solution by up to
    cond(L) e; two calls bit-identical."""
    from tpeps_torch.kernels import cholqr

    L, P = L0.to(dtype).contiguous(), P0.to(dtype).contiguous()
    k, u = L.shape[0], torch.finfo(dtype).eps / 2
    cond = float(torch.linalg.cond(L.double()))
    fwd_tol = 2 * k * u * cond
    tag = str(dtype).replace("torch.", "")
    for name, lhs in (("trsm_right_lower_h", L.mT), ("trsm_right_lower", L)):
        kern, twin = getattr(cholqr, name), getattr(cholqr, f"{name}_twin")
        Q1, Q2, Qt = kern(L, P), kern(L, P), twin(L, P)

        def bwd(Q):
            R = Q.double() @ lhs.double() - P.double()
            return float(torch.linalg.norm(R) / (torch.linalg.norm(Q.double())
                                                 * torch.linalg.norm(L.double())))
        b_k, b_t = bwd(Q1), bwd(Qt)
        e = float(torch.linalg.norm((Q1 - Qt).double()) / torch.linalg.norm(Qt.double()))
        check(b_k <= BWD_TOL[dtype] and b_t <= BWD_TOL[dtype] and e <= fwd_tol
              and torch.equal(Q1, Q2),
              f"K3 {name} {tag}, L of {label} (cond {cond:.2e}): backward error kernel "
              f"{b_k:.2e}, twin {b_t:.2e} <= {BWD_TOL[dtype]:.0e}; forward error against the twin "
              f"{e:.2e} <= 2 k u cond(L) = {fwd_tol:.2e}; two calls bit-identical")


def phase2(dev) -> dict:
    """Kernel vs twin at the slice's shapes; returns per-kernel records."""
    print(f"== phase 2: kernels vs twins at D={D}, chi={CHI}", flush=True)
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.kernels import cholqr, corner, epilogue, layer, polar

    rec, gram_shapes = {}, {}
    for dtype in (torch.float64, torch.float32):
        tol, tag = TOL[dtype], str(dtype).replace("torch.", "")
        a = bench_state(D, dev, dtype)
        env = init_env(a, CHI, "CTMRG")
        T_int = mf.to_int_layout(env.T, D)
        gen = torch.Generator(device=dev).manual_seed(1)
        P = torch.randn(CHI * D * D, CHI, generator=gen, device=dev, dtype=dtype)
        P = torch.linalg.qr(P).Q.contiguous()
        with torch.inference_mode():
            for sp in (False, True):
                M2 = mf._c2x2_factored(a, env.C, T_int, slice_phys=sp)
                with twins_on_card():
                    M2t = mf._c2x2_factored(a, env.C, T_int, slice_phys=sp)
                e = rel_err(M2, M2t)
                check(e <= tol, f"K1 c2x2_factored {tag} slice_phys={sp}: rel err {e:.2e} <= {tol:.0e}")
                for norm in ("inf", "fro"):
                    nT = mf.t_epilogue(mf._absorb_T_int(a, T_int, P, CHI, CHI, sp), norm)
                    with twins_on_card():
                        nTt = mf.t_epilogue(mf._absorb_T_int(a, T_int, P, CHI, CHI, sp), norm)
                    e = rel_err(nT, nTt)
                    check(e <= tol, f"K4 absorb+epilogue {tag} slice_phys={sp} norm={norm}: "
                                    f"rel err {e:.2e} <= {tol:.0e}")
            e = rel_err(corner.corner_apply(M2, P), corner.corner_apply_twin(M2, P))
            check(e <= tol, f"K2 corner_apply {tag}: rel err {e:.2e} <= {tol:.0e}")
            G = cholqr.gram_ridge(P, 1e-12)
            e = rel_err(G, cholqr.gram_ridge_twin(P, 1e-12))
            check(e <= tol, f"K3 gram_ridge {tag}: rel err {e:.2e} <= {tol:.0e}")
            L = torch.linalg.cholesky(G).contiguous()
            Pm = M2 @ P  # a realistic right-hand side
            solve_orthonormal(L, Pm, tol, tag)
            # the L of cholesky_qr2's first pass, on M2 P (P orthonormal, M2 P
            # not), on the cold start (M2 times cold_start_basis) and on a
            # graded basis (cond 1e7), with the path's 1e-12 ridge, built in
            # float64 (rounded for float32), the right-hand side the basis;
            # the first pass also at chi + 8 (below)
            if dtype == torch.float64:
                ill, gen_g = {}, torch.Generator(device=dev).manual_seed(2)
                for label, P0 in (("first pass on M2 P", M2 @ P),
                                  ("cold start", M2 @ mf.cold_start_basis(CHI * D * D, CHI,
                                                                           dtype, dev)),
                                  ("graded basis", graded(CHI * D * D, CHI, 1e7, gen_g, dev)),
                                  (f"graded basis, k={CHI + 8}",
                                   graded(CHI * D * D, CHI + 8, 1e7, gen_g, dev))):
                    P0 = P0.contiguous()
                    ill[label] = (torch.linalg.cholesky(cholqr.gram_ridge_twin(P0, 1e-12)), P0)
            e = rel_err(cholqr.gram(Pm, P), cholqr.gram_twin(Pm, P))
            check(e <= tol, f"K3 gram (two operands) {tag}: rel err {e:.2e} <= {tol:.0e}")
            # both Grams and the solves at the move's two widths (chi, and chi
            # + 8 in subspace_eigh): against the twins, two calls
            # bit-identical, the Grams timed against torch.matmul at the same
            # precision.  The solves at chi + 8 as at chi above: on the L of
            # an orthonormal basis and of the first pass on M2 P.  gram_ridge
            # on an orthonormal basis and on M2 P, which is not (as
            # cholesky_qr2's first pass sees it: every tile of G, the
            # mirrored ones too, of the size of the largest), with the
            # path's ridge and with one large enough to show
            for k in (CHI, CHI + 8):
                Pk = torch.linalg.qr(torch.randn(CHI * D * D, k, generator=gen, device=dev,
                                                 dtype=torch.float64)).Q.to(dtype).contiguous()
                Qk = (M2 @ Pk).contiguous()
                if k != CHI:
                    Lk = torch.linalg.cholesky(cholqr.gram_ridge_twin(Pk, 1e-12)).contiguous()
                    solve_orthonormal(Lk, Qk, tol, f"{tag} k={k}")
                    if dtype == torch.float64:
                        ill[f"first pass on M2 P, k={k}"] = (
                            torch.linalg.cholesky(cholqr.gram_ridge_twin(Qk, 1e-12)), Qk)
                for name, kern, twin in (
                        ("gram_ridge orthonormal", lambda: cholqr.gram_ridge(Pk, 1e-12),
                         lambda: cholqr.gram_ridge_twin(Pk, 1e-12)),
                        ("gram_ridge eps=0.25", lambda: cholqr.gram_ridge(Qk, 0.25),
                         lambda: cholqr.gram_ridge_twin(Qk, 0.25)),
                        ("gram_ridge", lambda: cholqr.gram_ridge(Qk, 1e-12),
                         lambda: cholqr.gram_ridge_twin(Qk, 1e-12)),
                        ("gram", lambda: cholqr.gram(Qk, Pk), lambda: cholqr.gram_twin(Qk, Pk))):
                    G1, G2 = kern(), kern()
                    e = rel_err(G1, twin())
                    check(e <= tol and torch.equal(G1, G2),
                          f"K3 {name} {tag} k={k}: rel err {e:.2e} <= {tol:.0e}, two calls "
                          "bit-identical")
                    if " " in name:
                        continue
                    mm = lambda: torch.matmul(Qk.mT, Pk)  # the same shapes as either Gram
                    ms, lib_ms = graph_ms(kern), graph_ms(mm)
                    lib_ms, ms = min(lib_ms, graph_ms(mm)), min(ms, graph_ms(kern))
                    print(f"  {name} {tag} {CHI * D * D} x {k} (in CUDA graphs): kernel "
                          f"{ms:.4f} ms, torch.matmul {lib_ms:.4f} ms")
                    gram_shapes.setdefault(name, {})[f"{tag} k={k}"] = {
                        "ms": ms, "matmul_ms": lib_ms}
                del Pk, Qk
            for label, (L0, P0) in ill.items():
                solve_checks(label, L0, P0, dtype)
            # K6's overlaps come from the float64 path, rounded for float32
            if dtype == torch.float64:
                overlaps = (near_unitary_overlap(a, env.C, T_int),
                            near_unitary_overlap(a, env.C, T_int, n_moves=30),
                            near_unitary_overlap(a, env.C, T_int, n_moves=0),
                            well_conditioned(CHI, gen, dtype, dev))
            O_path, O_late, O_cold, O_rand = (O.to(dtype) for O in overlaps)
            info = torch.zeros(5, dtype=torch.int32, device=dev)
            for label, O in (("O of move 4 of the D=7 path", O_path),
                             ("O of move 31 of the D=7 path", O_late),
                             ("random well-conditioned O", O_rand)):
                W = polar.polar_unitary(O, info=info)
                e = rel_err(W, polar.polar_unitary_twin(O))
                sweeps, conv, cond_ok, finite, ns = info.tolist()
                branch = "Newton-Schulz" if ns else f"Jacobi, {sweeps} sweeps, converged={bool(conv)}"
                check(e <= tol, f"K6 polar_unitary {tag}, {label}: rel err {e:.2e} <= {tol:.0e} "
                                f"({branch}, well-conditioned={bool(cond_ok)}, finite={bool(finite)})")
            # the Jacobi branch on the cold-start overlap of the first move
            # (near the guard's threshold the two eigensolvers may decide
            # differently; that case is held to phase 3's spectrum check)
            W = polar.polar_unitary(O_cold, info=info)
            Wt = polar.polar_unitary_twin(O_cold)
            sweeps, conv, cond_ok, finite, ns = info.tolist()
            twin_ok = not torch.equal(Wt, torch.eye(CHI, dtype=dtype, device=dev))
            e = rel_err(W, Wt)
            what = (f"K6 polar_unitary {tag}, cold-start O (Jacobi branch: {not ns}, {sweeps} "
                    f"sweeps; guards pass: kernel {bool(cond_ok and finite)}, twin {twin_ok})")
            if bool(cond_ok and finite) == twin_ok:
                check(e <= tol, f"{what}: rel err {e:.2e} <= {tol:.0e}")
            else:
                print(f"  [note] {what}: the guards decided differently")
            # the Jacobi branch capped at one sweep does not converge: I
            W = polar.polar_unitary(O_path, info=info, max_sweeps=1)
            sweeps, conv, _, _, ns = info.tolist()
            check(not ns and not conv and torch.equal(W, torch.eye(CHI, dtype=dtype, device=dev)),
                  f"K6 polar_unitary {tag}, Jacobi capped at 1 sweep: not converged "
                  f"(converged={bool(conv)}), W = I")
            W = polar.polar_unitary(O_path)
            Wb = torch.randn(CHI, CHI, generator=gen, device=dev, dtype=dtype)
            e = rel_err(polar.polar_vjp(W, Wb), polar.polar_vjp_twin(W, Wb))
            check(e <= tol, f"K6 polar_vjp {tag}: rel err {e:.2e} <= {tol:.0e}")
            if dtype != torch.float64:
                continue
            # per-kernel timing (f64, the slice's dtype), max abs error, the
            # bound and, where one torch call computes the same function, its
            # time; layer_contract is timed as K1's two launches (ket K=49,
            # bra K=98), its library call as one einsum of both layers
            q1 = (T_int.permute(0, 1, 3, 2).reshape(D * D * CHI, CHI)
                  @ (env.C @ T_int.permute(3, 0, 1, 2).reshape(CHI, D * D * CHI)))
            Xk = q1.view(D, D, CHI, D, D, CHI).permute(3, 0, 1, 2, 4, 5)
            Wk = a.permute(0, 3, 4, 1, 2).reshape(2 * D * D, D * D).contiguous()
            Wbr = a.conj().permute(3, 4, 0, 1, 2).reshape(D * D, 2 * D * D).contiguous()
            q = torch.empty((2, D, D, D, CHI, D, CHI), dtype=dtype, device=dev)
            M2b = torch.empty((CHI, D, D, CHI, D, D), dtype=dtype, device=dev)

            def k1_layers(fn):
                fn(Wk, Xk, q, 2)
                fn(Wbr, q.permute(0, 5, 3, 1, 2, 4, 6), M2b.permute(2, 5, 1, 4, 0, 3), 3)
                return M2b

            nT_raw = mf._absorb_T_int(a, T_int, P, CHI, CHI)
            n, k = Pm.shape
            # K6 is timed on the overlap of move 31 (the Newton-Schulz branch,
            # which most moves take) and on move 4's (the Jacobi branch of the
            # first moves).  Its bound is the function's, whichever branch:
            # the symmetric Gram O^T O (k^3), the symmetric V f(w) V^T (k^3)
            # and O times it (2 k^3); the eigendecomposition is not counted
            branches = set()
            for O in (O_late, O_path):
                polar.polar_unitary(O, info=info)
                sweeps, ns = int(info[0]), int(info[4])
                branches.add(ns)
                print(f"  polar_unitary on the overlap of move {31 if O is O_late else 4}: "
                      + ("Newton-Schulz branch" if ns else f"Jacobi branch, {sweeps} sweeps"))
            check(branches == {0, 1}, "K6 timed on both branches")
            jac_ms = min(cuda_ms(lambda: polar.polar_unitary(O_path)) for _ in range(2))
            cols = D * D * CHI * CHI  # the free (e,r,j,i) / (m,j,v,i) axes of a layer
            cases = {  # name: (kernel, twin, library call or None, bytes, flops, peak)
                "layer_contract": (lambda: k1_layers(layer.layer_contract),
                                   lambda: k1_layers(layer.layer_contract_twin),
                                   lambda: torch.einsum("suler,svmfg,lmjuvi->jefirg", a, a,
                                                        q1.view(D, D, CHI, D, D, CHI)),
                                   nbytes(Wk, q1, Wbr, M2b), 2 * 2 * (2 * D * D) * D * D * cols,
                                   FP64_TC),
                "corner_apply": (lambda: corner.corner_apply(M2, P),
                                 lambda: corner.corner_apply_twin(M2, P),
                                 lambda: torch.matmul(M2, P),
                                 nbytes(M2, P, P), 2 * n * n * k, FP64_TC),
                "gram_ridge": (lambda: cholqr.gram_ridge(Pm, 1e-12),
                               lambda: cholqr.gram_ridge_twin(Pm, 1e-12), None,
                               nbytes(Pm, G), n * k * (k + 1), FP64_TC),  # symmetric
                "gram": (lambda: cholqr.gram(Pm, P), lambda: cholqr.gram_twin(Pm, P),
                         lambda: torch.matmul(Pm.mT, P), nbytes(Pm, P, G), 2 * n * k * k, FP64_TC),
                "trsm_right_lower_h": (lambda: cholqr.trsm_right_lower_h(L, Pm),
                                       lambda: cholqr.trsm_right_lower_h_twin(L, Pm),
                                       lambda: torch.linalg.solve_triangular(
                                           L.mT, Pm, upper=True, left=False),
                                       nbytes(L, Pm, Pm), n * k * k, FP64_TC),
                "trsm_right_lower": (lambda: cholqr.trsm_right_lower(L, Pm),
                                     lambda: cholqr.trsm_right_lower_twin(L, Pm),
                                     lambda: torch.linalg.solve_triangular(
                                         L, Pm, upper=False, left=False),
                                     nbytes(L, Pm, Pm), n * k * k, FP64_TC),
                "t_epilogue": (lambda: epilogue.t_epilogue(nT_raw),
                               lambda: epilogue.t_epilogue_twin(nT_raw), None,
                               nbytes(nT_raw, nT_raw), 4 * nT_raw.numel(), FP64_CC),
                "polar_unitary": (lambda: polar.polar_unitary(O_late),
                                  lambda: polar.polar_unitary_twin(O_late), None,
                                  nbytes(O_late, O_late), 4 * k ** 3, FP64_TC),
                "polar_vjp": (lambda: polar.polar_vjp(W, Wb),
                              lambda: polar.polar_vjp_twin(W, Wb), None,
                              nbytes(W, Wb, W), 4 * k ** 3, FP64_TC),
            }
            for name, case in cases.items():
                time_case(rec, name, *case)
            rec["polar_unitary"]["ms_jacobi_branch"] = jac_ms
            print(f"  polar_unitary, Jacobi branch (move 4's overlap): kernel {jac_ms:.3f} ms")
            del M2b, q, q1
    for name, shapes in gram_shapes.items():
        rec[name]["shapes"] = shapes
    return rec


def phase3(dev) -> dict:
    print(f"== phase 3: the slice, J1-J2 C4v D={D} chi={CHI} float64", flush=True)
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.kernels import launch_counts, reset_launch_counts
    from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
    from tpeps_torch.profiling import PhaseTimers, log_device_mem

    a = bench_state(D, dev)
    env0 = init_env(a, CHI, "CTMRG")
    model = J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=dev)
    timers = PhaseTimers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    env, n_iter, dist, _ = mf.run_ctmrg(a, env0, max_iter=MAX_ITER, conv_tol=CONV_TOL,
                                        n_power=N_POWER, timers=timers)
    torch.cuda.synchronize()
    t_ctm = time.perf_counter() - t0
    counts = launch_counts()
    peak_ctm = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    energy = float(model.energy_1x1_lowmem(a, env))
    obs, labels = model.eval_obs(a, env)
    torch.cuda.synchronize()
    t_obs = time.perf_counter() - t1
    ms_move = 1000.0 * timers.t["move"] / max(timers.n["move"], 1)
    print(f"  moves {n_iter}, final dist {dist:.3e}, {ms_move:.2f} ms/move (CUDA events), "
          f"CTMRG wall {t_ctm:.2f} s")
    print(f"  energy_1x1_lowmem {energy:.12f}; energy + eval_obs {1000 * t_obs:.1f} ms")
    print("  eval_obs " + ", ".join(f"{l}={v}" for l, v in zip(labels, obs)))
    print(f"  peak memory: CTMRG {peak_ctm / 2**30:.2f} GiB; "
          + log_device_mem("after energy").strip())
    print(f"  launches {counts}")
    check(math.isfinite(dist), f"final dist {dist:.3e} is finite")
    check(dist < CONV_TOL or n_iter == MAX_ITER, "converged or reached max_iter")
    check(math.isfinite(energy), "energy is finite")
    check(all(math.isfinite(abs(complex(v))) for v in obs), "observables are finite")
    for name in FORWARD:
        check(counts[name] > 0, f"{name} launched {counts[name]} times on the forward path")

    # the same path with the twins, 4 moves from the same start
    def four_moves():
        T_int = mf.to_int_layout(env0.T, D)
        C, P = env0.C, mf.cold_start_basis(CHI * D * D, CHI, a.dtype, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TWIN_MOVES):
            C, T_int, spec, P = mf.ctm_move_sl_factored(a, C, T_int, P, n_power=N_POWER)
        torch.cuda.synchronize()
        return spec, 1000.0 * (time.perf_counter() - t) / TWIN_MOVES

    spec_k, ms_k = four_moves()
    with twins_on_card():
        spec_t, ms_t = four_moves()
    e = float((spec_k - spec_t).abs().max())
    print(f"  {TWIN_MOVES} moves: kernels {ms_k:.2f} ms/move, twins {ms_t:.2f} ms/move")
    check(e <= TWIN_SPEC_TOL, f"spectrum after {TWIN_MOVES} moves, kernels vs twins: "
                              f"max abs diff {e:.2e} <= {TWIN_SPEC_TOL:.0e}")
    return counts


def phase4(dev) -> None:
    print(f"== phase 4: D={D_SMALL} chi={CHI_SMALL} on the card vs the CPU twins", flush=True)
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE

    a_cpu = bench_state(D_SMALL, "cpu")
    env_cpu = init_env(a_cpu, CHI_SMALL, "CTMRG")
    energies = {}
    for where in ("cpu", dev):
        a = a_cpu.to(where)
        env0 = type(env_cpu)(env_cpu.C.to(where), env_cpu.T.to(where))
        env, n, dist, _ = mf.run_ctmrg(a, env0, max_iter=200, conv_tol=1e-10)
        energies[str(where)] = float(
            J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=where).energy_1x1_lowmem(a, env))
        print(f"  {where}: {n} moves, dist {dist:.2e}, energy {energies[str(where)]:.14f}")
    e_cpu, e_dev = energies.values()
    check(abs(e_cpu - e_dev) <= E_SMALL_TOL,
          f"energy card vs CPU |dE| = {abs(e_cpu - e_dev):.2e} <= {E_SMALL_TOL:.0e}")


def train_cfg(D_, chi, where, out_prefix, epochs, **ctm):
    """The optimization's configuration: backtracking L-BFGS with the POWER
    line search, on ``where``."""
    from tpeps_torch.config import Config, CtmArgs, GlobalArgs, MainArgs, OptArgs

    return Config(
        main=MainArgs(bond_dim=D_, chi=chi, opt_max_iter=epochs, out_prefix=out_prefix),
        global_args=GlobalArgs(device=str(where)),
        ctm=CtmArgs(**ctm),
        opt=OptArgs(line_search="backtracking", line_search_svd_method="POWER"),
    )


def phase5(dev) -> dict:
    print(f"== phase 5: the training slice, {TRAIN_EPOCHS} L-BFGS epochs at D={D} chi={CHI} "
          "float64", flush=True)
    from tpeps_torch.examples.optim_common_c4v import optimize_c4v
    from tpeps_torch.kernels import launch_counts, reset_launch_counts
    from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE

    model = J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=dev)
    closure_losses = []  # every differentiated loss, in order

    def energy(a, env):
        e = model.energy_1x1_lowmem(a, env)
        if torch.is_grad_enabled() and a.requires_grad:
            closure_losses.append(float(e.detach()))
        return e

    stats = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg = train_cfg(D, CHI, dev, str(Path(tmp) / "d7"), TRAIN_EPOCHS,
                        projector_svd_method="POWER", n_power=N_POWER, grad_mode="implicit",
                        ctm_max_iter=TRAIN_MAX_ITER, ctm_conv_tol=CONV_TOL,
                        grad_adjoint_max_iter=TRAIN_ADJ_ITER)
        A0 = bench_state(D, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        e_fin, _, _, hist = optimize_c4v(cfg, model, energy, A0, grad_stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, (st, loss) in enumerate(zip(stats, closure_losses)):
        print(f"  gradient {i}: loss {loss:.12f}, forward {st['fwd_moves']} moves "
              f"(dist {st['fwd_dist']:.2e}, {st['t_fwd']:.2f} s), adjoint {st['adj_iters']} "
              f"iterations ({st['t_adj']:.2f} s), divergence guard fired: {st['adj_diverged']}")
    for ep, (loss, gn, tg, tl) in enumerate(zip(hist["loss"], hist["grad_norm"], hist["t_grad"],
                                                hist["t_ls"])):
        print(f"  epoch {ep}: loss {loss:.12f}, |grad| {gn:.6e}, gradient closures "
              f"{tg:.2f} s, line search {tl:.2f} s")
    t_fwd, t_adj = sum(st["t_fwd"] for st in stats), sum(st["t_adj"] for st in stats)
    t_rest = wall - sum(hist["t_grad"]) - sum(hist["t_ls"])
    print(f"  seconds: forward fixed point {t_fwd:.2f}, adjoint {t_adj:.2f}, line search "
          f"{sum(hist['t_ls']):.2f}, observables and the final state (SYMEIG) {t_rest:.2f}, "
          f"whole run {wall:.2f}; final energy {e_fin:.12f}")
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  launches {counts}")
    seq = closure_losses[:1] + hist["loss"]
    check(len(hist["loss"]) == TRAIN_EPOCHS, f"{TRAIN_EPOCHS} epochs ran")
    check(all(math.isfinite(x) for x in closure_losses + hist["loss"]), "losses are finite")
    check(all(math.isfinite(x) for x in hist["grad_norm"]), "gradients are finite")
    check(all(b <= a for a, b in zip(seq, seq[1:])),
          f"the loss did not rise: {' -> '.join(f'{x:.12f}' for x in seq)}")
    for name in TRAIN:
        check(counts[name] > 0, f"{name} launched {counts[name]} times on the training path")
    return counts


def phase6(dev) -> None:
    print(f"== phase 6: D={D_SMALL} chi={CHI_SMALL} training, card vs CPU twins", flush=True)
    from tpeps_torch.config import CtmArgs
    from tpeps_torch.ctm.c4v.ctmrg import converge_env, run_fixed_point
    from tpeps_torch.ctm.c4v.env import EnvC4v, init_env
    from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
    from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE
    from tpeps_torch.optim.driver import optimize_state

    # one initial environment for both sides, built on the CPU: the implicit
    # gradient depends on the signs of init_env's eigenvectors at ~1e-8
    # relative (a gauge the fixed point remembers), and the card's eigh may
    # pick other signs.  A fixed number of moves (conv_tol 0): both sides do
    # the same work.
    def env0_for(a, where):
        e = init_env(a.detach().cpu(), CHI_SMALL, "CTMRG")
        return EnvC4v(e.C.to(where), e.T.to(where))

    ctm = dict(ctm_max_iter=40, ctm_conv_tol=0.0, grad_mode="implicit",
               grad_adjoint_max_iter=200, grad_adjoint_tol=1e-10)
    for (seed, tol), method in itertools.product(GRAD_SMALL_TOL.items(), ("POWER", "SYMEIG")):
        res = []
        for where in ("cpu", dev):
            model = J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=where)
            A = bench_state(D_SMALL, where, seed=seed).requires_grad_()
            a = symmetrize_c4v(A, normalize=True)
            st = {}
            env = converge_env(a, env0_for(a, where), CtmArgs(projector_svd_method=method, **ctm),
                               stats=st)
            loss = model.energy_1x1_lowmem(a, env)
            (g,) = torch.autograd.grad(loss, A)
            res.append((float(loss.detach()), g.cpu()))
            print(f"  {method} RandomState({seed}) {where}: loss {res[-1][0]:.14f}, forward "
                  f"{st['fwd_moves']} moves (dist {st['fwd_dist']:.1e}), adjoint "
                  f"{st['adj_iters']} iterations")
        (l_c, g_c), (l_d, g_d) = res
        e = rel_err(g_d, g_c)
        check(e <= tol, f"{method} RandomState({seed}) implicit gradient card vs CPU: rel err "
                        f"{e:.2e} <= {tol:.0e} (|dloss| {abs(l_c - l_d):.1e})")
    losses = []
    for where in ("cpu", dev):
        model = J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=where)
        cfg = train_cfg(D_SMALL, CHI_SMALL, where, "", SMALL_EPOCHS,
                        projector_svd_method="POWER", **ctm)

        def loss_fn(p):
            a = symmetrize_c4v(p, normalize=True)
            return model.energy_1x1_lowmem(a, converge_env(a, env0_for(a, where), cfg.ctm))

        def loss_ls(p):
            a = symmetrize_c4v(p, normalize=True)
            env, *_ = run_fixed_point(a, env0_for(a, where), max_iter=cfg.ctm.ctm_max_iter,
                                      conv_tol=0.0, projector_method="POWER")
            return model.energy_1x1_lowmem(a, env)

        _, hist = optimize_state(bench_state(D_SMALL, where, seed=SMALL_SEED), loss_fn, cfg=cfg,
                                 loss_fn_linesearch=loss_ls)
        losses.append(hist["loss"])
        print(f"  {where}: losses " + ", ".join(f"{x:.14f}" for x in hist["loss"]))
    lc, ld = losses
    e = max((abs(x - y) for x, y in zip(lc, ld)), default=float("inf"))
    check(len(lc) == len(ld) == SMALL_EPOCHS and e <= LOSS_SMALL_TOL,
          f"{SMALL_EPOCHS} L-BFGS epochs card vs CPU: max |dloss| {e:.2e} <= {LOSS_SMALL_TOL:.0e}")


def rayleigh_ritz_H(a, C, T_int, n_moves: int):
    """The Rayleigh-Ritz matrix ``H = P^T M P`` (after the power steps) of move
    ``n_moves + 1`` of the D=7 path from the cold start: what ``eigh_small``
    sees there."""
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.linalg.power import cholesky_qr2

    P = mf.cold_start_basis(CHI * D * D, CHI, a.dtype, a.device)
    W = torch.eye(CHI, dtype=a.dtype, device=a.device)
    for _ in range(n_moves):
        C, T_int, _, P, W = mf.ctm_move_w(a, C, T_int, P, W, n_power=N_POWER)
    M2 = mf._c2x2_factored(a, C, T_int)
    P = cholesky_qr2(P @ W.mT)  # the move's start: the previous eigenbasis
    for _ in range(N_POWER):
        P = cholesky_qr2(M2 @ P)
    H = P.mT @ (M2 @ P)
    return (0.5 * (H + H.mT)).contiguous()


def eigh_errors(H, w, V, wt):
    """Eigenvalues against the twin's (relative), residual ``H V - V w``
    (relative to max |H|) and the orthogonality of ``V``."""
    e_w = float((torch.sort(w).values - wt).abs().max()) / float(wt.abs().max())
    e_r = float((H @ V - V * w).abs().max()) / float(H.abs().max())
    e_o = float((V.mT @ V - torch.eye(H.shape[0], dtype=H.dtype, device=H.device)).abs().max())
    return e_w, e_r, e_o


def oz_shape(A, B, s: int = 8) -> dict:
    """``ozaki_gemm`` of ``A @ B`` (split by the kernels): bit-identical to the
    twin, kernel and FP64 ``torch.matmul`` times (kernel, library, library,
    kernel), the int8 bound and the FP64 product's; returns the record."""
    from tpeps_torch.kernels import ozaki

    A, B = A.contiguous(), B.contiguous()
    (m, k), n = A.shape, B.shape[1]
    Ap, ea = ozaki.ozaki_split(A, s, 7, 1)
    Bp, eb = ozaki.ozaki_split(B, s, 7, 0)
    Y = ozaki.ozaki_gemm(Ap, ea, Bp, eb)
    check(torch.equal(Y, ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7)),
          f"ozaki_gemm {m} x {k} by {k} x {n}: bit-identical to the twin")
    kern, lib = (lambda: ozaki.ozaki_gemm(Ap, ea, Bp, eb)), (lambda: torch.matmul(A, B))
    ms, lib_ms = cuda_ms(kern), cuda_ms(lib)
    lib_ms, ms = min(lib_ms, cuda_ms(lib)), min(ms, cuda_ms(kern))
    bound_ms, bound_by = bound(nbytes(Ap, Bp, ea, eb, Y), s * (s + 1) // 2 * 2 * m * n * k, INT8_TC)
    fp64_ms, fp64_by = bound(nbytes(A, B, Y), 2 * m * n * k, FP64_TC)
    print(f"  ozaki_gemm {m} x {k} by {k} x {n}: kernel {ms:.3f} ms, FP64 torch.matmul "
          f"{lib_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; the FP64 product's "
          f"{fp64_ms:.4f} ms, {fp64_by})")
    return {"shape": [m, k, n], "kp": Ap.shape[2], "slices": s, "ms": ms, "fp64_matmul_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "fp64_bound_ms": fp64_ms}


def phase2_large_d(dev) -> dict:
    """The large-D slice's kernels against their twins at D=7, chi=147 f64."""
    print(f"== phase 2 (large-D slice): eigh_small, ozaki_split, ozaki_gemm, ctm_commit at "
          f"D={D}, chi={CHI}", flush=True)
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.kernels import ctm_loop, ozaki
    from tpeps_torch.kernels.eigh_small import eigh_small, eigh_small_twin

    rec = {}
    tol = TOL[torch.float64]
    a = bench_state(D, dev)
    env = init_env(a, CHI, "CTMRG")
    T_int = mf.to_int_layout(env.T, D)
    gen = torch.Generator(device=dev).manual_seed(2)
    info = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        # eigh_small on the Rayleigh-Ritz H of an early and a late move, at
        # subspace_eigh's width (chi + 8: H after one power step from a random
        # basis), on a dense 64 (the D=2 SYMEIG shape), on an H with exactly
        # degenerate pairs (as the C4v double layer gives) and on a dense
        # random H of the largest k, the hardest start: converged, eigenvalues,
        # residual and orthogonality <= 1e-12, two calls bit-identical
        from tpeps_torch.linalg.power import cholesky_qr2

        M2 = mf._c2x2_factored(a, env.C, T_int)
        Hs = {f"H of move {n + 1}": rayleigh_ritz_H(a, env.C, T_int, n) for n in (3, 30)}
        Pw = cholesky_qr2(M2 @ torch.randn(CHI * D * D, CHI + 8, generator=gen, device=dev,
                                           dtype=torch.float64))
        Hs[f"subspace_eigh's H, k={CHI + 8}"] = Pw.mT @ (M2 @ Pw)
        del Pw
        for kd in (64, EIGH_BIG):
            X = torch.randn(kd, kd, generator=gen, device=dev, dtype=torch.float64)
            Hs[f"dense k={kd}"] = X
        U = torch.linalg.qr(torch.randn(CHI, CHI, generator=gen, device=dev,
                                        dtype=torch.float64)).Q
        d = torch.randn(CHI // 2 + 1, generator=gen, device=dev, dtype=torch.float64)
        Hs[f"exact degenerate pairs, k={CHI}"] = (U * d.repeat_interleave(2)[:CHI]) @ U.mT
        cases = {}
        for label, H in Hs.items():
            H = (0.5 * (H + H.mT)).contiguous()
            Hs[label] = H
            w, V = eigh_small(H, info=info)
            sweeps, conv = info.tolist()[:2]
            w2, V2 = eigh_small(H)
            e_w, e_r, e_o = eigh_errors(H, w, V, eigh_small_twin(H)[0])
            cases[label] = {"k": H.shape[0], "sweeps": sweeps,
                            "ms": cuda_ms(lambda: eigh_small(H)),
                            "torch_eigh_ms": cuda_ms(lambda: torch.linalg.eigh(H))}
            check((conv == 1 or dev.type == "cpu") and max(e_w, e_r, e_o) <= tol
                  and torch.equal(w, w2) and torch.equal(V, V2),
                  f"eigh_small on {label}: {sweeps} sweeps, converged={bool(conv)}; eigenvalues "
                  f"rel err {e_w:.2e}, residual {e_r:.2e}, orthogonality {e_o:.2e} <= {tol:.0e}; "
                  f"two calls bit-identical; kernel {cases[label]['ms']:.3f} ms, "
                  f"torch.linalg.eigh {cases[label]['torch_eigh_ms']:.3f} ms")
        H = Hs["H of move 31"]
        k = CHI
        time_case(rec, "eigh_small", lambda: torch.sort(eigh_small(H)[0]).values,
                  lambda: eigh_small_twin(H)[0], lambda: torch.linalg.eigh(H),
                  nbytes(H, H) + 8 * k, 4 * k ** 3, FP64_TC)
        rec["eigh_small"]["cases"] = cases
        rec["eigh_small"][f"ms_dense_k{EIGH_BIG}"] = cases[f"dense k={EIGH_BIG}"]["ms"]
        del Hs, H, U

        # ozaki_split / ozaki_gemm on the presplit corner and a basis
        M2 = mf._c2x2_factored(a, env.C, T_int)
        P = torch.linalg.qr(torch.randn(CHI * D * D, CHI, generator=gen, device=dev,
                                        dtype=torch.float64)).Q.contiguous()
        n, k = P.shape
        s = 8
        split = {}
        for label, X, axis in (("M2", M2, 1), ("P", P, 0)):
            Xp, ex = ozaki.ozaki_split(X, s, 7, axis)
            Xpt, ext = ozaki.ozaki_split_twin(X, s, 7, axis)
            check(torch.equal(Xp, Xpt) and torch.equal(ex, ext),
                  f"ozaki_split {label} {tuple(X.shape)} axis={axis}: digit planes "
                  f"{tuple(Xp.shape)} and exponents bit-identical to the twin")
            split[label] = (Xp, ex)
        (Ap, ea), (Bp, eb) = split["M2"], split["P"]
        time_case(rec, "ozaki_split", lambda: ozaki.ozaki_split(M2, s, 7, 1),
                  lambda: ozaki.ozaki_split_twin(M2, s, 7, 1), None,
                  nbytes(M2) + s * Ap.shape[1] * Ap.shape[2] + 8 * n, 0, FP64_CC)
        print("  ozaki_split bound: read M2 once, write its 8 digit planes")
        Y = ozaki.ozaki_gemm(Ap, ea, Bp, eb)
        check(torch.equal(Y, ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7)),
              f"ozaki_gemm M2 P (s={s}): bit-identical to the twin; "
              f"{rel_err(Y, M2 @ P):.2e} vs the FP64 product")
        time_case(rec, "ozaki_gemm", lambda: ozaki.ozaki_gemm(Ap, ea, Bp, eb),
                  lambda: ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7), lambda: torch.matmul(M2, P),
                  nbytes(Ap, Bp, ea, eb, Y), s * (s + 1) // 2 * 2 * n * n * k, INT8_TC)
        del Ap, Y, split
        # every other product shape of the Ozaki move (slice_phys, as
        # run_ctmrg_mixed's float64 phase runs it) and the unsliced layers, real
        # operands of the D=7 path: bit-identical to the twin, timed against
        # FP64 torch.matmul, each with its bound
        rec["ozaki_gemm"]["shapes"] = {"M2 P": oz_shape(M2, P, s)}
        Tm = T_int.permute(0, 1, 3, 2).reshape(D * D * CHI, CHI)
        ct = env.C @ T_int.permute(3, 0, 1, 2).reshape(CHI, D * D * CHI)
        q1 = Tm @ ct
        A_k = a.permute(0, 3, 4, 1, 2).reshape(2 * D * D, D * D).contiguous()
        B_l = q1.view(D, D, CHI, D, D, CHI).permute(3, 0, 1, 2, 4, 5).reshape(D * D, -1)
        B_l = B_l.contiguous()
        A_s = a[0].permute(2, 3, 0, 1).reshape(D * D, D * D).contiguous()
        A_b = a.conj().permute(3, 4, 0, 1, 2).reshape(D * D, 2 * D * D).contiguous()
        split = {}
        for label, X, axis in (("ket A", A_k, 1), ("layer B", B_l, 0)):
            Xp, ex = ozaki.ozaki_split(X, s, 7, axis)
            Xpt, ext = ozaki.ozaki_split_twin(X, s, 7, axis)
            same = torch.equal(Xp, Xpt) and torch.equal(ex, ext)
            del Xp, ex, Xpt, ext
            check(same, f"ozaki_split layer {label} {tuple(X.shape)} axis={axis}: digit planes "
                        f"and exponents bit-identical to the twin")
        rec["ozaki_split"]["ms_layer_shape"] = cuda_ms(lambda: ozaki.ozaki_split(B_l, s, 7, 0))
        print(f"  ozaki_split of the layer's B {tuple(B_l.shape)}: "
              f"{rec['ozaki_split']['ms_layer_shape']:.3f} ms")
        shapes = rec["ozaki_gemm"]["shapes"]
        shapes["ct"] = oz_shape(env.C, T_int.permute(3, 0, 1, 2).reshape(CHI, -1), s)
        shapes["q1, z1"] = oz_shape(Tm, ct, s)
        del ct
        shapes["sliced layer"] = oz_shape(A_s, B_l, s)
        shapes["ket layer"] = oz_shape(A_k, B_l, s)
        B_b = (A_k @ B_l).contiguous()  # the ket layer's output, the bra layer's B
        del B_l
        shapes["bra layer"] = oz_shape(A_b, B_b, s)
        del B_b
        shapes["nT"] = oz_shape(P.mT, M2, s)
        # any other (s, w) takes the kernel's table-driven instance
        shapes["C T, s=6"] = oz_shape(env.C, T_int.permute(3, 0, 1, 2).reshape(CHI, -1), 6)
        del M2, q1, Tm

        # ctm_commit after one move, in both modes, against the twin
        C2, T2, spec2, P2, W2 = mf.ctm_move_w(a, env.C, T_int, P, n_power=N_POWER)
        for conv_on in ("spec", "env"):
            for max_iter, done in ((MAX_ITER, 0), (1, 0), (MAX_ITER, 1)):
                st_k = ctm_loop.loop_state(env.C, T_int, P, max_iter, CONV_TOL)
                st_t = ctm_loop.loop_state(env.C, T_int, P, max_iter, CONV_TOL)
                for st in (st_k, st_t):
                    st.spec.copy_(spec2.abs() * 0.5)  # a previous spectrum: a finite dist
                    st.ctl[1] = done
                ctm_loop.ctm_commit(st_k, C2, T2, P2, W2, spec2, conv_on=conv_on)
                ctm_loop.ctm_commit_twin(st_t, C2, T2, P2, W2, spec2, conv_on)
                same = all(torch.equal(x, y) for x, y in zip(st_k[:5], st_t[:5]))
                same &= torch.equal(st_k.ctl[:2], st_t.ctl[:2])
                e = 0.0 if torch.equal(st_k.dist, st_t.dist) else rel_err(st_k.dist, st_t.dist)
                committed = torch.equal(st_k.T, T2)
                check(same and e <= tol and committed != bool(done),
                      f"ctm_commit conv_on={conv_on} max_iter={max_iter} done={done}: state and "
                      f"(i, done) = {st_k.ctl[:2].tolist()} as the twin, dist {float(st_k.dist):.3e} "
                      f"(rel err {e:.1e}), committed={committed}")
        st_k = ctm_loop.loop_state(env.C, T_int, P, 10**9, -1.0)
        st_t = ctm_loop.loop_state(env.C, T_int, P, 10**9, -1.0)
        time_case(rec, "ctm_commit",
                  lambda: (ctm_loop.ctm_commit(st_k, C2, T2, P2, W2, spec2), st_k.T)[1],
                  lambda: (ctm_loop.ctm_commit_twin(st_t, C2, T2, P2, W2, spec2), st_t.T)[1],
                  None, 2 * nbytes(C2, T2, P2, W2, spec2), 0, FP64_CC)
    return rec


def ms_per_move(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1000.0 * (time.perf_counter() - t0) / max(out[1], 1)


def spectrum(C):
    return torch.linalg.eigvalsh(C.double()).abs().sort(descending=True).values


def graph_replay_ms(a, env0, n_chunks: int) -> float:
    """ms/move of a MoveGraph's replays alone (chunks of MOVES_PER_SYNC moves
    that all commit), after the run that captures it."""
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.move_graph import CHAIN_CONV_TOL, CHAIN_MAX_ITER, MoveGraph

    g = MoveGraph(a, CHI, n_moves=MOVES_PER_SYNC, n_power=N_POWER)
    start = (a, env0.C, mf.to_int_layout(env0.T, D),
             mf.cold_start_basis(CHI * D * D, CHI, a.dtype, a.device))
    g.load(*start, max_iter=CHAIN_MAX_ITER, conv_tol=CHAIN_CONV_TOL)
    g.run()  # the chunk eagerly, then the capture
    g.load(*start, max_iter=CHAIN_MAX_ITER, conv_tol=CHAIN_CONV_TOL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        g.run()
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0) / (n_chunks * MOVES_PER_SYNC)


def phase7(dev) -> tuple:
    print(f"== phase 7: the large-D slice, J1-J2 C4v D={D} chi={CHI}", flush=True)
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.ctm.c4v.move_graph import MoveGraph, run_fixed_point_factored
    from tpeps_torch.kernels import launch_counts, ozaki, reset_launch_counts
    from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE

    a = bench_state(D, dev)
    env0 = init_env(a, CHI, "CTMRG")
    model = J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=dev)
    kw = dict(max_iter=MAX_ITER, conv_tol=CONV_TOL, n_power=N_POWER)
    # (a) the on-card loop in graphs of 4 moves against one move per host read;
    # every call captures its own graph; the first call also meets the
    # one-time set-up, the second is timed
    run_fixed_point_factored(a, env0, moves_per_sync=MOVES_PER_SYNC, **kw)
    (env_g, n_g, d_g, _), ms_g = ms_per_move(
        lambda: run_fixed_point_factored(a, env0, moves_per_sync=MOVES_PER_SYNC, **kw))
    (env_e, n_e, d_e, _), ms_e = ms_per_move(lambda: mf.run_ctmrg(a, env0, **kw))
    ms_r = graph_replay_ms(a, env0, MAX_ITER // MOVES_PER_SYNC)
    e_spec = float((spectrum(env_g.C) - spectrum(env_e.C)).abs().max())
    e_C = float((env_g.C - env_e.C).abs().max())
    e_T = float((env_g.T - env_e.T).abs().max())
    print(f"  run_fixed_point_factored (graphs of {MOVES_PER_SYNC}): {n_g} moves, dist {d_g:.3e}, "
          f"{ms_g:.2f} ms/move (its capture included), {ms_r:.2f} ms/move in replays alone; "
          f"run_ctmrg (eager, one read per move): {n_e} moves, dist {d_e:.3e}, {ms_e:.2f} "
          f"ms/move; |dC| {e_C:.1e}, |dT| {e_T:.1e}")
    check(n_g == n_e and e_spec <= GRAPH_SPEC_TOL,
          f"graph vs eager: moves {n_g} == {n_e}, corner spectra max abs diff {e_spec:.2e} <= "
          f"{GRAPH_SPEC_TOL:.0e}")
    # (b) run_ctmrg with moves_per_sync (chained moves, one read per chunk)
    run_ctmrg_b = lambda: mf.run_ctmrg(a, env0, moves_per_sync=MOVES_PER_SYNC, **kw)
    run_ctmrg_b()
    (env_b, n_b, d_b, _), ms_b = ms_per_move(run_ctmrg_b)
    e_b = float((spectrum(env_b.C) - spectrum(env_e.C)).abs().max())
    print(f"  run_ctmrg(moves_per_sync={MOVES_PER_SYNC}): {n_b} moves, dist {d_b:.3e}, "
          f"{ms_b:.2f} ms/move (its capture included)")
    check(n_b == n_e and e_b <= GRAPH_SPEC_TOL,
          f"moves_per_sync={MOVES_PER_SYNC} vs 1: moves {n_b} == {n_e}, spectra max abs diff "
          f"{e_b:.2e} <= {GRAPH_SPEC_TOL:.0e}")
    del env_g, env_e, env_b
    # (c) one float64 Ozaki move against the FP64 move from the same start
    T_int = mf.to_int_layout(env0.T, D)
    P0 = mf.cold_start_basis(CHI * D * D, CHI, a.dtype, dev)
    moves = {}
    ozaki.SHAPE_LAUNCHES.clear()
    for impl in ("xla", "ozaki"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moves[impl] = mf.ctm_move_sl_factored(a, env0.C, T_int, P0, n_power=N_POWER,
                                              slice_phys=True, dot_impl=impl)
        torch.cuda.synchronize()
        print(f"  one move, slice_phys, dot_impl={impl}: {1000 * (time.perf_counter() - t0):.1f} ms "
              "(first call)")
    shape_launches = dict(ozaki.SHAPE_LAUNCHES)
    print(f"  ozaki_gemm launches of the Ozaki move by (s, m, kp, n): {shape_launches}")
    (Cx, Tx, sx, _), (Co, To, so, _) = moves["xla"], moves["ozaki"]
    e_s, e_C, e_T = (float((x - y).abs().max()) for x, y in ((sx, so), (Cx, Co), (Tx, To)))
    check(e_s <= OZ_MOVE_SPEC_TOL and max(e_C, e_T) <= OZ_MOVE_ENV_TOL,
          f"Ozaki move vs FP64 move: spec {e_s:.2e} <= {OZ_MOVE_SPEC_TOL:.0e}, C {e_C:.2e}, "
          f"T {e_T:.2e} <= {OZ_MOVE_ENV_TOL:.0e}")
    del moves, Cx, Tx, Co, To
    # (d) past the kernels' chi the graph is refused up front, naming them
    try:
        MoveGraph(a, EIGH_BIG + 1, n_moves=MOVES_PER_SYNC)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    check("eigh_small" in refused, f"MoveGraph at chi={EIGH_BIG + 1} refused: {refused!r}")
    # (e) the mixed driver with bench_case's arguments, against the float64
    # driver (dot_impl="xla") for as many moves from the same start
    stats = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    env, n, dist = mf.run_ctmrg_mixed(a, env0, max_iter=MAX_ITER, conv_tol=CONV_TOL,
                                      slice_phys=True, moves_per_sync=MOVES_PER_SYNC, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for st in stats:
        print(f"  {st['phase']}: {st['moves']} moves, dist {st['dist']:.3e}, "
              f"{1000 * st['seconds'] / max(st['moves'], 1):.2f} ms/move (host wall, capture "
              "included)")
    energy = float(model.energy_1x1_lowmem(a, env))
    print(f"  run_ctmrg_mixed: {n} moves in {wall:.2f} s, final dist {dist:.3e}, energy "
          f"{energy:.12f}, env dtype {env.C.dtype}, peak memory {peak / 2**30:.2f} GiB")
    print(f"  launches {counts}")
    check(env.C.dtype == torch.float64 and math.isfinite(dist) and math.isfinite(energy),
          "mixed driver: float64 environment, finite distance and energy")
    for name in LARGE_D:
        check(counts[name] > 0, f"{name} launched {counts[name]} times in the mixed driver")
    env_r, n_r, d_r, _ = mf.run_ctmrg(a, env0, max_iter=n, conv_tol=CONV_TOL, n_power=N_POWER,
                                      slice_phys=True)
    e_ref = float(model.energy_1x1_lowmem(a, env_r))
    dE = abs(energy - e_ref)
    d_spec = float((spectrum(env.C) - spectrum(env_r.C)).abs().max())
    check(dE <= MIXED_E_TOL and d_spec <= MIXED_SPEC_TOL,
          f"mixed driver vs float64 run_ctmrg ({n_r} moves, dist {d_r:.3e}, energy "
          f"{e_ref:.12f}): |dE| {dE:.2e} <= {MIXED_E_TOL:.0e}, corner spectra max abs diff "
          f"{d_spec:.2e} <= {MIXED_SPEC_TOL:.0e}")
    return counts, shape_launches


def ab_state(aux, dev, seed=0):
    """The abelian slice's site: a random U(1) C4v state (uniform per block
    from a seeded CPU generator, C4v-projected, normalized) on ``dev``."""
    from tpeps_torch.ipeps.ipeps_abelian import random_c4v_abelian
    from tpeps_torch.sym.tensor import leg

    st = random_c4v_abelian(torch.Generator().manual_seed(seed), "U1", leg(AB_PHYS), leg(aux), 1)
    return st.to(dev)


def record_dots(fn):
    """Run ``fn()`` and return its result with the (a, b, axes, out_like) of
    every tensordot it made."""
    from tpeps_torch.sym.tensor import AbelianTensor

    calls, orig = [], AbelianTensor.tensordot

    def rec(self, other, axes, out_like=None):
        calls.append((self, other, axes, out_like))
        return orig(self, other, axes, out_like)

    with mock.patch.object(AbelianTensor, "tensordot", rec):
        out = fn()
    return out, calls


def busy_share(fn, key_averages=False):
    """``(wall s, busy s)`` of ``fn()`` under torch.profiler: the union of the
    [start, end) intervals of the CUDA-device activities (kernels, copies,
    sets) in the raw trace, so that activities overlapping on different
    streams count once.  The raw trace, because a frozen move's cuSOLVER SVDs
    make over a hundred thousand events and building the profiler's per-event
    objects for them takes minutes.  With ``key_averages`` also ``(summed s,
    key_averages s)``: the plain sum of the same durations, and the sum of
    the self device times of ``prof.key_averages()`` (the earlier reading;
    small traces only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda)
    busy_ns, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    if not key_averages:
        return wall, busy_ns / 1e9
    summed_ns = sum(b - a for a, b in spans)
    ka_us = sum(getattr(e, "self_device_time_total", None) or
                getattr(e, "self_cuda_time_total", 0.0)
                for e in prof.key_averages() if e.device_type == cuda)
    return wall, busy_ns / 1e9, summed_ns / 1e9, ka_us / 1e6


def ab_energy(model, st, env):
    from tpeps_torch.ctm.c4v_abelian.env import as_generic

    bp, g = as_generic(st, env)
    return float(model.energy_per_site(bp, g))


def phase8(dev) -> tuple:
    print(f"== phase 8: the abelian slice, U(1) C4v J1-J2 D=8 chi={AB_CHI} float64", flush=True)
    from tpeps_torch.ctm.c4v_abelian import ctmrg as ab_ctmrg
    from tpeps_torch.ctm.c4v_abelian import frozen as ab_frozen
    from tpeps_torch.ctm.c4v_abelian.env import init_env as ab_init_env
    from tpeps_torch.examples.j1j2.abelian.ctmrg_j1j2_c4v_u1 import main as ab_main
    from tpeps_torch.kernels import blocksparse, launch_counts, reset_launch_counts
    from tpeps_torch.kernels import frozen as kfrozen
    from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
    from tpeps_torch.profiling import PhaseTimers
    from tpeps_torch.sym import tensor as ab_tensor
    from tpeps_torch.sym.io import write_ipeps_abelian

    rec = {}
    st = ab_state(AB_AUX, dev)
    model = J1J2_ABELIAN(j1=J1, j2=J2, device=dev)

    # (b) the entry point on the written state
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "u1_c4v_D8.json")
        write_ipeps_abelian(st, path)
        stats, plan_s = [], []
        move = ab_ctmrg.ctm_move_sl

        def timed_move(*args):  # host seconds spent building plans, per move
            b0 = ab_tensor.plan_cache_stats()["build_seconds"]
            out = move(*args)
            plan_s.append(ab_tensor.plan_cache_stats()["build_seconds"] - b0)
            return out

        plan0 = ab_tensor.plan_cache_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(ab_ctmrg, "ctm_move_sl", timed_move):
            e_entry, obs, labels = ab_main(
                ["--instate", path, "--chi", str(AB_CHI), "--j1", str(J1), "--j2", str(J2),
                 "--CTMARGS_ctm_max_iter", str(AB_ENTRY_MOVES), "--CTMARGS_ctm_conv_tol", "1e-8",
                 "--CTMARGS_projector_svd_reltol", "1e-12", "--CTMARGS_projector_eps_multiplet",
                 "1e-12", "--GLOBALARGS_device", str(dev)], stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_entry = launch_counts()
    plan1 = ab_tensor.plan_cache_stats()
    peak_entry = torch.cuda.max_memory_allocated()
    ctm_s = sum(x["seconds"] for x in stats)
    for i, (x, ps) in enumerate(zip(stats, plan_s)):
        print(f"  move {i + 1}: {1000 * x['seconds']:.1f} ms (host planning {1000 * ps:.1f}), "
              f"chi profile {x['profile']}")
    print(f"  entry point: {len(stats)} dynamic moves {1000 * ctm_s / len(stats):.1f} ms/move "
          f"(host wall, spectrum read included), host planning {1000 * sum(plan_s) / len(stats):.1f} "
          f"ms/move; plans built in "
          f"{plan1['build_seconds'] - plan0['build_seconds']:.2f} s of the run "
          f"({plan1['misses'] - plan0['misses']} built, {plan1['hits'] - plan0['hits']} reused); "
          f"whole run {wall:.2f} s, energy + observables {wall - ctm_s:.2f} s")
    print(f"  energy {e_entry:.12f}; " + ", ".join(f"{l}={v}" for l, v in zip(labels, obs)))
    print(f"  peak memory {peak_entry / 2**30:.2f} GiB; launches "
          + ", ".join(f"{k} {counts_entry[k]}" for k in ABELIAN))
    check(math.isfinite(e_entry) and all(math.isfinite(abs(complex(v))) for v in obs),
          "entry point: energy and observables finite")
    check(counts_entry["block_gemm"] > 0 and counts_entry["block_permute"] > 0,
          "the entry point launched block_gemm and block_permute")

    # (c) bench's case: dynamic warm-up, freeze, the frozen fixed point
    a = st.site((0, 0))
    env = ab_init_env(st, AB_CHI)
    for _ in range(AB_WARM_MOVES):
        env = ab_ctmrg.ctm_move_sl(a, env, AB_PK)
    keep = ab_frozen.freeze_from_env(env)
    C, T = ab_frozen.close_structure(a, env.C, env.T, dict(keep))
    print(f"  frozen profile {dict(keep)}; C {len(C.struct.keys)} blocks "
          f"({C.struct.numel} entries), T {len(T.struct.keys)} ({T.struct.numel}); "
          f"closed: C {'unchanged' if C.struct is env.C.struct else 'grown'}, "
          f"T {'unchanged' if T.struct is env.T.struct else 'grown'}")
    # (a) the move's kernels against their twins, at one dynamic move's shapes
    _, calls = record_dots(lambda: ab_ctmrg.ctm_move_sl(a, env, AB_PK))
    check(len(calls) == 10, f"one dynamic move made {len(calls)} tensordots (10)")
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0, bytes=0, pairs=0, groups=0)
    err_max = 0.0
    big_perm = None
    for i, (x, y, axes, out_like) in enumerate(calls):
        plan, abuf, bbuf = x.dot_operands(y, axes, out_like)
        g = plan.gemm
        kern = lambda: blocksparse.block_gemm(abuf, bbuf, torch.empty(plan.out.numel,
                                              dtype=abuf.dtype, device=dev), g)
        twin = lambda: blocksparse.block_gemm_twin(abuf, bbuf, torch.empty(
            plan.out.numel, dtype=abuf.dtype, device=dev), g)
        out_k, out_t = kern().clone(), twin()
        err = rel_err(out_k, out_t)
        err_max = max(err_max, float((out_k - out_t).abs().max()))
        ms_k, ms_t = min(cuda_ms(kern), cuda_ms(kern)), cuda_ms(twin, reps=2)
        ngroups = len(g.groups(dev)[3])
        flops, elems = g.work()
        b_ms, b_by = bound(8 * elems, flops, FP64_TC)
        for key, v in (("ms", ms_k), ("plain_ms", ms_t), ("bound_ms", b_ms), ("flops", flops),
                       ("bytes", 8 * elems), ("pairs", g.npairs), ("groups", ngroups)):
            totals[key] += v
        check(err <= TOL[torch.float64],
              f"block_gemm tensordot {i + 1}: {g.npairs} pairs in {ngroups} shape groups, "
              f"{g.nout} output blocks, {g.ntiles} tiles, {flops / 1e9:.3f} GFLOP, "
              f"{8 * elems / 1e6:.1f} MB; kernel {ms_k:.3f} ms, twin {ms_t:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); rel err {err:.1e} <= 1e-12")
        for src, perm in ((x, plan.perm_a), (y, plan.perm_b)):
            if perm is not None and (big_perm is None or perm.total > big_perm[1].total):
                big_perm = (src, perm)
        del abuf, bbuf, out_k, out_t
    bound_by = "bytes" if totals["bytes"] / HBM_BPS >= totals["flops"] / FP64_TC else "operations"
    rec["block_gemm"] = {"max_abs_err": err_max, "ms": totals["ms"],
                         "plain_ms": totals["plain_ms"], "bound_ms": totals["bound_ms"],
                         "bound_by": bound_by, "library_ms": None,
                         "gflop_per_move": totals["flops"] / 1e9,
                         "mb_per_move": totals["bytes"] / 1e6, "pairs_per_move": totals["pairs"],
                         "shape_groups_per_move": totals["groups"]}
    print(f"  block_gemm, the move's 10 tensordots: kernel {totals['ms']:.3f} ms, twin (the JAX "
          f"package's design: one bmm per shape group + index_add_) {totals['plain_ms']:.3f} ms, "
          f"bound {totals['bound_ms']:.4f} ms (sum of the calls'), {totals['pairs']} pairs in "
          f"{totals['groups']} groups, {totals['flops'] / 1e9:.2f} GFLOP, "
          f"{totals['bytes'] / 1e9:.2f} GB; library: none (no one torch call computes a "
          "charge-matched grouped contraction)")
    src, table = big_perm
    dst_k = torch.empty(table.total, dtype=src.data.dtype, device=dev)
    dst_t = torch.empty_like(dst_k)
    blocksparse.block_permute(src.data, dst_k, table)
    blocksparse.block_permute_twin(src.data, dst_t, table)
    check(torch.equal(dst_k, dst_t), f"block_permute of the largest operand ({table.nblk} blocks, "
                                     f"{table.total} entries, rank {table.rank}): bit-exact")
    time_case(rec, "block_permute", lambda: blocksparse.block_permute(src.data, dst_k, table),
              lambda: blocksparse.block_permute_twin(src.data, dst_t, table), None,
              2 * 8 * table.total, 0, FP64_CC)
    rec["block_permute"]["library_ms"] = None
    # the sector gather of the corner (K9's first step) on block_permute
    M = ab_ctmrg.c2x2_sl(a, env.C, env.T)
    splan = ab_tensor._sector_plan(M, (0, 1, 2), (3, 4, 5))
    gk = torch.zeros(splan.numel, dtype=M.data.dtype, device=dev)
    gt = torch.zeros_like(gk)
    blocksparse.block_permute(M.data, gk, splan.table)
    blocksparse.block_permute_twin(M.data, gt, splan.table)
    sizes = sorted(((q, v[7]) for q, v in splan.sectors.items()), key=lambda x: -x[1])
    check(torch.equal(gk, gt), f"block_permute sector gather of M ({len(M.struct.keys)} blocks "
                               f"into {len(sizes)} sector matrices, sides {[s for _, s in sizes]}): "
                               "bit-exact")
    # the sector decompositions: SVD drivers on the largest +-q sector, eigh on q=0
    qbig = next(q for q, _ in sizes if q != 0)
    base, R, Cc = splan.sectors[qbig][6:9]
    Mq = gk[base:base + R * Cc].view(R, Cc)
    base0, R0, C0 = splan.sectors[0][6:9]
    M0 = gk[base0:base0 + R0 * C0].view(R0, C0)
    drv = {d: cuda_ms(lambda d=d: torch.linalg.svd(Mq, full_matrices=False, driver=d), reps=2)
           for d in ("gesvd", "gesvdj", "gesvda")}
    ms_eigh = cuda_ms(lambda: torch.linalg.eigh(0.5 * (M0 + M0.mT)), reps=2)
    print(f"  sector SVD of q={qbig} ({R} x {Cc}): " + ", ".join(f"{d} {v:.2f} ms" for d, v in
                                                               drv.items())
          + f"; eigh of q=0 ({R0} x {C0}) {ms_eigh:.2f} ms")
    # each driver against gesvd on every +-q sector: all singular values
    # (relative to the largest) and the kept ones' gauge-fixed vectors
    from tpeps_torch.linalg.svd import fix_svd_signs
    for d in ("gesvdj", "gesvda"):
        e_s = e_k = e_u = 0.0
        for q, v in splan.sectors.items():
            k = dict(keep).get(q, 0)
            if q == 0 or k == 0:
                continue
            Mx = gk[v[6]:v[6] + v[7] * v[8]].view(v[7], v[8])
            U1, S1, V1 = torch.linalg.svd(Mx, full_matrices=False, driver="gesvd")
            U2, S2, V2 = torch.linalg.svd(Mx, full_matrices=False, driver=d)
            U1, V1 = fix_svd_signs(U1, V1)
            U2, V2 = fix_svd_signs(U2, V2)
            e_s = max(e_s, float((S1 - S2).abs().max() / S1[0]))
            e_k = max(e_k, float(((S1[:k] - S2[:k]).abs() / S1[:k]).max()))
            e_u = max(e_u, float((U1[:, :k].abs() - U2[:, :k].abs()).abs().max()),
                      float((V1[:k].abs() - V2[:k].abs()).abs().max()))
        print(f"  {d} against gesvd on the +-q sectors: singular values {e_s:.1e} (of the "
              f"largest), kept ones {e_k:.1e} relative, kept vectors' magnitudes {e_u:.1e}")
    del M, gk, gt, Mq, M0, calls
    # frozen_commit against its twin on one frozen move's raw outputs
    nC, nT = ab_frozen._move_raw(a, C, T, dict(keep))
    pC = ab_frozen.partner_index(C.struct, ab_frozen.C_PARTNER, dev)
    pT = ab_frozen.partner_index(T.struct, ab_frozen.T_PARTNER, dev)
    sk = kfrozen.frozen_state(C.data, T.data, AB_FROZEN_MOVES, 0.0)
    stw = kfrozen.frozen_state(C.data, T.data, AB_FROZEN_MOVES, 0.0)
    kfrozen.frozen_commit(sk, nC.data, nT.data, pC, pT)
    kfrozen.frozen_commit_twin(stw, nC.data, nT.data, pC, pT)
    e_d = rel_err(sk.dist2, stw.dist2)
    err_commit = max(float((x - y).abs().max())
                     for x, y in ((sk.C, stw.C), (sk.T, stw.T), (sk.dist2, stw.dist2)))
    check(torch.equal(sk.C, stw.C) and torch.equal(sk.T, stw.T) and e_d <= TOL[torch.float64]
          and torch.equal(sk.ctl[:2], stw.ctl[:2]),
          f"frozen_commit: C, T bit-exact, (i, done) {sk.ctl[:2].tolist()}, dist2 "
          f"{float(sk.dist2):.6e} rel err {e_d:.1e} <= 1e-12")
    nel = C.struct.numel + T.struct.numel
    sk2 = kfrozen.frozen_state(C.data, T.data, 10**9, -1.0)
    st2 = kfrozen.frozen_state(C.data, T.data, 10**9, -1.0)
    time_case(rec, "frozen_commit",
              lambda: (kfrozen.frozen_commit(sk2, nC.data, nT.data, pC, pT), sk2.T)[1],
              lambda: (kfrozen.frozen_commit_twin(st2, nC.data, nT.data, pC, pT), st2.T)[1],
              None, 8 * 5 * nel, 6 * nel, FP64_CC)
    rec["frozen_commit"]["max_abs_err"] = max(rec["frozen_commit"]["max_abs_err"], err_commit)
    del nC, nT

    # bench's case: 10 frozen moves (first call: host plans; second timed)
    ab_frozen.run_frozen(a, C, T, keep, max_iter=AB_FROZEN_MOVES, conv_tol=0.0)
    timers = PhaseTimers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Cf, Tf, nf, d2f = ab_frozen.run_frozen(a, C, T, keep, max_iter=AB_FROZEN_MOVES,
                                           conv_tol=0.0, timers=timers)
    torch.cuda.synchronize()
    ms_frozen = 1000 * (time.perf_counter() - t0) / nf
    split = {k: 1000 * v / nf for k, v in timers.t.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ab_frozen.run_frozen(a, C, T, keep, max_iter=AB_FROZEN_MOVES, conv_tol=0.0)
    torch.cuda.synchronize()
    ms_frozen_plain = 1000 * (time.perf_counter() - t0) / nf
    wall_b, dev_b = busy_share(lambda: ab_frozen.run_frozen(a, C, T, keep, max_iter=2,
                                                            conv_tol=0.0))
    print(f"  run_frozen(max_iter={AB_FROZEN_MOVES}, conv_tol=0): {nf} moves, dist2 {d2f:.3e}, "
          f"{ms_frozen_plain:.2f} ms per frozen move (host wall); with phase events "
          f"{ms_frozen:.2f}: " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f" ms; busy share over 2 moves {dev_b / wall_b:.3f} ({1000 * dev_b / 2:.2f} ms "
          "device per move)")
    rec["frozen_commit"]["ms_per_frozen_move"] = ms_frozen_plain
    rec["frozen_commit"]["frozen_move_split_ms"] = split
    # the same moves on the dynamic engine, from the same start
    env_d = ab_ctmrg.ENV_C4V_ABELIAN(AB_CHI, env.C, env.T)
    same_profile = True
    t0 = time.perf_counter()
    for _ in range(nf):
        env_d = ab_ctmrg.ctm_move_sl(a, env_d, AB_PK)
        same_profile &= tuple(sorted(env_d.C.legs[0].charges)) == tuple(keep)
    torch.cuda.synchronize()
    ms_dyn = 1000 * (time.perf_counter() - t0) / nf
    wall_d, dev_d = busy_share(lambda: ab_ctmrg.ctm_move_sl(a, env_d, AB_PK))
    e_fz = ab_energy(model, st, ab_ctmrg.ENV_C4V_ABELIAN(AB_CHI, Cf, Tf))
    e_dy = ab_energy(model, st, env_d)
    print(f"  {nf} dynamic moves from the same start: {ms_dyn:.2f} ms/move (plans cached), "
          f"profile stayed equal to keep: {same_profile}; one dynamic move busy share "
          f"{dev_d / wall_d:.3f} ({1000 * dev_d:.2f} ms device of {1000 * wall_d:.2f} ms)")
    check(abs(e_fz - e_dy) <= AB_E_FROZEN_TOL,
          f"energy after {nf} moves: frozen {e_fz:.12f}, dynamic {e_dy:.12f}, |dE| "
          f"{abs(e_fz - e_dy):.2e} <= {AB_E_FROZEN_TOL:.0e}")
    # converge_frozen (forward) to 1e-8 or AB_CONVERGE_ITER moves: the frozen engine's main path
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    env_c = ab_frozen.converge_frozen(a, env, keep, max_iter=AB_CONVERGE_ITER,
                                      conv_tol=AB_CONVERGE_TOL)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    counts_frozen = launch_counts()
    e_conv = ab_energy(model, st, env_c)
    print(f"  converge_frozen (max_iter {AB_CONVERGE_ITER}, conv_tol {AB_CONVERGE_TOL:.0e}): "
          f"{t_conv:.2f} s, energy {e_conv:.12f}; launches "
          + ", ".join(f"{k} {counts_frozen[k]}" for k in ABELIAN))
    check(math.isfinite(e_conv) and all(counts_frozen[k] > 0 for k in ABELIAN),
          "converge_frozen: energy finite, block_permute, block_gemm and frozen_commit launched")
    del Cf, Tf, env_c, env_d, C, T, env

    # (d) D=3 chi=18: card against the CPU twins
    res = []
    for where in ("cpu", dev):
        st_s = ab_state(AB_SMALL_AUX, where, seed=1)
        a_s = st_s.site((0, 0))
        env_s = ab_init_env(st_s, AB_SMALL_CHI)
        specs = []
        for _ in range(6):
            env_s = ab_ctmrg.ctm_move_sl(a_s, env_s, AB_PK)
            specs.append(env_s.get_spectrum())
        e_s = ab_energy(J1J2_ABELIAN(j1=J1, j2=J2, device=where), st_s, env_s)
        res.append((specs, e_s, env_s, a_s))
    (sp_c, e_c, env_c, a_c), (sp_d, e_d, env_d3, a_d3) = res
    d_spec = max(float(np.abs(x / x[0] - y / y[0]).max()) for x, y in zip(sp_c, sp_d))
    check(d_spec <= AB_SMALL_TOL and abs(e_c - e_d) <= AB_SMALL_TOL,
          f"D=3 chi={AB_SMALL_CHI} card vs CPU: 6 dynamic moves' spectra max diff {d_spec:.2e}, "
          f"energy |dE| {abs(e_c - e_d):.2e} <= {AB_SMALL_TOL:.0e}")
    # the busy share's readings on one such move: the union of the device
    # intervals (busy_share), their plain sum, and key_averages' self times
    ab_ctmrg.ctm_move_sl(a_d3, env_d3, AB_PK)
    wall3, union3, sum3, ka3 = busy_share(lambda: ab_ctmrg.ctm_move_sl(a_d3, env_d3, AB_PK),
                                          key_averages=True)
    print(f"  one D=3 chi={AB_SMALL_CHI} dynamic move on the card: {1000 * wall3:.3f} ms wall; "
          f"device busy {1000 * union3:.3f} ms (union of intervals, share "
          f"{union3 / wall3:.3f}), {1000 * sum3:.3f} ms (summed durations, "
          f"{sum3 / wall3:.3f}), {1000 * ka3:.3f} ms (key_averages self device time, "
          f"{ka3 / wall3:.3f})")
    del env_d3, a_d3
    keep_s = ab_frozen.freeze_from_env(env_c)
    out = []
    for where in ("cpu", dev):
        Cs, Ts = env_c.C.to(where), env_c.T.to(where)
        Cs, Ts = ab_frozen.close_structure(a_c.to(where), Cs, Ts, dict(keep_s))
        out.append(ab_frozen.run_frozen(a_c.to(where), Cs, Ts, keep_s,
                                        max_iter=AB_FROZEN_MOVES, conv_tol=0.0))
    (Cc, Tc, nc, dc), (Cd, Td, nd, dd) = out
    # T by magnitudes (as the CPU tests' abs_diff): the frozen sign fixing
    # may flip a column's sign where the ket/bra symmetry ties two entries
    check(Cc.struct.keys == Cd.struct.keys and Tc.struct.keys == Td.struct.keys,
          "D=3 frozen card vs CPU: the same block sets")
    e_C = float((Cc.data - Cd.data.cpu()).abs().max())
    e_T = float((Tc.data.abs() - Td.data.cpu().abs()).abs().max())
    e_T_signed = float((Tc.data - Td.data.cpu()).abs().max())
    check(nc == nd and e_C <= AB_SMALL_TOL and e_T <= AB_SMALL_TOL
          and abs(dc - dd) <= AB_SMALL_TOL * max(dc, 1e-300),
          f"D=3 frozen {nc} moves card vs CPU: C max diff {e_C:.2e}, |T| elementwise {e_T:.2e} "
          f"<= {AB_SMALL_TOL:.0e} (T signed {e_T_signed:.2e}), dist2 {dd:.6e} vs {dc:.6e}")
    return rec, counts_entry, counts_frozen


def ab_plan_seconds() -> float:
    from tpeps_torch.sym.tensor import plan_cache_stats

    return plan_cache_stats()["build_seconds"]


def ab_train_cfg(argv):
    """A config of the abelian training entry point's flags."""
    from tpeps_torch.config import configure
    from tpeps_torch.examples.j1j2.abelian.optim_j1j2_c4v_u1 import make_parser

    return configure(make_parser().parse_args(argv))


def adjoint_run(commit, lam_c, lam_t, ratio, max_iter, a, uC, uT):
    """The Neumann adjoint's loop with a linear stand-in move (u_C, u_T scale
    by lambda each iteration, abar_i = a (u_C[0] + u_T[0])) through
    ``commit``: the final state."""
    from tpeps_torch.kernels import frozen as kfrozen

    uT = ratio * uT
    st = kfrozen.adjoint_state(a, uC, uT, max_iter, 1e-8)
    while not bool(st.ctl[1]):
        da_i = a * (uC[0] + uT[0])
        uC, uT = lam_c * uC, lam_t * uT
        commit(st, da_i, uC, uT)
    return st


def adjoint_diagnosis(a, C0, T0, keep, cfg, dev) -> None:
    """Why the implicit adjoint diverges or converges at a closure's frozen
    fixed point (``run_frozen`` from the closed ``(C0, T0)`` as the loss
    runs it): per sector the kept count, the smallest relative gap among the
    kept values and the gap at the cut; how far one more move moves |C|, |T|
    and the kept projector; and the norm of one ``move_frozen`` VJP of a unit
    random cotangent at ``ad_decomp_reg`` 1e-12, 1e-8 and 1e-4."""
    from tpeps_torch.ctm.c4v_abelian import ctmrg as ab_ctmrg
    from tpeps_torch.ctm.c4v_abelian import frozen as ab_frozen
    from tpeps_torch.sym.frozen import eigh_blockwise_fixed
    from tpeps_torch.sym.tensor import AbelianTensor, _sector_matrices

    keep = dict(keep)
    C, T, n, _ = ab_frozen.run_frozen(a, C0, T0, keep, max_iter=cfg.ctm.ctm_max_iter,
                                      conv_tol=cfg.ctm.ctm_conv_tol)
    _, mats = _sector_matrices(ab_ctmrg.c2x2_sl(a, C, T), (0, 1, 2), (3, 4, 5))
    rows = []
    for q, k in sorted(keep.items()):
        Mq = mats[q][6]
        if q == 0:
            sv = torch.linalg.eigvalsh(0.5 * (Mq + Mq.mT)).abs().sort(descending=True).values
        else:
            sv = torch.linalg.svdvals(Mq)
        gaps = (sv[:k] - sv[1:k + 1]) / sv[0]
        inner = float(gaps[:k - 1].min()) if k > 1 else float("nan")
        rows.append(f"{q}: kept {k}, gap among kept {inner:.2e}, at the cut "
                    f"{float(gaps[k - 1]):.2e}")
    print(f"  after {n} frozen moves, the kept sector spectra (relative gaps): " + "; ".join(rows))

    def projector(Cx, Tx):
        P, _ = eigh_blockwise_fixed(ab_ctmrg.c2x2_sl(a, Cx, Tx), (0, 1, 2), (3, 4, 5), keep)
        return P.tensordot(P.conj(), ((3,), (3,)))

    C2, T2 = ab_frozen.move_frozen(a, C, T, keep)
    dQ = float((projector(C2, T2).data - projector(C, T).data).abs().max())
    print(f"  one more frozen move changes |C| by "
          f"{float((C2.data.abs() - C.data.abs()).abs().max()):.3e}, |T| by "
          f"{float((T2.data.abs() - T.data.abs()).abs().max()):.3e}, the kept projector by "
          f"{dQ:.3e}")
    gen = torch.Generator(device=dev).manual_seed(5)
    yC = torch.randn(C.data.numel(), generator=gen, device=dev, dtype=C.data.dtype)
    yT = torch.randn(T.data.numel(), generator=gen, device=dev, dtype=T.data.dtype)
    norm = (yC.square().sum() + yT.square().sum()).sqrt()
    out = []
    for reg in (1e-12, 1e-8, 1e-4):
        leaves = [x.data.detach().clone().requires_grad_() for x in (a, C, T)]
        with torch.enable_grad():
            oC, oT = ab_frozen.move_frozen(*(AbelianTensor._flat(x, x.struct, v)
                                             for x, v in zip((a, C, T), leaves)), keep, reg,
                                           sg_norm=False)
            g = torch.autograd.grad((oC.data, oT.data), leaves, (yC / norm, yT / norm))
        out.append(f"{reg:g}: " + " / ".join(f"{float(x.norm()):.3e}" for x in g))
    print("  one move's VJP of a unit cotangent, norms a / C / T at ad_decomp_reg "
          + "; ".join(out))


def phase9(dev) -> tuple:
    print(f"== phase 9: the abelian training slice, U(1) C4v J1-J2 D=8 chi={AB_CHI} float64",
          flush=True)
    from tpeps_torch.config import CtmArgs
    from tpeps_torch.ctm.c4v_abelian import ctmrg as ab_ctmrg
    from tpeps_torch.ctm.c4v_abelian import frozen as ab_frozen
    from tpeps_torch.ctm.c4v_abelian.env import ENV_C4V_ABELIAN, as_generic
    from tpeps_torch.ctm.c4v_abelian.env import init_env as ab_init_env
    from tpeps_torch.examples.j1j2.abelian.optim_j1j2_c4v_u1 import main as opt_main
    from tpeps_torch.ipeps.ipeps_abelian import IPEPS_ABELIAN, make_c4v_symm_A1_abelian
    from tpeps_torch.kernels import blocksparse, launch_counts, reset_launch_counts
    from tpeps_torch.kernels import frozen as kfrozen
    from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
    from tpeps_torch.optim.abelian import c4v_abelian_losses
    from tpeps_torch.sym.io import write_ipeps_abelian
    from tpeps_torch.sym.tensor import AbelianTensor

    rec = {}
    st = ab_state(AB_AUX, dev)
    a = st.site((0, 0))
    model = J1J2_ABELIAN(j1=J1, j2=J2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    rnd = lambda n: torch.rand(n, generator=gen, device=dev, dtype=torch.float64) - 0.5  # noqa

    # (a) the backward kernels against their twins at a frozen move's shapes
    env = ab_init_env(st, AB_CHI)
    for _ in range(AB_WARM_MOVES):
        env = ab_ctmrg.ctm_move_sl(a, env, AB_PK)
    keep = ab_frozen.freeze_from_env(env)
    C, T = ab_frozen.close_structure(a, env.C, env.T, dict(keep))
    (nC, nT), calls = record_dots(lambda: ab_frozen._move_raw(a, C, T, dict(keep)))
    check(len(calls) == 10, f"one frozen move made {len(calls)} tensordots (10)")
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0, bytes=0)
    err_max, big_perm = 0.0, None
    for i, (x, y, axes, out_like) in enumerate(calls):
        plan, abuf, bbuf = x.dot_operands(y, axes, out_like)
        G = rnd(plan.out.numel)
        tab_a, tab_b = plan.gemm.grad_tables()
        for side, tab, lhs, rhs, n_out in (("dA", tab_a, G, bbuf, abuf.numel()),
                                           ("dB", tab_b, abuf, G, bbuf.numel())):
            def kern(tab=tab, lhs=lhs, rhs=rhs, n_out=n_out):
                return blocksparse.block_gemm(lhs, rhs, torch.zeros(n_out, dtype=lhs.dtype,
                                                                    device=dev), tab)

            def twin(tab=tab, lhs=lhs, rhs=rhs, n_out=n_out):
                return blocksparse.block_gemm_twin(lhs, rhs, torch.zeros(
                    n_out, dtype=lhs.dtype, device=dev), tab)

            out_k, out_t = kern().clone(), twin()
            err = rel_err(out_k, out_t)
            err_max = max(err_max, float((out_k - out_t).abs().max()))
            ms_k, ms_t = min(cuda_ms(kern), cuda_ms(kern)), cuda_ms(twin, reps=2)
            flops, elems = tab.work()
            b_ms, b_by = bound(8 * elems, flops, FP64_TC)
            for key, v in (("ms", ms_k), ("plain_ms", ms_t), ("bound_ms", b_ms),
                           ("flops", flops), ("bytes", 8 * elems)):
                tot[key] += v
            check(err <= TOL[torch.float64],
                  f"block_gemm {side} table of tensordot {i + 1}: {tab.npairs} pairs, {tab.nout} "
                  f"blocks, {flops / 1e9:.3f} GFLOP, {8 * elems / 1e6:.1f} MB; kernel "
                  f"{ms_k:.3f} ms, twin {ms_t:.3f} ms, bound {b_ms:.4f} ms ({b_by}); rel err "
                  f"{err:.1e} <= 1e-12")
            del out_k, out_t
        for src, perm in ((x, plan.perm_a), (y, plan.perm_b)):
            if perm is not None and (big_perm is None or perm.total > big_perm[1].total):
                big_perm = (src, perm)
        del abuf, bbuf, G
    bound_by = "bytes" if tot["bytes"] / HBM_BPS >= tot["flops"] / FP64_TC else "operations"
    rec["block_gemm_grad"] = {"max_abs_err": err_max, "ms": tot["ms"],
                              "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                              "bound_by": bound_by, "library_ms": None,
                              "gflop_per_move_vjp": tot["flops"] / 1e9,
                              "mb_per_move_vjp": tot["bytes"] / 1e6}
    print(f"  block_gemm on the backward tables of a frozen move's 10 tensordots (20 launches): "
          f"kernel {tot['ms']:.3f} ms, twin {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.4f} ms, {tot['flops'] / 1e9:.2f} GFLOP, {tot['bytes'] / 1e9:.2f} GB")
    src, table = big_perm
    inv = table.inverse()
    g = rnd(table.total)
    dk, dt = torch.zeros_like(src.data), torch.zeros_like(src.data)
    blocksparse.block_permute(g, dk, inv)
    blocksparse.block_permute_twin(g, dt, inv)
    check(torch.equal(dk, dt), f"block_permute on the inverse table of the largest operand "
                               f"({inv.nblk} blocks, {inv.total} entries): bit-exact")
    time_case(rec, "block_permute_grad", lambda: blocksparse.block_permute(g, dk, inv),
              lambda: blocksparse.block_permute_twin(g, dt, inv), None, 2 * 8 * inv.total, 0,
              FP64_CC)
    del g, dk, dt, calls
    # the epilogue's backward on the raw C', T' of the same move
    pC = ab_frozen.partner_index(C.struct, ab_frozen.C_PARTNER, dev)
    pT = ab_frozen.partner_index(T.struct, ab_frozen.T_PARTNER, dev)
    gC, gT = rnd(nC.data.numel()), rnd(nT.data.numel())
    blk = (ab_frozen.block_index(C.struct, dev), ab_frozen.block_index(T.struct, dev),
           len(C.struct.keys), len(T.struct.keys))
    for sg in (False, True):
        xk = kfrozen.frozen_epilogue_vjp(nC.data, nT.data, pC, pT, gC, gT, *blk, sg)
        xt = kfrozen.frozen_epilogue_vjp_twin(nC.data, nT.data, pC, pT, gC, gT, *blk, sg)
        e = max(rel_err(u, v) for u, v in zip(xk, xt))
        check(e <= TOL[torch.float64], f"frozen_epilogue_vjp (sg_norm={sg}) on C' "
                                       f"{nC.data.numel()}, T' {nT.data.numel()} entries: rel "
                                       f"err {e:.1e} <= 1e-12")
    nel = nC.data.numel() + nT.data.numel()
    time_case(rec, "frozen_epilogue_vjp",
              lambda: kfrozen.frozen_epilogue_vjp(nC.data, nT.data, pC, pT, gC, gT, *blk),
              lambda: kfrozen.frozen_epilogue_vjp_twin(nC.data, nT.data, pC, pT, gC, gT, *blk),
              None, 8 * 4 * nel, 8 * nel, FP64_CC)
    # one adjoint step, then the crafted loops
    da_i, uC, uT = rnd(a.data.numel()), rnd(C.data.numel()), rnd(T.data.numel())
    sk = kfrozen.adjoint_state(a.data, gC, gT, 100, 1e-8)
    stw = kfrozen.adjoint_state(a.data, gC, gT, 100, 1e-8)
    kfrozen.adjoint_commit(sk, da_i, uC, uT)
    kfrozen.adjoint_commit_twin(stw, da_i, uC, uT)
    e_step = max(rel_err(sk.da, stw.da), rel_err(sk.scal, stw.scal))
    check(e_step <= TOL[torch.float64] and torch.equal(sk.ctl, stw.ctl),
          f"adjoint_commit one step: da, delta rel err {e_step:.1e} <= 1e-12, ctl "
          f"{sk.ctl.tolist()} bit-exact")
    for name, (lc, lt, ratio, mi) in AB_ADJ_CASES.items():
        u0C, u0T = rnd(C.data.numel()), rnd(T.data.numel())
        sk = adjoint_run(kfrozen.adjoint_commit, lc, lt, ratio, mi, a.data, u0C, u0T)
        stw = adjoint_run(kfrozen.adjoint_commit_twin, lc, lt, ratio, mi, a.data, u0C, u0T)
        check(torch.equal(sk.ctl, stw.ctl) and rel_err(sk.da, stw.da) <= TOL[torch.float64],
              f"adjoint_commit loop '{name}': (i, done, -, max_iter, grew, diverged) "
              f"{sk.ctl.tolist()} bit-exact, da rel err {rel_err(sk.da, stw.da):.1e}")
    sk2 = kfrozen.adjoint_state(a.data, gC, gT, 10**9, 0.0)
    st2 = kfrozen.adjoint_state(a.data, gC, gT, 10**9, 0.0)
    na, nct = a.data.numel(), C.data.numel() + T.data.numel()
    time_case(rec, "adjoint_commit", lambda: (kfrozen.adjoint_commit(sk2, da_i, uC, uT), sk2.da)[1],
              lambda: (kfrozen.adjoint_commit_twin(st2, da_i, uC, uT), st2.da)[1], None,
              8 * (3 * na + nct), na + 2 * nct, FP64_CC)
    check(torch.equal(sk2.ctl, st2.ctl), f"adjoint_commit after the timing calls: ctl "
                                         f"{sk2.ctl.tolist()} bit-exact")
    del nC, nT, gC, gT, C, T, env

    # (b) one closure of optimize_c4v_abelian: context, gradient, energy
    cfg = ab_train_cfg(["--chi", str(AB_CHI), "--j1", str(J1), "--j2", str(J2),
                        "--CTMARGS_ctm_max_iter", str(AB_CLOSURE_MOVES),
                        "--GLOBALARGS_device", str(dev)])
    grad_stats = []
    p0, ctx_fn, loss_fn, sym_site = c4v_abelian_losses(st, model.energy_per_site, cfg,
                                                      grad_stats=grad_stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plan0 = ab_plan_seconds()
    t0 = time.perf_counter()
    with torch.no_grad():
        ctx = ctx_fn(p0)
    torch.cuda.synchronize()
    t_ctx = time.perf_counter() - t0
    plan_ctx = ab_plan_seconds() - plan0
    keep_b, C0, T0 = ctx
    p = p0.clone().requires_grad_()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss = loss_fn(p, ctx)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(loss, p)
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    counts_grad = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gs = grad_stats[-1]
    e0, gnorm = float(loss.detach()), float(g.norm())
    check(math.isfinite(e0) and bool(torch.isfinite(g).all()), "one closure: loss and gradient "
                                                               "finite")
    n_adj = gs["adjoint_iters"]
    print(f"  context: {AB_CLOSURE_MOVES} dynamic moves + freeze + close_structure {t_ctx:.2f} s "
          f"(host planning {plan_ctx:.2f} s), profile {dict(keep_b)}; frozen forward "
          f"{gs['forward_seconds']:.2f} s "
          f"({gs['forward_moves']} moves + 1 alignment move, dist2 {gs['forward_dist2']:.3e}, "
          f"R != 1 for (C, T): {gs['sign_aligned']}); energy forward "
          f"{t_fwd - gs['forward_seconds']:.2f} s; adjoint {gs['adjoint_seconds']:.2f} s: "
          f"{n_adj} iterations, {1000 * gs['adjoint_seconds'] / max(n_adj, 1):.1f} ms each, "
          f"{'diverged' if gs['adjoint_diverged'] else 'converged'} (|u|^2 "
          f"{gs['adjoint_delta']:.3e}); energy backward {t_bwd - gs['adjoint_seconds']:.2f} s; "
          f"peak memory {peak / 2**30:.2f} GiB")
    print("  launches per gradient: " + ", ".join(f"{k} {counts_grad[k]}" for k in AB_TRAIN))
    check(all(counts_grad[k] > 0 for k in AB_TRAIN), "one gradient launched every kernel of "
                                                     "the abelian training path")
    h = 1e-5
    d = g / g.norm()
    with torch.no_grad():
        fd = (float(loss_fn(p0 + h * d, ctx)) - float(loss_fn(p0 - h * d, ctx))) / (2 * h)
    check(math.isfinite(fd) and fd > 0,
          f"a step along -g descends in the closure's context: the central difference along "
          f"g/|g| (h={h:g}) {fd:.9e} is finite and > 0 (loss {e0:.12f}; |g| {gnorm:.9e}, "
          f"relative difference {abs(fd - gnorm) / gnorm:.2e})")
    with torch.no_grad():
        A = sym_site(p0)
        adjoint_diagnosis(A * (1.0 / A.norm()), C0, T0, keep_b, cfg, dev)
    # the backward's device busy share, on a second closure (the frozen
    # forward's is phase 8's per-move figure)
    loss = loss_fn(p, ctx)
    torch.cuda.synchronize()
    wall_bw, dev_bw = busy_share(lambda: torch.autograd.grad(loss, p))
    print(f"  backward (the graph of one move, the adjoint, the energy's backward) under the "
          f"profiler: {wall_bw:.2f} s, busy share {dev_bw / wall_bw:.3f} ({dev_bw:.2f} s device)")
    del ctx, C0, T0, p, g, loss

    # (c) two L-BFGS epochs of the entry point on the written state
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "u1_c4v_D8.json")
        write_ipeps_abelian(st, path)
        stats_c = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        e_fin, hist = opt_main(["--instate", path, "--chi", str(AB_CHI), "--j1", str(J1), "--j2",
                                str(J2), "--opt_max_iter", "2", "--OPTARGS_line_search",
                                "backtracking", "--CTMARGS_ctm_max_iter", str(AB_GRAD_MOVES),
                                "--out_prefix", str(Path(tmp) / "opt"), "--GLOBALARGS_device",
                                str(dev)], grad_stats=stats_c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_train = launch_counts()
    peak_c = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    print(f"  entry point, 2 epochs: {wall:.2f} s (gradient closures "
          + ", ".join(f"{x:.2f}" for x in hist["t_grad"]) + " s, line searches "
          + ", ".join(f"{x:.2f}" for x in hist["t_ls"]) + f" s), {len(stats_c)} gradients ("
          + "; ".join(f"{s['forward_moves']} + 1 forward moves in {s['forward_seconds']:.2f} "
                      f"s, {s['adjoint_iters']} adjoint iterations in "
                      f"{s['adjoint_seconds']:.2f} s{' DIVERGED' if s['adjoint_diverged'] else ''}"
                      for s in stats_c)
          + f"), losses {losses}, FINAL {e_fin:.12f}, peak {peak_c / 2**30:.2f} GiB")
    print("  launches in the two epochs: " + ", ".join(f"{k} {counts_train[k]}" for k in AB_TRAIN))
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses) and losses[1] <= losses[0]
          and math.isfinite(e_fin), "two epochs: losses finite, the second not above the first")
    check(all(counts_train[k] > 0 for k in AB_TRAIN), "the two epochs launched every kernel of "
                                                      "the abelian training path")

    # (d) D=3 chi=9: the gradient on the card against the CPU twins'
    st_s = ab_state(AB_SMALL_AUX, "cpu", seed=1)
    env_s, _ = ab_ctmrg.run(st_s, ab_init_env(st_s, AB_GRAD_SMALL_CHI),
                            CtmArgs(ctm_max_iter=60, ctm_conv_tol=1e-9))
    keep_s = ab_frozen.freeze_from_env(env_s)
    Cs, Ts = ab_frozen.close_structure(st_s.site((0, 0)), env_s.C, env_s.T, dict(keep_s))
    out = []
    for where in ("cpu", dev):
        a_s = st_s.site((0, 0)).to(where)
        x = a_s.data.clone().requires_grad_()
        A = make_c4v_symm_A1_abelian(AbelianTensor._flat(a_s, a_s.struct, x))
        A = A * (1.0 / A.norm())
        stats_s = {}
        Cf, Tf = ab_frozen.converge_closed(A, Cs.to(where), Ts.to(where), keep_s,
                                           max_iter=AB_GRAD_SMALL_ITER, conv_tol=1e-10,
                                           stats=stats_s)
        bp, gg = as_generic(IPEPS_ABELIAN("U1", {(0, 0): A}),
                            ENV_C4V_ABELIAN(AB_GRAD_SMALL_CHI, Cf, Tf))
        e_s = J1J2_ABELIAN(j1=J1, j2=J2, device=where).energy_per_site(bp, gg)
        (g_s,) = torch.autograd.grad(e_s, x)
        out.append((float(e_s.detach()), g_s.cpu(), stats_s))
    (e_c, g_c, s_c), (e_d, g_d, s_d) = out
    e_g = rel_err(g_d, g_c)
    check(e_g <= AB_GRAD_SMALL_TOL and abs(e_c - e_d) <= AB_SMALL_TOL,
          f"D=3 chi={AB_GRAD_SMALL_CHI} gradient card vs CPU: rel err {e_g:.2e} <= "
          f"{AB_GRAD_SMALL_TOL:.0e}, loss |dE| {abs(e_c - e_d):.2e}; adjoint iterations "
          f"{s_d['adjoint_iters']} (CPU {s_c['adjoint_iters']}), R != 1 {s_d['sign_aligned']} "
          f"(CPU {s_c['sign_aligned']})")
    return rec, counts_grad, counts_train


def gen_state(aux, dev, seed=0, neel=False):
    """The generic slice's state: two random U(1) sites from one seeded CPU
    generator, each C4v-projected in the uniform signature and flipped to the
    canonical one (``neel``: site (1, 0) the Neel partner of site (0, 0)), on
    the bipartite 2-site cell."""
    from tpeps_torch.ipeps.ipeps_abelian import random_bipartite_abelian
    from tpeps_torch.sym.tensor import leg

    return random_bipartite_abelian(torch.Generator().manual_seed(seed), "U1", leg(AB_PHYS),
                                    leg(aux), 1, neel=neel, device=dev)


def neel_state_np(aux, seed=0):
    """The Neel 2-site state of the CPU tests (tests/test_torch_abelian_generic.py)
    on the CPU: site (0, 0) uniform [0, 1) - 0.5 per allowed block from
    ``np.random.RandomState(seed)`` in sorted key order, C4v-projected,
    (d, r) flipped, normalized; site (1, 0) its Neel partner."""
    from tpeps_torch.ipeps.ipeps_abelian import (IPEPS_ABELIAN, bipartite,
                                                 make_c4v_symm_A1_abelian)
    from tpeps_torch.sym.tensor import AbelianTensor, leg

    rng = np.random.RandomState(seed)
    a = AbelianTensor("U1", (1,) * 5, (leg(AB_PHYS),) + (leg(aux),) * 4, 1)
    a = a.copy_with({q: torch.as_tensor(rng.rand(*a.block_shape(q)) - 0.5)
                     for q in sorted(a.all_allowed_blocks())})
    A = make_c4v_symm_A1_abelian(a).flip_charges((3, 4))
    A = A * (1.0 / float(A.norm()))
    B = A.charge_conjugate()
    B = B.copy_with({qs: (-b if qs[0] == 1 else b) for qs, b in B.blocks.items()})
    return IPEPS_ABELIAN("U1", {(0, 0): A, (1, 0): B}, vertexToSite=bipartite, lX=2, lY=1)


def gen_cfg(argv):
    """A config of the generic training entry point's flags."""
    from tpeps_torch.config import configure
    from tpeps_torch.examples.j1j2.abelian.optim_j1j2_u1 import make_parser

    return configure(make_parser().parse_args(argv))


def flat_like(like, data):
    from tpeps_torch.sym.tensor import AbelianTensor

    return AbelianTensor._flat(like, like.struct, data)


def gen_frozen(st, env, chi):
    """Frozen profiles and the closed warm start of ``env``."""
    from tpeps_torch.ctm.generic_abelian import frozen as gfz

    profiles = gfz.freeze_profiles(st, env, chi, svd_reltol=1e-12, eps_multiplet=1e-12)
    keeps = gfz._prof_dict(profiles)
    return profiles, keeps, gfz.close_structure_generic(st, env, keeps)


def phase10(dev) -> tuple:
    print(f"== phase 10: the generic abelian slice, U(1) 2-site bipartite J1-J2 D=8 "
          f"chi={AB_CHI} float64", flush=True)
    from tpeps_torch.ctm.generic_abelian import ctmrg as gct
    from tpeps_torch.ctm.generic_abelian import env as genv
    from tpeps_torch.ctm.generic_abelian import frozen as gfz
    from tpeps_torch.examples.j1j2.abelian import ctmrg_j1j2_u1
    from tpeps_torch.examples.j1j2.abelian.optim_j1j2_u1 import main as gen_opt_main
    from tpeps_torch.kernels import frozen_generic as kgen
    from tpeps_torch.kernels import launch_counts, reset_launch_counts
    from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
    from tpeps_torch.optim import abelian as gen_optim
    from tpeps_torch.optim.abelian import generic_abelian_losses
    from tpeps_torch.profiling import PhaseTimers
    from tpeps_torch.sym import tensor as ab_tensor
    from tpeps_torch.sym.io import write_ipeps_abelian

    # the plans of phases 8-9 hold the twins' element indices on the card
    # (GBs at D=8): drop them, so that the peaks below are this phase's
    ab_tensor.PLANS.clear()
    torch.cuda.empty_cache()
    rec = {}
    st = gen_state(AB_AUX, dev)
    model = J1J2_ABELIAN(j1=J1, j2=J2, device=dev)
    pk = ["--CTMARGS_projector_svd_reltol", "1e-12", "--CTMARGS_projector_eps_multiplet", "1e-12"]
    dirs = gct.sweep_directions(st, gfz.MOVE_SEQ)

    # (b) the entry point on the written state, then one more sweep profiled
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "u1_bipartite_D8.json")
        write_ipeps_abelian(st, path)
        stats, envs, plan0 = [], [], ab_tensor.plan_cache_stats()
        run = ctmrg_j1j2_u1.run

        def kept_run(*args, **kw):  # the entry point's environment, for the profiled sweep
            out = run(*args, **kw)
            envs.append(out[0])
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(ctmrg_j1j2_u1, "run", kept_run):
            e_entry, obs, labels = ctmrg_j1j2_u1.main(
                ["--instate", path, "--tiling", "BIPARTITE", "--chi", str(AB_CHI), "--j1",
                 str(J1), "--j2", str(J2), "--CTMARGS_ctm_max_iter", str(GEN_ENTRY_SWEEPS),
                 "--CTMARGS_ctm_conv_tol", "0", *pk, "--GLOBALARGS_device", str(dev)],
                stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_entry = launch_counts()
        plan1 = ab_tensor.plan_cache_stats()
        peak_entry = torch.cuda.max_memory_allocated()
        sweep_s = [x["seconds"] for x in stats]
        print(f"  entry point: {len(stats)} dynamic sweep(s) (6 directional moves over 2 sites "
              "each): " + ", ".join(f"{1000 * x:.1f}" for x in sweep_s) + " ms; plans built "
              f"{plan1['misses'] - plan0['misses']} in "
              f"{plan1['build_seconds'] - plan0['build_seconds']:.2f} s of host time, "
              f"{plan1['hits'] - plan0['hits']} reused; whole run {wall:.2f} s, energy + "
              f"observables {wall - sum(sweep_s):.2f} s")
        for k, v in sorted(stats[-1]["profiles"].items()):
            print(f"  chi profile of C{k}: {v}")
        print(f"  energy {e_entry:.12f}; " + ", ".join(f"{l}={v}" for l, v in zip(labels, obs)))
        print(f"  peak memory {peak_entry / 2**30:.2f} GiB; launches "
              + ", ".join(f"{k} {counts_entry[k]}" for k in GENERIC))
        check(math.isfinite(e_entry) and all(math.isfinite(abs(complex(v))) for v in obs),
              "generic entry point: energy and observables finite")
        check(counts_entry["block_gemm"] > 0 and counts_entry["block_permute"] > 0,
              "the generic entry point launched block_gemm and block_permute")
        wall_b, dev_b = busy_share(lambda: gct.ctm_move(dirs[0], st, envs[-1], AB_CHI, AB_PK))
        print(f"  one more dynamic directional move (a sixth of a sweep) under the profiler "
              f"(plans cached): {1000 * wall_b:.1f} ms, busy share {dev_b / wall_b:.3f} "
              f"({1000 * dev_b:.1f} ms device)")
        del envs

        # (e) the generic training entry point on the D=8 state, whose first
        # gradient closure is (d); the closed context of its epoch is kept
        # for (a) and (c)
        stats_e, closed = [], []

        def kept_close(*args, **kw):
            out = gfz.close_structure_generic(*args, **kw)
            closed.append((args[0], args[2], out))
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught, \
                mock.patch.object(gen_optim, "close_structure_generic", kept_close):
            warnings.simplefilter("always")
            e_fin, hist = gen_opt_main(["--instate", path, "--chi", str(AB_CHI), "--j1", str(J1),
                                        "--j2", str(J2), "--opt_max_iter", str(GEN_TRAIN_EPOCHS),
                                        "--OPTARGS_line_search", "backtracking",
                                        "--CTMARGS_ctm_max_iter", str(GEN_TRAIN_SWEEPS),
                                        "--CTMARGS_grad_adjoint_max_iter", str(GEN_ADJ_MAX_ITER),
                                        *pk, "--out_prefix", str(Path(tmp) / "gen_opt"),
                                        "--GLOBALARGS_device", str(dev)], grad_stats=stats_e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_train = launch_counts()
        peak = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    g0 = stats_e[0]
    print(f"  (d) the first gradient closure: frozen forward {g0['forward_seconds']:.2f} s "
          f"({g0['forward_sweeps']} sweep(s) + the sweep that stores the backward's envs, "
          f"dist2 {g0['forward_dist2']:.3e}, R != 1: {g0['sign_aligned']}); adjoint "
          f"{g0['adjoint_seconds']:.2f} s, {g0['adjoint_iters']} iteration(s) of at most "
          f"{GEN_ADJ_MAX_ITER} (each: the six moves' graphs rebuilt one at a time and their "
          f"VJPs), {'diverged' if g0['adjoint_diverged'] else 'not diverged'} (|u|^2 "
          f"{g0['adjoint_delta']:.3e}); the epoch's two closures {hist['t_grad'][0]:.2f} s, so "
          f"the energy forward and backward ~"
          f"{(hist['t_grad'][0] - sum(x['forward_seconds'] + x['adjoint_seconds'] for x in stats_e[:2])) / 2:.2f}"
          f" s per closure; peak memory {peak / 2**30:.2f} GiB; its central difference along "
          f"g/|g| is held at D=3 in (f): at {GEN_TRAIN_SWEEPS} sweep(s) per context the D=8 "
          f"loss is far from its fixed point (ROADMAP Queue 3)")
    print(f"  (e) the generic training entry point, {GEN_TRAIN_EPOCHS} epoch(s) at D=8 "
          f"chi={AB_CHI}, {GEN_TRAIN_SWEEPS} sweep(s) per context and frozen fixed point, at "
          f"most {GEN_ADJ_MAX_ITER} adjoint iteration(s): {wall:.2f} s (gradient closures "
          + ", ".join(f"{x:.2f}" for x in hist["t_grad"]) + " s, line searches "
          + ", ".join(f"{x:.2f}" for x in hist["t_ls"]) + f" s, the rest contexts and the "
          f"FINAL measurement), {len(stats_e)} gradients (" + "; ".join(
              f"{s_['forward_sweeps']} + 1 frozen sweeps in {s_['forward_seconds']:.2f} s, "
              f"{s_['adjoint_iters']} adjoint iteration(s) in {s_['adjoint_seconds']:.2f} s"
              f"{' DIVERGED' if s_['adjoint_diverged'] else ''}" for s_ in stats_e)
          + f"), losses {losses}, FINAL {e_fin:.12f}; "
          + ("; ".join(sorted({str(w.message) for w in caught})) or "no warning"))
    print("  launches in the training run: " + ", ".join(f"{k} {counts_train[k]}"
                                                         for k in GEN_TRAIN))
    check(len(losses) == GEN_TRAIN_EPOCHS and all(math.isfinite(x) for x in losses)
          and all(math.isfinite(x) for x in hist["grad_norm"])
          and all(b <= a for a, b in zip(losses, losses[1:])) and math.isfinite(e_fin),
          f"{GEN_TRAIN_EPOCHS} generic epoch(s) at D=8: losses and gradients finite"
          + (", no loss above the one before" if GEN_TRAIN_EPOCHS > 1 else ""))
    check(all(counts_train[k] > 0 for k in GEN_TRAIN),
          "the generic training run launched every kernel of the generic training path")
    rec_t = {"seconds_per_gradient": sum(hist["t_grad"]) / len(stats_e),
             "seconds_training_run": wall, "peak_gib_training": peak / 2**30}

    # (a) and (c) on the closed context of (e)'s epoch (freeze_profiles and
    # close_structure_generic on one dynamic sweep's environment)
    st_c, keeps, env_c = closed[0]
    del closed
    lay = gfz.FrozenLayout(st_c, env_c)
    print(f"  the epoch's closed context: env {lay.numel} entries in {len(lay.keys)} tensors; "
          "profiles " + "; ".join(f"{d}{c}: {sum(kp.values())}" for (d, c), kp in keeps.items()))

    # (a) K10 against its twins at one frozen move's shapes
    d0 = dirs[0]
    raws = gfz._move_raw(d0, st_c, env_c, keeps)
    raw = torch.cat([r.data for r in raws])
    seg = lay.segments(d0, dev)
    X = lay.flat(env_c)
    Wk, Wt = X.clone(), X.clone()
    kgen.generic_epilogue(raw, seg, Wk)
    kgen.generic_epilogue_twin(raw, seg, Wt)
    check(torch.equal(Wk, Wt), f"generic_epilogue on one frozen move's {len(seg.host)} "
                               f"outputs ({raw.numel()} entries, {seg.nblk} blocks): "
                               "bit-exact")
    time_case(rec, "generic_epilogue", lambda: (kgen.generic_epilogue(raw, seg, Wk), Wk)[1],
              lambda: (kgen.generic_epilogue_twin(raw, seg, Wt), Wt)[1], None,
              8 * 2 * raw.numel(), raw.numel(), FP64_CC)
    sk, stw = kgen.sweep_state(X, 10, 0.0), kgen.sweep_state(X, 10, 0.0)
    kgen.sweep_commit(sk, Wk)
    kgen.sweep_commit_twin(stw, Wk)
    e_d = rel_err(sk.dist2, stw.dist2)
    check(torch.equal(sk.S, stw.S) and torch.equal(sk.ctl[:2], stw.ctl[:2])
          and e_d <= TOL[torch.float64],
          f"sweep_commit over the env's {X.numel()} entries: state bit-exact, (i, done) "
          f"{sk.ctl[:2].tolist()}, dist2 {float(sk.dist2):.6e} rel err {e_d:.1e} <= 1e-12")
    sk2, st2 = kgen.sweep_state(X, 10**9, -1.0), kgen.sweep_state(X, 10**9, -1.0)
    time_case(rec, "sweep_commit", lambda: (kgen.sweep_commit(sk2, Wk), sk2.S)[1],
              lambda: (kgen.sweep_commit_twin(st2, Wk), st2.S)[1], None,
              8 * 3 * X.numel(), 3 * X.numel(), FP64_CC)
    rec["sweep_commit"]["max_abs_err"] = max(rec["sweep_commit"]["max_abs_err"],
                                             float((sk.dist2 - stw.dist2).abs()))
    gen = torch.Generator(device=dev).manual_seed(10)
    g = torch.rand(X.numel(), generator=gen, device=dev, dtype=torch.float64) - 0.5
    for sg in (True, False):
        e = rel_err(kgen.generic_epilogue_vjp(raw, g, seg, sg),
                    kgen.generic_epilogue_vjp_twin(raw, g, seg, sg))
        check(e <= TOL[torch.float64], f"generic_epilogue_vjp (sg_norm={sg}): rel err "
                                       f"{e:.1e} <= 1e-12")
    time_case(rec, "generic_epilogue_vjp", lambda: kgen.generic_epilogue_vjp(raw, g, seg),
              lambda: kgen.generic_epilogue_vjp_twin(raw, g, seg), None,
              8 * 3 * raw.numel(), 5 * raw.numel(), FP64_CC)
    del raws, raw, Wk, Wt, sk, stw, sk2, st2, g

    # (c) the frozen engine from the context: its sweeps timed by parts under
    # the profiler (the plans of its first move are (a)'s), then the same
    # sweeps dynamically from the same start
    plan0 = ab_tensor.plan_cache_stats()
    timers, out = PhaseTimers(), []
    torch.cuda.synchronize()
    reset_launch_counts()
    wall_f, dev_f = busy_share(lambda: out.append(gfz.run_frozen_generic(
        st_c, env_c, keeps, max_iter=GEN_FROZEN_SWEEPS, conv_tol=0.0, timers=timers)))
    counts_frozen = launch_counts()
    plan1 = ab_tensor.plan_cache_stats()
    env_f, nf, d2f = out[0]
    split = {k: 1000 * v / nf for k, v in timers.t.items()}
    ms_frozen = 1000 * wall_f / nf
    print(f"  frozen: {nf} sweep(s), dist2 {d2f:.3e}, {ms_frozen:.1f} ms/sweep under the "
          f"profiler with phase events: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f" ms; busy share {dev_f / wall_f:.3f} ({1000 * dev_f / nf:.1f} ms device per "
          f"sweep); {plan1['misses'] - plan0['misses']} plans built (plan cache "
          f"{plan1['size']} of {ab_tensor.PLANS.size})")
    print("  launches in the frozen run: " + ", ".join(f"{k} {counts_frozen[k]}"
                                                      for k in GENERIC))
    check(plan1["misses"] == plan0["misses"],
          "the frozen sweep built no plan after the epoch's (its first pass)")
    check(all(counts_frozen[k] > 0 for k in GENERIC),
          "the frozen run launched block_gemm, block_permute, generic_epilogue and "
          "sweep_commit")
    rec["generic_epilogue"]["ms_per_frozen_sweep"] = ms_frozen
    rec["generic_epilogue"]["frozen_sweep_split_ms"] = split
    env_d = env_c
    t0 = time.perf_counter()
    for _ in range(nf):
        for d in dirs:
            env_d = gct.ctm_move(d, st_c, env_d, AB_CHI, AB_PK)
    torch.cuda.synchronize()
    ms_dyn = 1000 * (time.perf_counter() - t0) / nf
    e_fz = float(model.energy_per_site(st_c, env_f))
    e_dy = float(model.energy_per_site(st_c, env_d))
    check(abs(e_fz - e_dy) <= AB_E_FROZEN_TOL,
          f"energy after {nf} sweep(s) from the context: frozen {e_fz:.12f}, dynamic "
          f"{e_dy:.12f} ({ms_dyn:.1f} ms/sweep), |dE| {abs(e_fz - e_dy):.2e} <= "
          f"{AB_E_FROZEN_TOL:.0e}")
    del env_f, env_d, env_c

    rec["generic_epilogue_vjp"].update(rec_t)

    # (f) D=3: card against the CPU twins from one CPU-built start
    st_c = gen_state(AB_SMALL_AUX, "cpu", seed=1)
    cfg_s = gen_cfg(["--chi", str(GEN_SMALL_CHI), "--CTMARGS_ctm_max_iter", str(GEN_SMALL_DYN),
                     "--CTMARGS_ctm_conv_tol", "0"])
    out = []
    for where in ("cpu", dev):
        st_s = st_c.to(where)
        env_s, _ = gct.run(st_s, genv.init_env(st_s, GEN_SMALL_CHI), cfg_s.ctm)
        out.append((gct._corner_spectra(env_s, GEN_SMALL_CHI), env_s, float(
            J1J2_ABELIAN(j1=J1, j2=J2, device=where).energy_per_site(st_s, env_s))))
    d_spec = float(np.abs(out[0][0] - out[1][0]).max())
    check(d_spec <= AB_SMALL_TOL and abs(out[0][2] - out[1][2]) <= AB_SMALL_TOL,
          f"D=3 chi={GEN_SMALL_CHI} card vs CPU: {GEN_SMALL_DYN} dynamic sweeps' corner spectra "
          f"max diff {d_spec:.2e}, energy |dE| {abs(out[0][2] - out[1][2]):.2e} <= "
          f"{AB_SMALL_TOL:.0e}")
    _, keeps_s, envc_s = gen_frozen(st_c, out[0][1], GEN_SMALL_CHI)
    res = []
    for where in ("cpu", dev):
        e = genv.ENV_ABELIAN(GEN_SMALL_CHI, {k: t.to(where) for k, t in envc_s.C.items()},
                             {k: t.to(where) for k, t in envc_s.T.items()})
        res.append(gfz.run_frozen_generic(st_c.to(where), e, keeps_s, max_iter=GEN_SMALL_FROZEN,
                                          conv_tol=0.0))
    (ec, nc, dc), (ed, nd, dd) = res
    e_C = max(float((ec.C[k].data - ed.C[k].data.cpu()).abs().max()) for k in ec.C)
    e_T = max(float((ec.T[k].data.abs() - ed.T[k].data.cpu().abs()).abs().max()) for k in ec.T)
    e_Ts = max(float((ec.T[k].data - ed.T[k].data.cpu()).abs().max()) for k in ec.T)
    check(nc == nd and e_C <= AB_SMALL_TOL and e_T <= AB_SMALL_TOL,
          f"D=3 frozen {nc} sweeps card vs CPU: C elementwise {e_C:.2e}, |T| elementwise "
          f"{e_T:.2e} <= {AB_SMALL_TOL:.0e} (T signed {e_Ts:.2e}), dist2 {dd:.6e} vs {dc:.6e}")
    # the gradient of the training loss (normalized sites, the frozen fixed
    # point's implicit adjoint, the energy) from one CPU-built context, on the
    # Neel state of the CPU tests, whose frozen sweep reaches its fixed point
    st_g = neel_state_np(AB_SMALL_AUX)
    cfg_g = gen_cfg(["--chi", str(GEN_GRAD_SMALL_CHI), "--CTMARGS_ctm_max_iter", "30",
                     "--CTMARGS_ctm_conv_tol", "1e-10", "--GLOBALARGS_device", "cpu"])
    _, ctx_fn_g, _, _ = generic_abelian_losses(st_g, J1J2_ABELIAN(
        j1=J1, j2=J2, device="cpu").energy_per_site, cfg_g)
    with torch.no_grad():
        profiles_g, ctx_g = ctx_fn_g({c: a.data for c, a in st_g.sites.items()})
    grads = []
    for where in ("cpu", dev):
        st_w = st_g.to(where)
        conv = gfz.make_converge_frozen_generic(st_w, GEN_GRAD_SMALL_CHI, profiles_g,
                                                gfz.MOVE_SEQ, 30, 1e-10, 1e-12)
        pw = {c: a.data.clone().requires_grad_() for c, a in st_w.sites.items()}
        sites = {c: flat_like(st_w.sites[c], pw[c]) for c in pw}
        sites = {c: a * (1.0 / a.norm()) for c, a in sites.items()}
        stats_w = {}
        e_w = genv.ENV_ABELIAN(GEN_GRAD_SMALL_CHI, {k: t.to(where) for k, t in ctx_g.C.items()},
                               {k: t.to(where) for k, t in ctx_g.T.items()})
        envf = conv(sites, e_w, stats_w)
        st_n = type(st_w)(st_w.sym, sites, st_w.vertexToSite, st_w.lX, st_w.lY)
        lw = J1J2_ABELIAN(j1=J1, j2=J2, device=where).energy_per_site(st_n, envf)
        gw = torch.autograd.grad(lw, list(pw.values()))
        grads.append((float(lw.detach()), torch.cat([x.reshape(-1).cpu() for x in gw]),
                      stats_w))
        if where != "cpu":  # a step along -g descends: the central difference along g/|g|
            gn = float(torch.sqrt(sum((x ** 2).sum() for x in gw)))
            dv = {c: x / gn for c, x in zip(pw, gw)}
            with torch.no_grad():
                def loss_at(sign):
                    s_ = {c: flat_like(st_w.sites[c], st_w.sites[c].data + sign * 1e-5 * dv[c])
                          for c in pw}
                    s_ = {c: a * (1.0 / a.norm()) for c, a in s_.items()}
                    st_s = type(st_w)(st_w.sym, s_, st_w.vertexToSite, st_w.lX, st_w.lY)
                    return float(J1J2_ABELIAN(j1=J1, j2=J2, device=where).energy_per_site(
                        st_s, conv(s_, e_w)))
                fd_g = (loss_at(1.0) - loss_at(-1.0)) / 2e-5
    (lc, gc, sc), (ld, gd, sd) = grads
    check(math.isfinite(fd_g) and fd_g > 0,
          f"D=3 chi={GEN_GRAD_SMALL_CHI} on the card, a step along -g descends: the central "
          f"difference along g/|g| (h=1e-5) {fd_g:.9e} > 0, |g| {float(gd.norm()):.9e}, "
          f"relative difference {abs(fd_g - float(gd.norm())) / float(gd.norm()):.2e}")
    e_g = rel_err(gd, gc)
    check(e_g <= GEN_GRAD_SMALL_TOL and abs(lc - ld) <= AB_SMALL_TOL,
          f"D=3 chi={GEN_GRAD_SMALL_CHI} generic gradient card vs CPU: rel err {e_g:.2e} <= "
          f"{GEN_GRAD_SMALL_TOL:.0e}, loss |dE| {abs(lc - ld):.2e}; forward sweeps "
          f"{sd['forward_sweeps']} (CPU {sc['forward_sweeps']}), adjoint iterations "
          f"{sd['adjoint_iters']} (CPU {sc['adjoint_iters']}), R != 1 {sd['sign_aligned']} "
          f"(CPU {sc['sign_aligned']})")
    return rec, counts_entry, counts_frozen, counts_train


# what each -DTPEPS_ABLATE bit leaves out (csrc/cholqr.cu, csrc/ozaki.cu,
# csrc/eigh_small.cu); the copies of eigh_small.cu run every sweep (64), as
# many as the whole kernel needed
ABLATIONS = {"cholqr.cu": {0: "whole", 1: "no loads", 2: "no MMAs", 3: "no loads, no MMAs",
                           4: "no k loop", 8: "no panel updates", 16: "no substitutions",
                           24: "no panel updates, no substitutions",
                           56: "no panel updates, no substitutions, no tile loads or stores"},
             "ozaki.cu": {0: "whole", 2: "no wgmmas", 8: "no recombination", 16: "no stores"},
             "eigh_small.cu": {0: "whole", 64: "whole, every sweep", 65: "no subproblems",
                               66: "no H updates", 68: "no V updates",
                               71: "no subproblems, no H or V updates",
                               72: "every subproblem a full sweep in every round"}}
ABLATE_KERNELS = ("gram_kernel", "ozaki_gemm_kernel", "trsm_kernel", "block_jacobi")


def ablate(parent=None) -> dict:
    """Where the time of K3's Gram and solves, K7's ``ozaki_gemm`` and
    ``eigh_small`` goes: each source built again with one part of its
    kernel left out (``-DTPEPS_ABLATE``, one nvcc each, all started
    together), each copy's ptxas registers, and each called through its C
    entry on the same seeded inputs and timed side by side (:func:`graph_ms`,
    the smaller of two means, the copies in turn and then in reverse).  The
    Gram at k = chi in f64, ``gram`` and ``gram_ridge``; ``ozaki_gemm`` at the
    sliced and the ket layers and at M2 P, beside FP64 ``torch.matmul``; the
    solves at n = chi D^2 and k = chi, chi + 8 in f64 and f32 beside
    ``torch.linalg.solve_triangular``; ``eigh_small`` on the Rayleigh-Ritz H of
    moves 4 and 31 of the D=7 path and on dense random H of k = 169 and 64
    beside ``torch.linalg.eigh``.  With ``parent``, the root of another
    checkout, its ``cholqr.cu`` is built too and its solves timed first and
    last in the same turns (parent, change, change, parent).  Run by
    ``chip_smoke.py --ablate [--parent DIR]``."""
    import ctypes

    from tpeps_torch.kernels import build as kb
    from tpeps_torch.kernels import ozaki

    print("== ablation: K3 gram and solves, K7 ozaki_gemm, eigh_small with parts left out",
          flush=True)
    dev = torch.device("cuda", 0)
    out_dir = kb.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kb.find_nvcc(), {}
    builds = {(src, bits): (f"-DTPEPS_ABLATE={bits}", label, kb.CSRC_DIR / src)
              for src, variants in ABLATIONS.items() for bits, label in variants.items()}
    if parent is not None:
        builds["cholqr.cu", "parent"] = ("-DTPEPS_ABLATE=0", "parent",
                                         Path(parent) / "tpeps_torch" / "csrc" / "cholqr.cu")
    try:
        for (src, key), (flag, _, path) in builds.items():
            so = out_dir / f"{Path(src).stem}_{key}.so"
            cmd = [nvcc, *kb.NVCC_FLAGS, flag, "-shared", str(path), "-o", str(so)]
            procs[src, key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
        libs = {}
        for (src, key), (so, proc) in procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"nvcc {src} {builds[src, key][0]}: {log[-2000:]}")
            for name, line in ptxas_lines(log):
                if name.startswith(ABLATE_KERNELS):
                    print(f"  ptxas {src} {builds[src, key][1]}: {name}: {line}")
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in kb._SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
            for fn, argtypes in kb._SIZE_QUERIES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).restype = ctypes.c_int64
                    getattr(lib, fn).argtypes = argtypes
            libs[src, key] = lib
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def in_turns(calls: dict, reps: int, replays: int) -> dict:
        first = {k: graph_ms(fn, reps, replays) for k, fn in calls.items()}
        second = {k: graph_ms(calls[k], reps, replays) for k in reversed(list(calls))}
        return {k: min(first[k], second[k]) for k in calls}

    def stream():  # the capturing stream inside a graph
        return torch.cuda.current_stream(dev).cuda_stream

    gen = torch.Generator(device=dev).manual_seed(0)
    rec = {}
    n, k = CHI * D * D, CHI
    A = torch.randn(n, k, generator=gen, device=dev, dtype=torch.float64)
    B = torch.randn(n, k, generator=gen, device=dev, dtype=torch.float64)
    G = torch.empty(k, k, dtype=torch.float64, device=dev)
    for label, X, Y, eps, sym in (("gram", A, B, 0.0, 0), ("gram_ridge", A, A, 1e-12, 1)):
        calls = {}
        for bits in (0, 1, 2, 3, 4):
            lib = libs["cholqr.cu", bits]
            scratch = lib.tpeps_gram_scratch_f64(n, k, k, sym)
            check(scratch >= 0, f"{label} scratch query: {scratch}")
            part = torch.empty(max(scratch, 1), dtype=torch.float64, device=dev)
            counters = torch.zeros(4096, dtype=torch.int32, device=dev)

            def call(lib=lib, part=part, counters=counters, X=X, Y=Y, eps=eps, sym=sym):
                err = lib.tpeps_gram_clusters_f64(X.data_ptr(), Y.data_ptr(), part.data_ptr(),
                                                  counters.data_ptr(), 4096, G.data_ptr(), n, k,
                                                  k, eps, sym, stream())
                if err:
                    fail(f"{label} launch: CUDA error {err}")
            calls[ABLATIONS["cholqr.cu"][bits]] = call
        calls["torch.matmul"] = lambda X=X, Y=Y: torch.matmul(X.mT, Y)
        rec[f"{label} f64 {n} x {k}"] = ms = in_turns(calls, 20, 5)
        print(f"  {label} f64 {n} x {k}: " + ", ".join(f"{v} {t * 1000:.1f} us"
                                                     for v, t in ms.items()), flush=True)
    del A, B
    kind_c, coef_c = ozaki._table_c(8, 7)
    for label, (m, kk, nn) in {"sliced layer": (D * D, D * D, D * D * CHI * CHI),
                               "ket layer": (2 * D * D, D * D, D * D * CHI * CHI),
                               "M2 P": (n, n, CHI)}.items():
        X = torch.randn(m, kk, generator=gen, device=dev, dtype=torch.float64)
        Y = torch.randn(kk, nn, generator=gen, device=dev, dtype=torch.float64)
        Xp, ex = ozaki.ozaki_split(X, 8, 7, 1)
        Yp, ey = ozaki.ozaki_split(Y, 8, 7, 0)
        C = torch.empty(m, nn, dtype=torch.float64, device=dev)
        calls = {}
        for bits in ABLATIONS["ozaki.cu"]:
            def call(lib=libs["ozaki.cu", bits]):
                err = lib.tpeps_ozaki_gemm(Xp.data_ptr(), ex.data_ptr(), Yp.data_ptr(),
                                           ey.data_ptr(), C.data_ptr(), m, nn, Xp.shape[2], 8, 7,
                                           kind_c, coef_c, stream())
                if err:
                    fail(f"ozaki_gemm {label} launch: CUDA error {err}")
            calls[ABLATIONS["ozaki.cu"][bits]] = call
        calls["FP64 torch.matmul"] = lambda X=X, Y=Y: torch.matmul(X, Y)
        rec[f"ozaki_gemm {label} {m} x {kk} by {kk} x {nn}"] = ms = in_turns(calls, 5, 2)
        print(f"  ozaki_gemm {label} {m} x {kk} by {kk} x {nn}: "
              + ", ".join(f"{v} {t:.3f} ms" for v, t in ms.items()), flush=True)
        del X, Y, Xp, Yp, C
    rec.update(ablate_solves(libs, in_turns, stream, dev, parent is not None))
    rec.update(ablate_eigh(libs, in_turns, stream, dev))
    return rec


def ablate_solves(libs, in_turns, stream, dev, with_parent) -> dict:
    """:func:`ablate`'s part for K3's two solves (the parent's first and
    last in the turns ``with_parent``)."""
    rec, n = {}, CHI * D * D
    gen = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        sfx = "f64" if dtype == torch.float64 else "f32"
        for k in (CHI, CHI + 8):
            W = well_conditioned(k, gen, torch.float64, dev)
            L = torch.linalg.cholesky(W.mT @ W).to(dtype).contiguous()
            P = torch.randn(n, k, generator=gen, device=dev, dtype=dtype)
            Q = torch.empty_like(P)
            for fn, twin in (("tpeps_trsm_right_lower_h", lambda: torch.linalg.solve_triangular(
                                  L.mT, P, upper=True, left=False)),
                             ("tpeps_trsm_right_lower", lambda: torch.linalg.solve_triangular(
                                 L, P, upper=False, left=False))):
                calls = {}
                for bits in (("parent",) if with_parent else ()) + (0, 8, 16, 24, 56):
                    def call(f=getattr(libs["cholqr.cu", bits], f"{fn}_{sfx}")):
                        err = f(L.data_ptr(), P.data_ptr(), Q.data_ptr(), n, k, stream())
                        if err:
                            fail(f"{fn} launch: CUDA error {err}")
                    calls[ABLATIONS["cholqr.cu"].get(bits, bits)] = call
                calls["torch.linalg.solve_triangular"] = twin
                label = f"{fn[6:]} {tag} {n} x {k}"
                rec[label] = ms = in_turns(calls, 20, 5)
                print(f"  {label}: " + ", ".join(f"{v} {t * 1000:.1f} us" for v, t in ms.items()),
                      flush=True)
    return rec


def ablate_eigh(libs, in_turns, stream, dev) -> dict:
    """:func:`ablate`'s part for ``eigh_small``: each H first through the
    whole kernel (its sweeps), then every copy at that many sweeps."""
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.kernels.eigh_small import MAX_SWEEPS

    rec = {}
    a = bench_state(D, dev)
    env = init_env(a, CHI, "CTMRG")
    T_int = mf.to_int_layout(env.T, D)
    gen = torch.Generator(device=dev).manual_seed(4)
    with torch.inference_mode():
        cases = {f"H of move {n + 1}": rayleigh_ritz_H(a, env.C, T_int, n) for n in (3, 30)}
    for k in (EIGH_BIG, 64):
        X = torch.randn(k, k, generator=gen, device=dev, dtype=torch.float64)
        cases[f"dense k={k}"] = (0.5 * (X + X.mT)).contiguous()
    for label, H in cases.items():
        k = H.shape[0]
        w = torch.empty(k, dtype=H.dtype, device=dev)
        Vt = torch.empty_like(H)
        state = torch.zeros(2, dtype=torch.int32, device=dev)

        def run(key, sweeps):
            err = libs["eigh_small.cu", key].tpeps_eigh_small_f64(
                H.data_ptr(), w.data_ptr(), Vt.data_ptr(), state.data_ptr(), k, sweeps, stream())
            if err:
                fail(f"eigh_small launch: CUDA error {err}")
        run(0, MAX_SWEEPS)
        sweeps, conv = state.tolist()
        calls = {ABLATIONS["eigh_small.cu"][bits]: (lambda b=bits: run(b, MAX_SWEEPS if b == 0
                                                                          else max(sweeps, 1)))
                 for bits in ABLATIONS["eigh_small.cu"]}
        ms = in_turns(calls, 3, 2)
        # cuSOLVER's eigh does not capture into a CUDA graph: eager
        ms["torch.linalg.eigh (eager)"] = cuda_ms(lambda: torch.linalg.eigh(H))
        rec[f"eigh_small {label}"] = {"sweeps": sweeps, "converged": conv, **ms}
        print(f"  eigh_small {label} (k={k}, {sweeps} sweeps, converged={bool(conv)}): "
              + ", ".join(f"{v} {t:.3f} ms" for v, t in ms.items()), flush=True)
    return rec


def main() -> None:
    t_start = time.perf_counter()

    def lap(n):  # the script's seconds so far, at the end of phase n
        print(f"  phase {n} ended at {time.perf_counter() - t_start:.1f} s", flush=True)

    smi = phase0()
    dev = torch.device("cuda", 0)
    phase1()
    lap(1)
    rec = phase2(dev)
    rec.update(phase2_large_d(dev))
    lap(2)
    counts_fwd = phase3(dev)
    phase4(dev)
    lap(4)
    counts_train = phase5(dev)
    lap(5)
    phase6(dev)
    lap(6)
    counts_large, oz_launches = phase7(dev)
    for sh in rec["ozaki_gemm"]["shapes"].values():  # phase 7(c)'s eager Ozaki move
        m, k, n = sh["shape"]
        sh["launches_per_ozaki_move"] = oz_launches.get((sh["slices"], m, sh["kp"], n), 0)
    lap(7)
    rec_ab, counts_ab, counts_fz = phase8(dev)
    rec.update(rec_ab)
    lap(8)
    rec_tr, counts_grad, counts_abtr = phase9(dev)
    rec.update(rec_tr)
    lap(9)
    rec_gen, cg_entry, cg_frozen, cg_train = phase10(dev)
    rec.update(rec_gen)
    lap(10)
    # launches: on the training path for its kernels, on the large-D slice
    # for K5/K7, on the abelian entry point for K8 and converge_frozen for
    # K9, on the abelian training entry point for K8's and K9's backward,
    # else on the forward path (K1, K2, K4 and eigh_small); K10 on the generic
    # training entry point
    main_run = lambda name: (cg_train if name in GEN_K10
                             else counts_train if name in TRAIN
                             else counts_large if name in LARGE_D
                             else counts_fz if name == "frozen_commit"
                             else counts_ab if name in ABELIAN
                             else counts_abtr if name in AB_TRAIN else counts_fwd)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": main_run(name)[name],
         "launches_forward_slice": counts_fwd[name],
         "launches_training_slice": counts_train[name],
         "launches_large_d_slice": counts_large[name],
         "launches_abelian_entry_point": counts_ab[name],
         "launches_abelian_frozen": counts_fz[name],
         "launches_abelian_gradient": counts_grad[name],
         "launches_abelian_training": counts_abtr[name],
         "launches_generic_entry_point": cg_entry[name],
         "launches_generic_frozen": cg_frozen[name],
         "launches_generic_training": cg_train[name], **rec[name]}
        for name in SOURCES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ablate"]:
        parent = sys.argv[3] if sys.argv[2:3] == ["--parent"] else None
        print(phase0())
        phase1()
        print(json.dumps({"ablation": ablate(parent)}))
    else:
        main()
