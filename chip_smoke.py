#!/usr/bin/env python3
"""Smoke run of the tpeps_torch port on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card and ``nvcc`` (CUDA_HOME, PATH or the toolkit's default
prefix).  It needs no network and no JAX.  ``python3 chip_smoke.py --ablate
[--parent DIR] [--only PARTS]`` runs phases 0 and 1 and then only
:func:`ablate`, the timing breakdown of K1's fused double layer, K2's
corner apply (its float32 kernel apart: ``corner``), K3's Gram and solves,
K4's epilogue, K6's polar factor and its VJP, K7's ``ozaki_split`` and
``ozaki_gemm``, K8, ``eigh_small``, K5's and K9's commits, K9's
``adjoint_commit`` (``adjoint``) and K10's epilogue (with a parent
checkout: its kernels, its cold start, its graphed move, its Ozaki move,
its mixed driver and its frozen move beside these).

Phases (any failed check exits non-zero; there is no CPU fallback):

0. the card: name and power limit (nvidia-smi), torch/CUDA versions;
   TF32 off for matmuls and cuDNN.
1. build: nvcc compiles ``tpeps_torch/csrc/*.cu`` into
   ``tpeps_torch/_build/``; prints the build seconds.
2. kernels vs their plain torch twins on the card at the slice's shapes
   (J1-J2 C4v, D=7, chi=147), in float64 (max relative error <= 1e-12)
   and float32 (<= 1e-5, summation order differs), K1/K4 with and without
   the physical-index slicing (:func:`fused_checks`: K1 also at both call
   sites' layouts at chi = 155 and 169 and with chi_n != chi, K2 at n and m
   that are no multiples of its tiles and at chi = 155 and 169, two calls
   bit-identical; K2's float32 kernel also replayed in a CUDA graph and
   timed in graphs beside ``torch.matmul`` in float32 at each shape, and on
   operands that stress its TF32 hi/lo split (:func:`k2_split_checks`:
   exponents 2^-30 .. 2^30 in every row, zeros, subnormals, NaN, +-inf;
   1e-5 relative, also by row, NaN and inf where the twin has them)), K6
   (:func:`polar_checks`: the overlaps of moves 1, 4 and 31 of the D=7
   path and a random well-conditioned one against the twin, graded
   overlaps against their exact U V^T, singular and ridged singular ones
   and a run capped short of convergence giving I, k = 169 and 192, the
   VJP at k = chi and 169); kernel, twin and library times from CUDA
   events, and each kernel's bound: the bytes its function must move at
   3.35 TB/s or its FP64 operations at 67 TFLOP/s on the tensor cores (34
   TFLOP/s off them, elementwise work), counting only what a symmetric
   result needs.  K3's ``gram_ridge`` and ``gram`` also at
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
   kernel to the twin in forward error <= 2 k u cond(L)).  K4's
   ``t_epilogue`` (:func:`epilogue_checks`) at m = 147, 155, 169, 17 and
   200 (its second pass), batch 1 and 49, f64 and f32: the max normalisation bit-identical to the
   twin, the 2-norm within 1e-12 (f64) or 1e-5 (f32) relative, two calls
   and a CUDA graph's replay bit-identical; timed in graphs.
3. the forward slice: the D=7, chi=147 float64 state of the benchmark case
   (RandomState(0), C4v-symmetrized), init_env("CTMRG"), run_ctmrg
   (max_iter=48, conv_tol=1e-8, n_power=2), energy_1x1_lowmem (j2=0.3)
   and eval_obs.  Every forward kernel must have launched, the energy must
   be finite; K6's calls by Newton-Schulz steps (one read of the card's
   histogram, as after phase 5 and phase 7(e)).  Then 4 moves of the same path with the twins (K6 included),
   against 4 moves with the kernels.
4. D=2, chi=16 end to end on the card and on the CPU (twins): energies
   agree to 1e-10.
5. the training slice at full width: 2 L-BFGS epochs of the port's entry
   point (``optimize_c4v``) on the D=7, chi=147 float64 state, POWER
   projector, implicit gradient (24 forward moves, 24 adjoint iterations),
   backtracking line search with POWER, observables and final energy with
   SYMEIG (reference-layout fixed points throughout, as the JAX script).
   Loss and gradient finite, the loss not rising, every K3 and K6 kernel
   launched, forward and backward; seconds per part, peak memory, launches.
   The overlaps of K6's calls that dropped W (gave I) are kept on the card
   and read once at the end: sigma_min/sigma_max, the twin's result; the
   kernel must keep W wherever the twin does at a ratio of 1e-10 or more.
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
   launches by shape and ``ozaki_split`` launches by (axis, rows, k), which
   must be phase 2's split shapes; (d) ``MoveGraph``
   refuses chi=170, past the move's kernels on the card; (e)
   ``run_ctmrg_mixed`` with the JAX package's ``bench_case`` arguments
   (max_iter 48, conv_tol 1e-8, moves_per_sync 4, physical-index slicing
   for the float64 moves only): per-phase moves, ms/move, distance and K2
   launches (K2 must launch in both float32 phases), the energy, peak
   memory and the launches; ``ozaki_split``, ``ozaki_gemm`` and
   ``ctm_commit`` must launch; then the float64 ``run_ctmrg``
   (``dot_impl="xla"``) for as many moves from the same start: energies
   within 1e-8, corner spectra within 1e-5.

8. the abelian slice, U(1) C4v J1-J2 (j2=0.3) at D=8 (aux sectors
   {-2:1,-1:2,0:2,1:2,2:1}), chi=160, float64, a random state from a seeded
   generator (C4v-projected, normalized) written to JSON: (a) K8
   ``block_gemm`` on each of a dynamic move's ten tensordots (<= 1e-12
   relative, two calls bit-identical; each class of its schedule timed alone
   beside its bound), ``block_permute`` on every permute table of the move,
   the largest operand's, the corner's sector gather and its inverse
   (bit-exact), and K9 ``frozen_commit`` (:func:`frozen_commit_checks`: on
   a frozen move's raw outputs and on a copy whose largest magnitude ties
   many times, C, T bit-exact, dist2 <= 1e-12 relative; a loop that ended
   untouched; two calls bit-identical; timed in CUDA graphs too) against
   their twins at the move's shapes, with kernel, twin and bound times (``block_gemm``'s twin is the JAX package's design: one
   ``torch.bmm`` per shape group and ``index_add_``); the sector SVD drivers
   timed on the largest +-q sector;
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
   (``block_gemm`` on the dA and dB tables, <= 1e-12 relative, two calls
   bit-identical;
   ``block_permute`` on the largest operand's inverse table, bit-exact),
   ``frozen_epilogue_vjp`` (<= 1e-12 relative) and ``adjoint_commit`` (one
   step <= 1e-12 relative; the loop on crafted |u|^2 sequences, counters
   bit-exact; :func:`adjoint_checks` in f64 and f32: buffers off their
   16-byte boundaries, sizes 1 and odd, an ended loop untouched, two calls
   bit-identical, timed in CUDA graphs) against their twins, with
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
   chi profiles, peak memory), K8 ``block_gemm`` on one more directional
   move's tensordots against its twin (<= 1e-12 relative, two calls
   bit-identical) and that move's busy share;
   (e) GEN_TRAIN_EPOCHS L-BFGS epoch(s) of
   ``tpeps_torch.examples.j1j2.abelian.optim_j1j2_u1`` on the same file
   (GEN_TRAIN_SWEEPS sweeps per context and frozen fixed point, the adjoint
   at most GEN_ADJ_MAX_ITER iterations; losses and gradients finite, every
   kernel of the path launched), whose first gradient closure is (d)
   (frozen forward, adjoint, energy both ways, peak memory); on the closed
   context of (e)'s epoch, (a) K10 against its twins at one frozen move's
   shapes (``generic_epilogue`` bit-exact, two calls bit-identical, also
   timed in CUDA graphs; ``sweep_commit``'s state bit-exact and dist2 <=
   1e-12 relative, ``generic_epilogue_vjp`` both ways <= 1e-12 relative;
   K9's ``adjoint_commit`` at the generic adjoint's sizes by
   :func:`adjoint_checks`) with kernel, twin and bound times, and (c) the
   frozen
   sweep (ms per sweep split into halves, decompositions, absorption,
   epilogue/commit; busy share; no plan built) and the same sweeps
   dynamically (energies within AB_E_FROZEN_TOL); (f) D=3: chi=18 dynamic
   spectra and energy (GEN_SMALL_DYN sweeps) and 3 frozen sweeps (C, |T|)
   card vs CPU (1e-10), the chi=9 gradient from a converged context card vs
   CPU (1e-8 relative) and, on the card, the central difference along g/|g|
   (> 0) next to |g|; the CPU side of (f) runs in a worker process
   (:func:`gen_small_cpu`) started at the top of the phase, beside (b)-(c).
11. the C4v observables slice (no kernel of its own: the transfer matvecs,
   correlators and RDMs are cuBLAS products): (a) on phase 3's D=7 chi=147
   environment, ``energy_1x1`` (the full plaquette RDM, its peak memory)
   against ``energy_1x1_lowmem`` (1e-10), ``rdm1x1_sl``, one width-1
   transfer matvec timed whole and by step beside its bound,
   ``eval_corrf_SS(8)`` (r=1 against ``eval_obs``'s SS2x1, 1e-10),
   ``eval_corrf_DD_H(4)``, ``get_Top_spec_c4v(4)`` at m = 30 and 40
   (normalized, |lambda| the same within 1e-8, the leading Ritz residual
   <= 1e-8); (b) the entry point ``tpeps_torch.examples.j1j2.ctmrg_j1j2_c4v``
   on phase 3's state written to JSON (4 SYMEIG moves, correlators to r=4,
   4 eigenvalues: finite, normalized; OBS_PATH's kernels launched);
   (c) D=2 chi=16: the entry point on the card against the CPU (energy and
   correlators 1e-10, spectrum 1e-8) and one epoch of ``optim_j1j2_c4v
   --top_freq 1`` printing its ``TOP`` line; (d) D=3 chi=27 card against
   the CPU on one CPU-converged environment: ``get_Top2_spec_c4v`` (1e-8),
   ``eval_corrf_DD_V`` (1e-10), ``aux_rdm1x1``/``ddA_rdm1x1`` (1e-12), and
   ``fpcm_move_sl`` after 4 moves against the standard fixed point's energy
   (1e-9).  The phase must stay within OBS_BUDGET_S.

Phase 2 also holds the kernels of the large-D slice against their twins at
its shapes: ``eigh_small`` on the Rayleigh-Ritz H of moves 4 and 31 of the
D=7 path, at subspace_eigh's width (155), on a dense 64 (the D=2 SYMEIG
shape), on an H with exactly degenerate pairs and on a dense random matrix
of its largest k, 169 (converged, eigenvalues <= 1e-12 relative, residual
and orthogonality <= 1e-12, two calls bit-identical), ``ozaki_split``
(:func:`split_checks`) at every split shape of the Ozaki move
(:data:`SPLIT_SHAPES`: M2's rows, P^T's, T's, C's and a layer's A; the
columns of C T's and T P's B, of a layer's B, of P and of Z) and on a
layer's ket A (digit planes with their padding and exponents bit-identical
to the twin, two calls bit-identical, and in a CUDA graph; each shape timed
in graphs beside its bound), on rows and columns of mixed exponents at k =
1, 31, 33, 147 and 7203 with a zero row, a row of subnormals below 2^-1024
and one of subnormals in [2^-1023, 2^-1022) at s = 8, 6, 2 (w = 7) and w =
5 (the table-driven instance), past one block's staging (k = 30000 rows,
k = 20000 and 8281 columns), and with a NaN row and an infinite row
(exponents as the twin's, those rows of the product non-finite),
``ozaki_gemm`` bit-identical to its twin (``torch.equal``) at every product
shape of the Ozaki move (M2 P; C T, 147 x 147 by 147 x 7203; T (C T) and T P,
7203 x 147 by 147 x 7203; the sliced layer, 49 x 49 by 49 x 1.06M; P^T Z, 147
x 7203 by 7203 x 7203) and at the unsliced ket and bra layers (98 x 49 by
49 x 1.06M, 49 x 98 by 98 x 1.06M), each timed against FP64
``torch.matmul`` with its own bound, and ``ctm_commit``
(:func:`commit_checks`) in f64 and f32, in both convergence modes: a loop
that goes on, one that reaches max_iter, one that ended (untouched), a
non-finite dist (inf), outputs off their 16-byte boundary by one element
and outputs and inputs both off (state bit-identical to the twin, dist <=
1e-12 (f64) or 1e-5 (f32) relative, two calls bit-identical), each mode
timed eagerly and in CUDA graphs beside its bound.

The last two lines of stdout are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import io
import itertools
import json
import math
import multiprocessing
import os
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
# the training slice's forward moves per fixed point (the gradient's, the
# line search's and the SYMEIG observables': the observables' dense 7203^2
# eigh, ~0.5 s a move, is most of the phase) and adjoint iterations
TRAIN_EPOCHS, TRAIN_MAX_ITER, TRAIN_ADJ_ITER = 2, 24, 24
LOSS_SMALL_TOL, SMALL_EPOCHS = 1e-8, 3
# phase 6's states and their gradient tolerances: an exact alternative
# eigensolver moves RandomState(1)'s implicit gradient by 1.2e-10 (POWER),
# 2.7e-11 (SYMEIG) on the CPU, RandomState(0)'s by 1.1e-8 / 2.0e-8
SMALL_SEED = 1
GRAD_SMALL_TOL = {1: 1e-8, 0: 1e-7}
SOURCES = {  # kernel -> (source, TPU-path function it replaces)
    "double_layer": ("tpeps_torch/csrc/double_layer.cu", "tpeps/ctm/c4v/move_tpu.py:87"),
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
FORWARD = ("double_layer", "corner_apply", "gram_ridge", "gram", "trsm_right_lower_h",
           "t_epilogue", "polar_unitary", "eigh_small")
# the large-D slice (phase 7): the on-card loop and the Ozaki polish
LARGE_D = ("ozaki_split", "ozaki_gemm", "ctm_commit")
OZ_MOVE_SPEC_TOL, OZ_MOVE_ENV_TOL = 1e-11, 1e-10
GRAPH_SPEC_TOL, MOVES_PER_SYNC = 1e-12, 4
EIGH_BIG = 169  # eigh_small's largest k, the factored move's largest chi on the card
# K6: its largest k (one cluster of 12 blocks) and the graded overlaps'
# sigma_max/sigma_min
K6_MAX_K, K6_GRADED = 192, (1e2, 1e4, 1e6, 1e8, 1e9)
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
# gradient's chi, frozen moves and tolerance (at 8 moves the epochs' contexts
# are far from converged and the second epoch's loss rose above the first)
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
# the C4v observables slice (phase 11) on phase 3's environment: correlator
# distances, transfer eigenvalues and the Krylov sizes compared; the entry
# point's moves and distances; tolerances: energy_1x1 against the low-memory
# energy and SS r=1 against eval_obs, card against CPU (energies, correlators),
# spectra (m=30 against m=40, card against CPU), the Ritz residual, FPCM
# against the standard fixed point; the D=3 checks' chi; the phase's seconds
OBS_CORRF_R, OBS_DD_R, OBS_TOP_N, OBS_TOP_M = 8, 4, 4, (30, 40)
OBS_ENTRY_MOVES, OBS_ENTRY_R, OBS_D3_CHI = 4, 4, 27
OBS_E_TOL, OBS_SMALL_TOL, OBS_SPEC_TOL, OBS_RITZ_TOL, FPCM_E_TOL = 1e-10, 1e-10, 1e-8, 1e-8, 1e-9
OBS_BUDGET_S = 60.0
# the kernels the observables entry point runs: init_env's eigh and the
# SYMEIG moves' Procrustes alignment (the Gram and the polar factor)
OBS_PATH = ("eigh_small", "gram", "polar_unitary")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP64 on the tensor cores
# (DMMA) and on the CUDA cores, int8 on the tensor cores
HBM_BPS, FP64_TC, FP64_CC, INT8_TC = 3.35e12, 67e12, 34e12, 1979e12
# TF32 on the tensor cores, FP32 on the CUDA cores
TF32_TC, FP32_CC = 495e12, 67e12


T_START = time.perf_counter()  # the script's start, for the checks' time stamps


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {msg} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)
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
            mock.patch.object(move_factored, "double_layer", layer.double_layer_twin), \
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


K6_STEPS: dict = {}  # K6's calls by Newton-Schulz steps in each run (phases 3, 5, 7(e))


def k6_steps_reset(dev) -> None:
    if dev.type == "cuda":
        from tpeps_torch.kernels.polar import polar_stats

        polar_stats(dev).zero_()


def k6_steps_read(dev, run: str) -> dict:
    """K6's calls since :func:`k6_steps_reset` by the Newton-Schulz steps they
    took (one read of the histogram the kernel accumulates on the card),
    printed and kept for the JSON record."""
    if dev.type != "cuda":
        return {}
    from tpeps_torch.kernels.polar import polar_stats

    h = polar_stats(dev).tolist()
    out = {str(s): n for s, n in enumerate(h[:-1]) if n}
    if h[-1]:
        out["not converged"] = h[-1]
    K6_STEPS[run] = out
    print(f"  K6 polar_unitary calls by steps ({run}): {out}")
    return out


K6_CAPPED = 16  # overlaps of K6's calls that gave I, kept on the card in a run


class K6Capture:
    """Wraps the path's K6 ``polar_unitary`` (``polar_unitary_kernel`` in
    ``tpeps_torch.linalg.power``): each call passes an ``info`` tensor, and where the kernel did not keep W its
    overlap is copied into a buffer on the card (the first
    :data:`K6_CAPPED`), with no read to the host; :meth:`report` reads the
    buffer once, after the run."""

    def __init__(self, dev):
        from tpeps_torch.kernels import polar

        self.orig, self.dev = polar.polar_unitary, dev
        self.info = torch.zeros(5, dtype=torch.int32, device=dev)
        self.count = torch.zeros(1, dtype=torch.int64, device=dev)
        self.buf = {}

    def __call__(self, O, info=None, max_steps=None):
        from tpeps_torch.kernels.polar import MAX_STEPS

        W = self.orig(O, self.info, MAX_STEPS if max_steps is None else max_steps)
        if O.device.type == "cuda" and O.dtype == torch.float64:
            k = O.shape[0]
            buf = self.buf.setdefault(k, torch.zeros(K6_CAPPED, k, k, dtype=O.dtype,
                                                     device=O.device))
            dropped = (self.info[2] == 0).to(torch.int64)
            slot = self.count.clamp(max=K6_CAPPED - 1)
            keep = buf.index_select(0, slot)
            buf.index_copy_(0, slot, torch.where(dropped.bool(), O[None], keep))
            self.count += dropped
        if info is not None:
            info.copy_(self.info)
        return W

    def report(self, label: str) -> list:
        """Each captured overlap: sigma_min/sigma_max (FP64 SVD), whether
        the twin keeps W, the kernel's steps; checks that the kernel keeps W
        wherever the twin does at sigma_min/sigma_max >= 1e-10 (the JAX
        guard's edge)."""
        from tpeps_torch.kernels.polar import MAX_STEPS, polar_unitary_twin

        n = int(self.count)
        rows = []
        for k, buf in self.buf.items():
            for O in buf[:min(n, K6_CAPPED)]:
                if not bool(O.abs().sum() > 0):
                    continue
                s = torch.linalg.svdvals(O)
                ratio = float(s[-1] / s[0])
                eye = torch.eye(k, dtype=O.dtype, device=O.device)
                twin_keeps = not torch.equal(polar_unitary_twin(O), eye)
                info = torch.zeros(5, dtype=torch.int32, device=O.device)
                self.orig(O, info, MAX_STEPS)
                steps, kept = int(info[0]), bool(info[2])
                rows.append(dict(k=k, ratio=ratio, twin_keeps_w=twin_keeps, steps=steps,
                                 kernel_keeps_w=kept))
                print(f"  K6 {label}: an overlap (k={k}) whose W the kernel dropped: "
                      f"sigma_min/sigma_max {ratio:.3e}, the twin "
                      f"{'keeps W' if twin_keeps else 'gives I'}; again on the card: {steps} "
                      f"steps, W {'kept' if kept else 'dropped'}")
        print(f"  K6 {label}: {n} calls dropped W ({len(rows)} overlaps kept for the check)")
        bad = [r for r in rows if r["ratio"] >= 1e-10 and r["twin_keeps_w"] and
               not r["kernel_keeps_w"]]
        check(not bad, f"K6 {label}: the kernel keeps W wherever the twin does at "
                       f"sigma_min/sigma_max >= 1e-10 ({len(bad)} overlaps where it does not)")
        return rows


K6_DROPPED: dict = {}  # K6Capture.report per run, for the JSON record


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
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, numpy {np.__version__}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  TF32 disabled for matmul and cuDNN (torch.backends.*.allow_tf32 = False)")
    print(f"  host: {os.cpu_count()} CPUs; {host_probe():.3f} s for a fixed numpy and Python "
          "workload like the abelian host planning (sorts, unique, tuple keys): the host-bound "
          "phases 8-10 scale with it across machines")
    return smi


def host_probe() -> float:
    """Seconds of a fixed host workload of the kind the abelian plans are
    built from (the best of three)."""
    rng = np.random.RandomState(0)
    x = rng.randint(0, 1 << 20, size=(1 << 17, 3))
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        np.unique(x, axis=0)
        np.lexsort(x.T)
        {tuple(r): i for i, r in enumerate(x[:1 << 15].tolist())}
        best = min(best, time.perf_counter() - t0)
    return best


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
    rec.setdefault(name, {}).update({
        "max_abs_err": err, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cuda_ms(lib) if lib is not None else None})
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


def fused_checks(a, tol, tag, gen, dev) -> dict:
    """K1's fused double layer and K2's corner apply against their twins on
    seeded random operands at the shapes the path can give them: K1 into the
    move's layout (M2's and Z's rows padded to an even pitch: bulk stores)
    at chi = chi + 8 and 169, and into Z[d,e,f,r,g,p] (i the unit-stride
    axis: stores element by element) with chi_n != chi (chi + 8) and at
    169, X unpadded (8-byte copies), slice_phys both ways; K2 at n = chi D^2 for chi = 147, 155 and 169 with
    m = chi, chi + 8 and 177 (two column tiles), on M2 with an even pitch and
    with the unpadded odd one (its 8-byte copies), and at n = 1000, m = 33;
    each <= ``tol`` relative and two calls bit-identical.  Returns the
    kernels' times (CUDA events) at the corner's and the K2 shapes."""
    from tpeps_torch.kernels import corner, layer

    dtype, D_ = a.dtype, a.shape[1]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
    out_ms = {}
    for chi, chi_n, site in ((CHI + 8, CHI + 8, "padded rows"), (EIGH_BIG, EIGH_BIG, "padded rows"),
                             (CHI, CHI + 8, "i contiguous"), (EIGH_BIG, EIGH_BIG, "i contiguous")):
        X6 = rnd(D_, D_, chi, D_, D_, chi_n)
        if site == "padded rows":
            n = chi * D_ * D_
            out = torch.empty((n, n + n % 2), dtype=dtype, device=dev)[:, :n].view(
                chi, D_, D_, chi_n, D_, D_).permute(2, 5, 1, 4, 0, 3)
        else:
            out = torch.empty((chi, D_, D_, D_, D_, chi_n), dtype=dtype,
                              device=dev).permute(2, 4, 1, 3, 0, 5)
        ref = layer.double_layer_twin(a, X6, torch.empty(out.shape, dtype=dtype, device=dev))
        for sp in (False, True):
            o1 = layer.double_layer(a, X6, out, slice_phys=sp).clone()
            o2 = layer.double_layer(a, X6, out, slice_phys=sp)
            e = rel_err(o1, ref)
            check(e <= tol and torch.equal(o1, o2),
                  f"K1 double_layer {tag}, {site} layout, chi={chi}, chi_n={chi_n}, "
                  f"slice_phys={sp}: rel err {e:.2e} <= {tol:.0e}, two calls bit-identical")
        out_ms[f"{site} chi={chi} chi_n={chi_n}"] = cuda_ms(lambda: layer.double_layer(a, X6, out))
        del X6, out, ref, o1, o2
    for chi, m, pad in ((CHI, CHI, True), (CHI, CHI, False), (CHI, CHI + 8, True),
                        (CHI + 8, CHI + 8, True), (EIGH_BIG, EIGH_BIG, True),
                        (EIGH_BIG, 177, True), (None, 33, False)):
        n = 1000 if chi is None else chi * D_ * D_
        M2 = rnd(n, n + (n % 2 if pad else 0))[:, :n]
        P = rnd(n, m)
        Y1, Y2 = corner.corner_apply(M2, P), corner.corner_apply(M2, P)
        e = rel_err(Y1, corner.corner_apply_twin(M2, P))
        pitch = f"pitch {M2.stride(0)}"
        check(e <= tol and torch.equal(Y1, Y2),
              f"K2 corner_apply {tag}, n={n}, m={m}, {pitch}: rel err {e:.2e} <= {tol:.0e}, "
              "two calls bit-identical")
        out_ms[f"corner_apply n={n} m={m} {pitch}"] = cuda_ms(lambda: corner.corner_apply(M2, P))
        if dtype == torch.float32:
            # in a CUDA graph (the float32 phases' MoveGraph captures it), and
            # timed in graphs beside torch.matmul in float32 (TF32 off): kernel,
            # matmul, matmul, kernel
            Yg, = in_graph(lambda: corner.corner_apply(M2, P))
            check(torch.equal(Yg, Y1), f"K2 corner_apply {tag}, n={n}, m={m}, {pitch}: a CUDA "
                                       "graph's replay bit-identical to the eager call")
            kern, mm = (lambda: corner.corner_apply(M2, P)), (lambda: torch.matmul(M2, P))
            ms, lib_ms = graph_ms(kern), graph_ms(mm)
            lib_ms, ms = min(lib_ms, graph_ms(mm)), min(ms, graph_ms(kern))
            K2_F32[f"n={n} m={m} {pitch}"] = {"ms": ms, "matmul_ms": lib_ms, "rel_err": e}
            print(f"  K2 corner_apply {tag} {n} x {n} by {n} x {m}, {pitch} (CUDA graphs): kernel "
                  f"{ms:.4f} ms, torch.matmul {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)")
        del M2, P, Y1, Y2
    print(f"  K1/K2 {tag} kernel times (CUDA events): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out_ms.items()))
    return out_ms


K2_F32: dict = {}  # K2's float32 times in CUDA graphs by shape (fused_checks)


def split_stress(n, m, gen, dev):
    """float32 operands for K2's TF32 hi/lo split: M2 (pitch n + 1) with
    entries of both signs whose exponents span 2^-30 .. 2^30 in every row,
    exact zeros, a zero row, a row of subnormals and subnormals sprinkled
    in, a NaN (row n / 10), +inf and -inf (row n / 5); P with exponents
    over 2^-10 .. 2^10, exact zeros in the row that meets the +inf and an
    inf (column m / 3)."""
    f = lambda *shape: torch.rand(*shape, generator=gen, device=dev, dtype=torch.float32)
    e = lambda lo, hi, shape: torch.exp2(torch.randint(lo, hi + 1, shape, generator=gen,
                                                       device=dev).float())
    buf = torch.empty((n, n + 1), dtype=torch.float32, device=dev)
    M2 = buf[:, :n]
    M2.copy_((0.5 + 0.5 * f(n, n)) * e(-30, 30, (n, n)))
    M2.copy_(torch.where(f(n, n) < 0.5, -M2, M2))
    M2.copy_(torch.where(f(n, n) < 0.05, torch.zeros_like(M2), M2))
    sub = torch.randint(1, 1 << 20, (n, n), generator=gen, device=dev).float() * 2.0 ** -149
    M2.copy_(torch.where(f(n, n) < 0.01, sub, M2))
    M2[3] = 0.0
    M2[5] = sub[5]
    M2[n // 10, n // 3] = math.nan
    M2[n // 5, n // 2] = math.inf
    M2[n // 5, (3 * n) // 4] = -math.inf
    P = (0.5 + 0.5 * f(n, m)) * e(-10, 10, (n, m))
    P = torch.where(f(n, m) < 0.5, -P, P)
    P[n // 2, ::3] = 0.0
    P[n - 7, m // 3] = math.inf
    return M2, P.contiguous()


def k2_split_checks(gen, dev) -> dict:
    """K2's float32 kernel on :func:`split_stress`'s operands at n = 7203
    (split-K) and 1000, m = 147 and 33: NaN and inf where the twin has them
    (the same signs), the finite entries within 1e-5 of the twin relative to
    its largest, and each row whose largest |Y| is a normal float within
    1e-5 relative to that; two calls bit-identical.  Then at m = 193-400
    (two or three column tiles) on random operands: within 1e-5 of the
    twin, two calls bit-identical."""
    from tpeps_torch.kernels import corner

    out = {}
    for n, m in ((CHI * D * D, CHI), (1000, 33)):
        M2, P = split_stress(n, m, gen, dev)
        Y1, Y2, Yt = corner.corner_apply(M2, P), corner.corner_apply(M2, P), \
            corner.corner_apply_twin(M2, P)
        fin = torch.isfinite(Yt)
        same_special = (torch.equal(torch.isnan(Y1), torch.isnan(Yt))
                        and torch.equal(torch.isinf(Y1), torch.isinf(Yt))
                        and torch.equal(Y1[torch.isinf(Yt)], Yt[torch.isinf(Yt)]))
        d = torch.where(fin, (Y1 - Yt).abs(), torch.zeros_like(Yt)).double()
        ref = torch.where(fin, Yt.abs(), torch.zeros_like(Yt)).double()
        e_all = float(d.max() / ref.max())
        rmax = ref.max(dim=1).values
        rows = rmax >= 2.0 ** -100
        e_row = float((d.max(dim=1).values[rows] / rmax[rows]).max())
        n_nan, n_inf = int(torch.isnan(Yt).sum()), int(torch.isinf(Yt).sum())
        check(same_special and e_all <= TOL[torch.float32] and e_row <= TOL[torch.float32]
              and same_float(Y1, Y2),
              f"K2 corner_apply float32 on split-stress operands (exponents 2^-30..2^30, zeros, "
              f"subnormals, NaN, +-inf), n={n}, m={m}: NaN ({n_nan}) and inf ({n_inf}) where the "
              f"twin has them; finite rel err {e_all:.2e}, by normal row {e_row:.2e} <= 1e-5; "
              "two calls bit-identical")
        out[f"n={n} m={m}"] = {"rel_err": e_all, "row_rel_err": e_row, "nan": n_nan, "inf": n_inf}
        del M2, P, Y1, Y2, Yt, d, ref
    # m wider than one 192-column tile: several column tiles (and, at n =
    # 7203, split-K across them), random operands, even and odd pitches
    for n, m, pad in ((1000, 200, False), (333, 193, False), (1000, 400, True),
                      (CHI * D * D, 250, True)):
        M2 = torch.randn(n, n + (n % 2 if pad else 0), generator=gen, device=dev)[:, :n]
        P = torch.randn(n, m, generator=gen, device=dev)
        Y1, Y2 = corner.corner_apply(M2, P), corner.corner_apply(M2, P)
        e = rel_err(Y1, corner.corner_apply_twin(M2, P))
        check(e <= TOL[torch.float32] and same_float(Y1, Y2),
              f"K2 corner_apply float32, n={n}, m={m} ({-(-m // 192)} column tiles), pitch "
              f"{M2.stride(0)}: rel err {e:.2e} <= 1e-5, two calls bit-identical")
        out[f"n={n} m={m} pitch {M2.stride(0)}"] = {"rel_err": e}
        del M2, P, Y1, Y2
    return out


def exact_polar(O):
    """``U V^T`` from an SVD of ``O`` in float64: the polar factor to about
    eps cond(O)."""
    U, _, Vh = torch.linalg.svd(O.double())
    return U @ Vh


def polar_checks(overlaps, dtype, gen, dev) -> dict:
    """K6 in ``dtype`` (the overlaps built in float64, rounded): on the
    overlaps of moves 1, 4 and 31 of the D=7 path and a random
    well-conditioned one, against the twin (``TOL``; on move 1 only where the
    two guards agree), two calls bit-identical; in float64 on graded
    overlaps ``U diag(s) V^T`` (QR of seeded matrices, sigma_min/sigma_max
    from 1e-2 to 1e-9) at k = chi, chi + 8 and 169, against the exact ``U
    V^T`` within ``1e-13 sigma_max/sigma_min`` (the twin's error, ~eps
    cond^2, printed beside it) and at k = 192 against the twin; on an
    exactly singular and a ridged singular overlap (W = I, as the twin);
    capped one step short of convergence (W = I); k = 193 refused; and
    ``polar_vjp`` against its twin at k = chi and 169.  In float64, each
    overlap's steps and its time in CUDA graphs."""
    from tpeps_torch.kernels import polar

    tol, tag = TOL[dtype], str(dtype).replace("torch.", "")
    info = torch.zeros(5, dtype=torch.int32, device=dev)
    eye = lambda k: torch.eye(k, dtype=dtype, device=dev)
    rnd_q = lambda k: torch.linalg.qr(torch.randn(k, k, generator=gen, device=dev,
                                                  dtype=torch.float64)).Q
    out = {"steps": {}, "graph_ms": {}}
    for label, O64 in overlaps.items():
        O = O64.to(dtype).contiguous()
        W1 = polar.polar_unitary(O, info=info)
        steps, conv, kept, finite, near = info.tolist()
        W2, Wt = polar.polar_unitary(O), polar.polar_unitary_twin(O)
        twin_kept = not torch.equal(Wt, eye(CHI))
        sv = torch.linalg.svdvals(O64)
        e, e_x = rel_err(W1, Wt), rel_err(W1.double(), exact_polar(O.double()))
        what = (f"K6 polar_unitary {tag}, O of {label} (sigma_min/sigma_max "
                f"{float(sv[-1] / sv[0]):.2e}; {steps} steps, converged {conv}, finite {finite}, "
                f"||O^T O - I||_F < 0.9: {near}; W kept: kernel {kept}, twin {int(twin_kept)})")
        if label == "move 1" and bool(kept) != twin_kept:
            print(f"  [note] {what}: the guards decided differently")
        else:
            check(bool(kept) == twin_kept and e <= tol and torch.equal(W1, W2),
                  f"{what}: rel err against the twin {e:.2e} <= {tol:.0e} (against U V^T "
                  f"{e_x:.2e}), two calls bit-identical")
        if dtype == torch.float64:
            out["steps"][label] = steps
            out["graph_ms"][label] = graph_ms(lambda: polar.polar_unitary(O), 10, 3)
    O4 = overlaps["move 4"].to(dtype).contiguous()
    polar.polar_unitary(O4, info=info)
    short = max(int(info[0]) - 1, 1)
    W = polar.polar_unitary(O4, info=info, max_steps=short)
    check(not int(info[1]) and torch.equal(W, eye(CHI)),
          f"K6 polar_unitary {tag}, move 4's O capped at {short} steps: not converged "
          f"(converged={int(info[1])}), W = I")
    # an orthogonal block beside three null directions (exact in O^T O, so
    # the twin's eigh sees w_min <= 1e-24 w_max), and the same ridged
    Q = torch.zeros(CHI, CHI, dtype=torch.float64, device=dev)
    Q[:-3, :-3] = rnd_q(CHI - 3)
    for label, O in (("exactly singular", Q), ("ridged singular", Q + 1e-12 * torch.eye(
            CHI, dtype=torch.float64, device=dev))):
        O = O.to(dtype).contiguous()
        W = polar.polar_unitary(O, info=info)
        check(torch.equal(W, eye(CHI)) and torch.equal(polar.polar_unitary_twin(O), eye(CHI)),
              f"K6 polar_unitary {tag}, {label} O: W = I ({int(info[0])} steps, converged "
              f"{int(info[1])}), the twin's too")
    if dtype == torch.float64:
        for k in (CHI, CHI + 8, EIGH_BIG):
            for cond in K6_GRADED:
                U, V = rnd_q(k), rnd_q(k)
                s_ = torch.logspace(0, -math.log10(cond), k, dtype=torch.float64, device=dev)
                O = ((U * s_) @ V.mT).contiguous()
                X = U @ V.mT
                W = polar.polar_unitary(O, info=info)
                e_k, e_t = rel_err(W, X), rel_err(polar.polar_unitary_twin(O), X)
                check(e_k <= 1e-13 * cond,
                      f"K6 polar_unitary {tag}, graded U diag(s) V^T, k={k}, sigma_max/sigma_min "
                      f"{cond:.0e} ({int(info[0])} steps): rel err against U V^T {e_k:.2e} <= "
                      f"{1e-13 * cond:.0e} (the twin's {e_t:.2e})")
        # near the guard's edge: sigma_max/sigma_min 3e9 at k = chi
        U, V = rnd_q(CHI), rnd_q(CHI)
        s_ = torch.logspace(0, -math.log10(3e9), CHI, dtype=torch.float64, device=dev)
        O_edge = ((U * s_) @ V.mT).contiguous()
        polar.polar_unitary(O_edge, info=info)
        out["steps"]["graded, sigma_max/sigma_min 3e9"] = int(info[0])
        out["graph_ms"]["graded, sigma_max/sigma_min 3e9"] = graph_ms(
            lambda: polar.polar_unitary(O_edge), 10, 3)
        O = well_conditioned(K6_MAX_K, gen, dtype, dev)
        W = polar.polar_unitary(O, info=info)
        e = rel_err(W, polar.polar_unitary_twin(O))
        check(e <= tol, f"K6 polar_unitary {tag}, random well-conditioned k={K6_MAX_K} (a cluster "
                        f"of {K6_MAX_K // 16}, {int(info[0])} steps): rel err {e:.2e} <= {tol:.0e}")
        try:
            polar.polar_unitary(well_conditioned(K6_MAX_K + 1, gen, dtype, dev))
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        check(str(K6_MAX_K) in refused, f"K6 polar_unitary at k={K6_MAX_K + 1} refused: {refused!r}")
    for k in (CHI, EIGH_BIG):
        W = polar.polar_unitary(well_conditioned(k, gen, dtype, dev))
        Wb = torch.randn(k, k, generator=gen, device=dev, dtype=dtype)
        O1, O2 = polar.polar_vjp(W, Wb), polar.polar_vjp(W, Wb)
        e = rel_err(O1, polar.polar_vjp_twin(W, Wb))
        check(e <= tol and torch.equal(O1, O2),
              f"K6 polar_vjp {tag} k={k}: rel err {e:.2e} <= {tol:.0e}, two calls bit-identical")
        if k == CHI:
            out["graph_ms"][f"polar_vjp {tag}"] = graph_ms(lambda: polar.polar_vjp(W, Wb))
            out["graph_ms"][f"polar_vjp twin {tag}"] = graph_ms(
                lambda: polar.polar_vjp_twin(W, Wb))
    if out["graph_ms"]:
        print(f"  K6 {tag} in CUDA graphs: " + ", ".join(
            f"{lbl} {ms * 1000:.1f} us" for lbl, ms in out["graph_ms"].items()))
    return out if dtype == torch.float64 else {}


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
                overlaps = {"move 1": near_unitary_overlap(a, env.C, T_int, n_moves=0),
                            "move 4": near_unitary_overlap(a, env.C, T_int),
                            "move 31": near_unitary_overlap(a, env.C, T_int, n_moves=30),
                            "random well-conditioned": well_conditioned(CHI, gen, dtype, dev)}
            k6 = polar_checks(overlaps, dtype, gen, dev)
            rec.setdefault("double_layer", {})[f"checks_{tag}"] = fused_checks(a, tol, tag,
                                                                              gen, dev)
            if dtype != torch.float64:
                continue
            # per-kernel timing (f64, the slice's dtype), max abs error, the
            # bound and, where one torch call computes the same function, its
            # time; double_layer at the corner's shapes and in the move's
            # layouts (X's i axis and M2's rows padded), its library call one
            # einsum of both layers
            cp = mf._row_pitch(CHI)
            Tt = torch.nn.functional.pad(T_int.permute(3, 0, 1, 2), (0, cp - CHI))
            q1 = (T_int.permute(0, 1, 3, 2).reshape(D * D * CHI, CHI)
                  @ (env.C @ Tt.reshape(CHI, D * D * cp)))
            X6 = q1.view(D, D, CHI, D, D, cp)[..., :CHI]
            nn_ = CHI * D * D
            M2b = torch.empty((nn_, nn_ + nn_ % 2), dtype=dtype, device=dev)[:, :nn_]
            out6 = M2b.view(CHI, D, D, CHI, D, D).permute(2, 5, 1, 4, 0, 3)
            del Tt

            nT_raw = mf._absorb_T_int(a, T_int, P, CHI, CHI)
            n, k = Pm.shape
            # K6 is timed eagerly on the overlap of move 31 (the late moves) and
            # in CUDA graphs on every overlap (polar_checks).  Its bound is the
            # function's: the symmetric Gram O^T O (k^3), the symmetric V f(w)
            # V^T (k^3) and O times it (2 k^3), whatever the method
            O_late = overlaps["move 31"]
            W = polar.polar_unitary(overlaps["move 4"])
            Wb = torch.randn(CHI, CHI, generator=gen, device=dev, dtype=dtype)
            cols = D * D * CHI * CHI  # the free (e,r,j,i) / (m,j,v,i) axes of a layer
            cases = {  # name: (kernel, twin, library call or None, bytes, flops, peak)
                "double_layer": (lambda: layer.double_layer(a, X6, out6),
                                 lambda: layer.double_layer_twin(a, X6, out6),
                                 lambda: torch.einsum("suler,svmfg,lmjuvi->jefirg", a, a, X6),
                                 nbytes(a, X6, M2b), 2 * 2 * (2 * D * D) * D * D * cols, FP64_TC),
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
            rec["polar_unitary"].update(k6)
            del M2b, q1, X6
    for name, shapes in gram_shapes.items():
        rec[name]["shapes"] = shapes
    rec["t_epilogue"].update(epilogue_checks(torch.Generator(device=dev).manual_seed(4), dev))
    # K2's float32 kernel: its graph times by shape (fused_checks), its bound
    # at the move's shape (3xTF32: three products at the TF32 tensor-core
    # peak; on the CUDA cores one at the FP32 peak) and the split's stress
    n = CHI * D * D
    nb = 4 * (n * n + 2 * n * CHI)
    b_ms, b_by = bound(nb, 3 * 2 * n * n * CHI, TF32_TC)
    rec["corner_apply"]["f32"] = {
        "route": "3xTF32, wgmma m64n32k8 (split_p_kernel + corner_tf32_kernel)", "shapes_graph_ms": dict(K2_F32),
        "bound_ms": b_ms, "bound_by": b_by,
        "fp32_cuda_core_bound_ms": bound(nb, 2 * n * n * CHI, FP32_CC)[0],
        "split_stress": k2_split_checks(torch.Generator(device=dev).manual_seed(15), dev)}
    print(f"  K2 float32 bound at {n} x {n} by {n} x {CHI}: {b_ms:.4f} ms ({b_by}; three TF32 "
          f"products at 495 TFLOP/s), {rec['corner_apply']['f32']['fp32_cuda_core_bound_ms']:.4f}"
          " ms for one FP32 product on the CUDA cores at 67 TFLOP/s")
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
    k6_steps_reset(dev)
    t0 = time.perf_counter()
    env, n_iter, dist, _ = mf.run_ctmrg(a, env0, max_iter=MAX_ITER, conv_tol=CONV_TOL,
                                        n_power=N_POWER, timers=timers)
    torch.cuda.synchronize()
    t_ctm = time.perf_counter() - t0
    counts = launch_counts()
    k6_steps_read(dev, "forward slice")
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
    return counts, a, env


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
    from tpeps_torch.linalg import power as t_power
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
        k6_steps_reset(dev)
        capture = K6Capture(dev)
        t0 = time.perf_counter()
        with mock.patch.object(t_power, "polar_unitary_kernel", capture):
            e_fin, _, _, hist = optimize_c4v(cfg, model, energy, A0, grad_stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        k6_steps_read(dev, "training slice")
        if dev.type == "cuda":
            K6_DROPPED["training slice"] = capture.report("training slice")
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
    twin_ms = cuda_ms(lambda: ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7), reps=2)
    bound_ms, bound_by = bound(nbytes(Ap, Bp, ea, eb, Y), s * (s + 1) // 2 * 2 * m * n * k, INT8_TC)
    fp64_ms, fp64_by = bound(nbytes(A, B, Y), 2 * m * n * k, FP64_TC)
    print(f"  ozaki_gemm {m} x {k} by {k} x {n}: kernel {ms:.3f} ms, twin {twin_ms:.3f} ms, "
          f"FP64 torch.matmul {lib_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; the FP64 "
          f"product's {fp64_ms:.4f} ms, {fp64_by})")
    return {"shape": [m, k, n], "kp": Ap.shape[2], "slices": s, "ms": ms, "twin_ms": twin_ms,
            "fp64_matmul_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "fp64_bound_ms": fp64_ms}


def same_float(x, y) -> bool:
    """Bit for bit alike, NaN where NaN (its payload aside)."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x.masked_fill(nx, 0.0), y.masked_fill(ny, 0.0))


def in_graph(fn):
    """``fn()``'s outputs from one replay of a CUDA graph that captured it
    (after one eager call), cloned."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    out = tuple(t.clone() for t in (out if isinstance(out, tuple) else (out,)))
    del g
    return out


def mixed_exponents(shape, gen, dev):
    """float64 entries of both signs whose exponents run over 2^-60 .. 2^60,
    with exact powers of two, zeros, -0.0 and subnormals sprinkled in."""
    u = lambda: torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
    x = (0.5 + 0.5 * u()) * torch.exp2(torch.randint(-60, 61, shape, generator=gen, device=dev)
                                      .double())
    x = torch.where(u() < 0.5, -x, x)
    x = torch.where(u() < 0.05, torch.exp2(torch.randint(-40, 41, shape, generator=gen, device=dev)
                                           .double()), x)
    x = torch.where(u() < 0.05, torch.full_like(x, 5e-324) * torch.randint(
        1, 1000, shape, generator=gen, device=dev).double(), x)
    x = torch.where(u() < 0.05, torch.zeros_like(x), x)
    return torch.where(u() < 0.05, torch.full_like(x, -0.0), x)


def split_case(label, X, axis, s=8, w=7, graph=False) -> tuple:
    """``ozaki_split`` against its twin (planes with their padding, and e),
    two calls bit-identical, and in a CUDA graph where ``graph``."""
    from tpeps_torch.kernels import ozaki

    X = X.contiguous()
    P1, e1 = ozaki.ozaki_split(X, s, w, axis)
    P2, e2 = ozaki.ozaki_split(X, s, w, axis)
    Pt, et = ozaki.ozaki_split_twin(X, s, w, axis)
    ok = torch.equal(P1, Pt) and same_float(e1, et) and torch.equal(P1, P2) and same_float(e1, e2)
    if graph:
        Pg, eg = in_graph(lambda: ozaki.ozaki_split(X, s, w, axis))
        ok = ok and torch.equal(Pg, Pt) and same_float(eg, et)
    check(ok, f"ozaki_split {label} {tuple(X.shape)} axis={axis} s={s} w={w}: planes (padding "
              f"included) and e bit-identical to the twin, two calls bit-identical"
              + (", and in a CUDA graph" if graph else ""))
    return P1, e1


# the split shapes of the Ozaki move (slice_phys, as run_ctmrg_mixed's
# float64 phase runs it): label -> (axis, rows, k, launches per Ozaki move)
SPLIT_SHAPES = {"M2 rows": (1, CHI * D * D, CHI * D * D, 1),
                "P^T rows": (1, CHI, CHI * D * D, 1),
                "T rows": (1, CHI * D * D, CHI, 2),
                "C rows": (1, CHI, CHI, 1),
                "layer A rows": (1, D * D, D * D, 8),
                "C T, T P columns": (0, CHI * D * D, CHI, 3),
                "layer B columns": (0, D * D * CHI * CHI, D * D, 8),
                "P columns": (0, CHI, CHI * D * D, 3),
                "Z columns": (0, CHI * D * D, CHI * D * D, 1)}
# the targets of the three large splits (ms in CUDA graphs)
SPLIT_TARGET_MS = {"M2 rows": 0.35, "layer B columns": 0.40, "Z columns": 0.35}


def split_bound(axis, rows, k, s=8):
    """The split's least time: X read once, its planes and e written once."""
    return bound(8 * rows * k + s * rows * -(-k // 32) * 32 + 8 * rows, 0, FP64_CC)


def split_checks(ops, gen, dev) -> dict:
    """``ozaki_split`` bit-identical to its twin at every split shape of the
    Ozaki move (real operands of the D=7 path: ``ops[label]``), eagerly and
    in a CUDA graph, each timed in graphs beside its bound; then odd k and k
    < 32, s = 8, 6, 2 and w = 5 (the table-driven instance), a zero row, rows
    of subnormals (max below 2^-1024, and in [2^-1024, 2^-1022)), k past one
    block's staging (rows and columns read twice, columns in clusters of
    more than 8), a row with an infinity and a row with a NaN, whose e is the
    twin's and whose row of the product is non-finite."""
    from tpeps_torch.kernels import ozaki

    shapes = {}
    for label, (axis, rows, k, per_move) in SPLIT_SHAPES.items():
        X = ops[label].contiguous()
        check(tuple(X.shape) == ((rows, k) if axis == 1 else (k, rows)),
              f"split operand {label}: shape {tuple(X.shape)}")
        split_case(label, X, axis, graph=True)
        ms = graph_ms(lambda: ozaki.ozaki_split(X, 8, 7, axis), reps=5, replays=4)
        twin_ms = cuda_ms(lambda: ozaki.ozaki_split_twin(X, 8, 7, axis), reps=2)
        bound_ms, _ = split_bound(axis, rows, k)
        shapes[label] = {"axis": axis, "rows": rows, "k": k, "graph_ms": ms, "twin_ms": twin_ms,
                         "bound_ms": bound_ms, "launches_per_ozaki_move": per_move}
        target = SPLIT_TARGET_MS.get(label)
        print(f"  ozaki_split {label} (rows {rows}, k {k}): {ms:.4f} ms in CUDA graphs (twin "
              f"{twin_ms:.4f} ms eager), bound {bound_ms:.4f} ms"
              + (f", target <= {target} ms" if target else ""), flush=True)
        del X
    for m, k in ((5, 1), (7, 31), (6, 33), (9, 147), (4, 7203)):
        X = mixed_exponents((m, k), gen, dev)
        X[1] = 0.0
        X[2] = torch.linspace(1.0, 1000.0, k, device=dev, dtype=torch.float64) * 5e-324  # < 2^-1064
        X[3] = torch.linspace(0.5, 1.0, k, device=dev, dtype=torch.float64) * 2.0**-1022  # subnormal
        for s, w in ((8, 7), (6, 7), (2, 7), (8, 5)):
            split_case(f"mixed exponents, odd k", X, 1, s, w, graph=(s, w) == (8, 5))
            split_case(f"mixed exponents, odd k", X.mT.contiguous(), 0, s, w, graph=(s, w) == (8, 5))
    # k past one block's staging: rows read twice (k = 30000), columns in
    # clusters of more than 8 (k = 8281, chi = 169's Z) and read twice
    for label, shape, axis in (("rows read twice", (3, 30000), 1),
                               ("columns in clusters of 9", (8281, 20), 0),
                               ("columns read twice", (20000, 5), 0)):
        X = mixed_exponents(shape, gen, dev)
        for s, w in ((8, 7), (6, 5)):
            split_case(label, X, axis, s, w)
    # a NaN row and an infinite row: e as the twin's, the planes zero, and
    # the product's rows non-finite
    A = mixed_exponents((6, 147), gen, dev)
    A[2, 5] = float("nan")
    A[4, 0] = float("inf")
    B = torch.randn(147, 9, generator=gen, device=dev, dtype=torch.float64)
    for s, w in ((8, 7), (8, 5)):
        Ap, ea = split_case("with a NaN and an infinity", A, 1, s, w)
        split_case("with a NaN and an infinity", A.mT.contiguous(), 0, s, w)
        Bp, eb = ozaki.ozaki_split(B, s, w, 0)
        C = ozaki.ozaki_gemm(Ap, ea, Bp, eb, w)
        fin = torch.isfinite(C)
        check(not fin[2].any() and not fin[4].any() and bool(fin[[0, 1, 3, 5]].all())
              and same_float(C, ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, w)),
              f"ozaki_gemm s={s} w={w} after a split with a NaN row and an infinite row: those "
              "rows non-finite, the others finite, bit-identical to the twin")
    return shapes


def epilogue_checks(gen, dev) -> dict:
    """``t_epilogue`` against its twin at m = 147, 155, 169 and 17 (below
    one tile), batch 1 and 49, and at m = 200 (more tile pairs than the grid
    keeps in registers: the second pass over ``out``), f64 and f32, both
    normalisations: the max
    bit-identical ("inf"), the 2-norm within TOL relative; two calls and a
    CUDA graph's replay bit-identical to the eager call.  Returns the
    move-shape times in CUDA graphs beside the twin's."""
    from tpeps_torch.kernels import epilogue

    times = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).replace("torch.", "")
        for m in (CHI, CHI + 8, EIGH_BIG, 17, 200):
            for batch in (1, D * D):
                x = torch.randn(batch, m, m, generator=gen, device=dev, dtype=dtype)
                x = x.view(*((D, D) if batch > 1 else (1,)), m, m)
                for norm in ("inf", "fro"):
                    y1 = epilogue.t_epilogue(x, norm)
                    y2 = epilogue.t_epilogue(x, norm)
                    (yg,) = in_graph(lambda: epilogue.t_epilogue(x, norm))
                    yt = epilogue.t_epilogue_twin(x, norm)
                    e = 0.0 if torch.equal(y1, yt) else rel_err(y1, yt)
                    ok = e == 0.0 if norm == "inf" else e <= TOL[dtype]
                    check(ok and torch.equal(y1, y2) and torch.equal(y1, yg),
                          f"t_epilogue {tag} m={m} batch={batch} norm={norm}: rel err {e:.1e} "
                          + ("(bit-identical)" if norm == "inf" else f"<= {TOL[dtype]:.0e}")
                          + ", two calls and a graph's replay bit-identical")
                    if m == CHI and batch > 1 and norm == "inf":
                        ms = graph_ms(lambda: epilogue.t_epilogue(x, norm))
                        twin_ms = graph_ms(lambda: epilogue.t_epilogue_twin(x, norm))
                        times[f"graph_ms_{tag}"], times[f"twin_graph_ms_{tag}"] = ms, twin_ms
                        print(f"  t_epilogue {tag} {tuple(x.shape)} in CUDA graphs: kernel "
                              f"{ms:.4f} ms, twin {twin_ms:.4f} ms, bound "
                              f"{bound(2 * nbytes(x), 0, FP64_CC)[0]:.4f} ms"
                              + (", target <= 0.012 ms" if dtype == torch.float64 else ""),
                              flush=True)
    return times


def offset_views(tensors, shift):
    """Copies of ``tensors`` as views ``shift`` elements into buffers of their
    own (off their 16-byte boundary for an odd shift)."""
    out = []
    for x in tensors:
        buf = torch.zeros(x.numel() + shift, dtype=x.dtype, device=x.device)
        out.append(buf[shift:].view(x.shape).copy_(x))
    return out


def commit_checks(start, move) -> dict:
    """K5 ``ctm_commit`` against its twin after one move of the D=7 path
    (``start`` = (C, T_int, P), ``move`` = (C2, T2, P2, W2, spec2)), f64 and
    f32, both convergence modes: a loop that goes on, one that reaches
    max_iter, one that ended (its state untouched), a non-finite spectrum
    (dist = inf), outputs off their 16-byte boundary by one element (the
    scalar path) and outputs and inputs both off (a scalar head, then
    vectors); the state bit-identical to the twin's, dist <= 1e-12 (f64) or
    1e-5 (f32) relative; two calls bit-identical.  Each mode and dtype timed
    eagerly and in CUDA graphs beside its bound."""
    from tpeps_torch.kernels import ctm_loop

    out = {}
    for dtype in (torch.float64, torch.float32):
        tol, sfx = TOL[dtype], "f64" if dtype == torch.float64 else "f32"
        C0, T0, P0 = (x.to(dtype) for x in start)
        C2, T2, P2, W2, spec2 = (x.to(dtype).contiguous() for x in move)
        bad = spec2.clone()
        bad[3] = math.nan
        badT = T2.clone()
        badT.view(-1)[5] = math.nan
        for conv_on in ("spec", "env"):
            moved = (C2, T2, P2, W2, spec2)
            # a NaN where this mode's dist reads: the spectrum, or T
            nonfinite = (C2, T2, P2, W2, bad) if conv_on == "spec" else (C2, badT, P2, W2, spec2)
            cases = [("goes on", MAX_ITER, 0, moved, None), ("reaches max_iter", 1, 0, moved, None),
                     ("ended", MAX_ITER, 1, moved, None),
                     ("non-finite dist", MAX_ITER, 0, nonfinite, None),
                     ("outputs off by one", MAX_ITER, 0, moved, "out"),
                     ("outputs and inputs off by one", MAX_ITER, 0, moved, "both")]
            for label, max_iter, done, mv, off in cases:
                st_k, st_t, st_2 = (ctm_loop.loop_state(C0, T0, P0, max_iter, CONV_TOL)
                                    for _ in range(3))
                new = mv[:4]
                if off is not None:
                    st_k = st_k._replace(**dict(zip(("C", "T", "P", "W", "spec"), offset_views(
                        (st_k.C, st_k.T, st_k.P, st_k.W, st_k.spec), 1))))
                if off == "both":
                    new = tuple(offset_views(new, 1))
                for st in (st_k, st_t, st_2):
                    st.spec.copy_(spec2.abs() * 0.5)  # a previous spectrum: a finite dist
                    st.ctl[1] = done
                ctm_loop.ctm_commit(st_k, *new, mv[4], conv_on=conv_on)
                ctm_loop.ctm_commit(st_2, *new, mv[4], conv_on=conv_on)
                ctm_loop.ctm_commit_twin(st_t, *mv, conv_on)
                same = all(same_float(x, y) for x, y in zip(st_k[:5], st_t[:5]))
                same &= torch.equal(st_k.ctl[:2], st_t.ctl[:2])
                twice = all(same_float(x, y) for x, y in zip(st_k[:7], st_2[:7]))
                twice &= torch.equal(st_k.ctl, st_2.ctl)
                inf = math.isinf(float(st_t.dist))
                e = 0.0 if torch.equal(st_k.dist, st_t.dist) else rel_err(st_k.dist, st_t.dist)
                committed = same_float(st_k.T, mv[1])
                check(same and twice and e <= tol and committed != bool(done)
                      and inf == (label == "non-finite dist" or bool(done)),
                      f"ctm_commit {sfx} conv_on={conv_on}, {label}: state and (i, done) = "
                      f"{st_k.ctl[:2].tolist()} as the twin, dist {float(st_k.dist):.3e} (rel "
                      f"err {e:.1e} <= {tol:.0e}), committed={committed}; two calls "
                      "bit-identical")
            # timed on a loop that never ends (conv_tol -1: every dist is above it)
            st = ctm_loop.loop_state(C0, T0, P0, 10**9, -1.0)
            call = lambda: ctm_loop.ctm_commit(st, C2, T2, P2, W2, spec2, conv_on=conv_on)
            nb = 2 * nbytes(C2, T2, P2, W2, spec2) + (nbytes(C2, T2) if conv_on == "env" else 0)
            b_ms, _ = bound(nb, 0, FP64_CC)
            ms_e, ms_g = cuda_ms(call), graph_ms(call)
            out[f"{sfx} {conv_on}"] = {"eager_ms": ms_e, "graph_ms": ms_g, "bound_ms": b_ms}
            print(f"  ctm_commit {sfx} {conv_on}: in CUDA graphs {ms_g * 1000:.2f} us, eager "
                  f"{ms_e * 1000:.2f} us, bound {b_ms * 1000:.2f} us ({nb / 1e6:.1f} MB)")
    return {"graph_ms": out}


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
        M2 = mf._c2x2_factored(a, env.C, T_int).contiguous()
        P = torch.linalg.qr(torch.randn(CHI * D * D, CHI, generator=gen, device=dev,
                                        dtype=torch.float64)).Q.contiguous()
        n, k = P.shape
        s = 8
        Tm = T_int.permute(0, 1, 3, 2).reshape(D * D * CHI, CHI)
        ct = env.C @ T_int.permute(3, 0, 1, 2).reshape(CHI, D * D * CHI)
        q1 = Tm @ ct
        A_k = a.permute(0, 3, 4, 1, 2).reshape(2 * D * D, D * D).contiguous()
        B_l = q1.view(D, D, CHI, D, D, CHI).permute(3, 0, 1, 2, 4, 5).reshape(D * D, -1)
        B_l = B_l.contiguous()
        A_s = a[0].permute(2, 3, 0, 1).reshape(D * D, D * D).contiguous()
        A_b = a.conj().permute(3, 4, 0, 1, 2).reshape(D * D, 2 * D * D).contiguous()
        # every split shape of the Ozaki move on an operand of the D=7 path (M2
        # stands in for Z, which has its shape), then the edge cases
        split_ops = {"M2 rows": M2, "P^T rows": P.mT, "T rows": Tm, "C rows": env.C,
                     "layer A rows": A_s, "C T, T P columns": T_int.permute(3, 0, 1, 2).reshape(
                         CHI, -1), "layer B columns": B_l, "P columns": P, "Z columns": M2}
        split_shapes = split_checks(split_ops, gen, dev)
        del split_ops
        Ap, ea = ozaki.ozaki_split(M2, s, 7, 1)
        Bp, eb = ozaki.ozaki_split(P, s, 7, 0)
        time_case(rec, "ozaki_split", lambda: ozaki.ozaki_split(M2, s, 7, 1),
                  lambda: ozaki.ozaki_split_twin(M2, s, 7, 1), None,
                  nbytes(M2) + s * Ap.shape[1] * Ap.shape[2] + 8 * n, 0, FP64_CC)
        print("  ozaki_split bound: read M2 once, write its 8 digit planes")
        rec["ozaki_split"]["shapes"] = split_shapes
        Y = ozaki.ozaki_gemm(Ap, ea, Bp, eb)
        check(torch.equal(Y, ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7)),
              f"ozaki_gemm M2 P (s={s}): bit-identical to the twin; "
              f"{rel_err(Y, M2 @ P):.2e} vs the FP64 product")
        time_case(rec, "ozaki_gemm", lambda: ozaki.ozaki_gemm(Ap, ea, Bp, eb),
                  lambda: ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7), lambda: torch.matmul(M2, P),
                  nbytes(Ap, Bp, ea, eb, Y), s * (s + 1) // 2 * 2 * n * n * k, INT8_TC)
        del Ap, Bp, Y
        # every other product shape of the Ozaki move (slice_phys, as
        # run_ctmrg_mixed's float64 phase runs it) and the unsliced layers, real
        # operands of the D=7 path: bit-identical to the twin, timed against
        # FP64 torch.matmul, each with its bound
        rec["ozaki_gemm"]["shapes"] = {"M2 P": oz_shape(M2, P, s)}
        split_case("layer ket A", A_k, 1)
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

        # ctm_commit after one move, in both modes and dtypes, against the twin
        C2, T2, spec2, P2, W2 = mf.ctm_move_w(a, env.C, T_int, P, n_power=N_POWER)
        rec["ctm_commit"] = commit_checks((env.C, T_int, P), (C2, T2, P2, W2, spec2))
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


MIXED_PHASES: list = []  # phase 7(e)'s run_ctmrg_mixed phases, for the JSON record


@contextlib.contextmanager
def count_phase_launches(mf, name):
    """Within the block, every ``mf.run_ctmrg`` call (one a phase of
    ``run_ctmrg_mixed``) appends the launches of kernel ``name`` it made to
    the yielded list."""
    from tpeps_torch.kernels import LAUNCHES

    out, orig = [], mf.run_ctmrg

    def counted(*args, **kw):
        before = LAUNCHES[name]
        res = orig(*args, **kw)
        out.append(LAUNCHES[name] - before)
        return res

    with mock.patch.object(mf, "run_ctmrg", counted):
        yield out


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
    ozaki.SPLIT_LAUNCHES.clear()
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
    split_launches = dict(ozaki.SPLIT_LAUNCHES)
    print(f"  ozaki_split launches of the Ozaki move by (axis, rows, k): {split_launches}")
    expected = {(ax, rows, k): n for ax, rows, k, n in SPLIT_SHAPES.values()}
    check(split_launches == expected, f"the Ozaki move's splits are phase 2's shapes: "
                                      f"{split_launches} == {expected}")
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
    k6_steps_reset(dev)
    t0 = time.perf_counter()
    with count_phase_launches(mf, "corner_apply") as k2:
        env, n, dist = mf.run_ctmrg_mixed(a, env0, max_iter=MAX_ITER, conv_tol=CONV_TOL,
                                          slice_phys=True, moves_per_sync=MOVES_PER_SYNC,
                                          stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    k6_steps_read(dev, "large-D slice")
    peak = torch.cuda.max_memory_allocated()
    for st, n_k2 in zip(stats, k2):
        print(f"  {st['phase']}: {st['moves']} moves, dist {st['dist']:.3e}, "
              f"{1000 * st['seconds'] / max(st['moves'], 1):.2f} ms/move (host wall, capture "
              f"included), K2 corner_apply launched {n_k2} times")
    check(all(n_k2 > 0 for st, n_k2 in zip(stats, k2) if st["phase"].startswith("f32")),
          f"K2 corner_apply launched in both float32 phases: {k2[:2]}")
    MIXED_PHASES.extend({**st, "corner_apply_launches": n_k2} for st, n_k2 in zip(stats, k2))
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


def record_permutes(fn):
    """Run ``fn()`` and return its result with the (src, table, numel,
    zero_fill) of every ``block_permute`` copy it made through
    ``permute_flat`` (operand layouts, transposes, sector gathers, isometry
    scatters)."""
    from tpeps_torch.sym import frozen as sym_frozen
    from tpeps_torch.sym import tensor as ab_tensor

    calls, orig = [], ab_tensor.permute_flat

    def rec(src, table, numel, zero_fill=False):
        calls.append((src.detach(), table, numel, zero_fill))
        return orig(src, table, numel, zero_fill)

    with mock.patch.object(ab_tensor, "permute_flat", rec), \
            mock.patch.object(sym_frozen, "permute_flat", rec):
        out = fn()
    return out, calls


def _ranges(starts, lens, dev):
    """``concat(arange(s, s + n) for s, n in zip(starts, lens))`` on ``dev``."""
    starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    lens = torch.as_tensor(np.asarray(lens, np.int64), device=dev)
    total = int(lens.sum()) if len(lens) else 0
    first = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens, output_size=total)
    return (torch.repeat_interleave(starts, lens, output_size=total)
            + torch.arange(total, device=dev) - first)


def twin_plan(table, dev):
    """The twin's cached index plan of ``table`` on ``dev`` (``PermuteTable
    .element_index``, ``GemmTable.groups``: the same arrays in the same
    order), built with torch on ``dev`` rather than with numpy on the host,
    where a D=8 table's hundred million indices take seconds; returns
    ``table``.  Phase 8(a) holds it against the host's build."""
    from tpeps_torch.kernels import blocksparse

    key = str(dev)
    if isinstance(table, blocksparse.PermuteTable):
        cache = table.__dict__.setdefault("_elem", {})
        if key in cache:
            return table
        shape = table.shape.astype(np.int64)
        sizes = shape.prod(axis=1)
        blk = torch.repeat_interleave(torch.arange(table.nblk, device=dev),
                                      torch.as_tensor(sizes, device=dev),
                                      output_size=int(sizes.sum()))
        loc = _ranges(np.zeros_like(sizes), sizes, dev)
        col = lambda x, l: torch.as_tensor(np.ascontiguousarray(x[:, l]), device=dev)[blk]  # noqa
        sidx = torch.as_tensor(table.soff, device=dev)[blk]
        didx = torch.as_tensor(table.doff, device=dev)[blk]
        for l in range(table.rank - 1, -1, -1):
            n = col(shape, l)
            i = loc % n
            loc = loc // n
            sidx = sidx + i * col(table.sstr, l)
            didx = didx + i * col(table.dstr, l)
        sc = None if table.scale is None else torch.as_tensor(table.scale, device=dev)[blk]
        cache[key] = (sidx, didx, sc)
        return table
    cache = table.__dict__.setdefault("_groups", {})
    if key in cache:
        return table
    o_of_p = np.repeat(np.arange(table.nout), np.diff(table.ob_ptr))
    m = table.ob_m.astype(np.int64)[o_of_p]
    n = table.ob_n.astype(np.int64)[o_of_p]
    k = table.pr_k.astype(np.int64)
    shapes = np.stack([m, k, n], axis=1) if len(k) else np.zeros((0, 3), np.int64)
    uniq, inv = (np.unique(shapes, axis=0, return_inverse=True) if len(k)
                 else (shapes, np.zeros(0, np.int64)))
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind="stable")  # the pairs group after group, each in order
    cnt = np.bincount(inv, minlength=len(uniq))
    groups, a0, b0, p0 = [], 0, 0, 0
    for (mm, kk, nn), c in zip(uniq.tolist(), cnt.tolist()):
        sg = table.pr_s[order[p0:p0 + c]]
        groups.append((a0, c * mm * kk, b0, c * kk * nn, None if (sg > 0).all() else
                       torch.as_tensor(sg.astype(np.float64), device=dev), mm, kk, nn))
        a0, b0, p0 = a0 + c * mm * kk, b0 + c * kk * nn, p0 + c
    mn = table.ob_m.astype(np.int64) * table.ob_n
    cache[key] = (_ranges(table.pr_a[order], (m * k)[order], dev),
                  _ranges(table.pr_b[order], (k * n)[order], dev),
                  _ranges(table.ob_off[o_of_p][order], (m * n)[order], dev), groups,
                  _ranges(table.ob_off, mn, dev))
    return table


def twin_plan_agrees(table, dev) -> bool:
    """:func:`twin_plan`'s arrays against the host's build of the same
    plan, element for element."""
    from tpeps_torch.kernels import blocksparse

    perm = isinstance(table, blocksparse.PermuteTable)
    name = "_elem" if perm else "_groups"
    table.__dict__.pop(name, None)
    host = table.element_index(dev) if perm else table.groups(dev)
    table.__dict__.pop(name, None)
    card = twin_plan(table, dev).element_index(dev) if perm else table.groups(dev)
    same = lambda x, y: (x is None and y is None) or (  # noqa: E731
        x is not None and y is not None and torch.equal(x, y))
    if perm:
        return all(same(x, y) for x, y in zip(host, card))
    return (all(same(x, y) for x, y in zip(host[:3] + host[4:], card[:3] + card[4:]))
            and len(host[3]) == len(card[3])
            and all(x[:4] == y[:4] and x[5:] == y[5:] and same(x[4], y[4])
                    for x, y in zip(host[3], card[3])))


def permute_against_twin(src, table, numel, dev) -> bool:
    """``block_permute`` against its twin on ``table``, from the same zero
    destination: bit for bit."""
    from tpeps_torch.kernels import blocksparse

    twin_plan(table, dev)
    dk = torch.zeros(numel, dtype=src.dtype, device=dev)
    dt = torch.zeros_like(dk)
    blocksparse.block_permute(src, dk, table)
    blocksparse.block_permute_twin(src, dt, table)
    table.__dict__.pop("_elem", None)  # the twin's index arrays: GBs at D=8
    return torch.equal(dk, dt)


def gemm_against_twin(table, lhs, rhs, n_out, dev) -> tuple:
    """``(relative error to the twin, two calls bit-identical)`` of
    ``block_gemm`` on ``table``."""
    from tpeps_torch.kernels import blocksparse

    mk = lambda: torch.full((n_out,), 7.0, dtype=lhs.dtype, device=dev)  # noqa: E731
    twin_plan(table, dev)
    out_k = blocksparse.block_gemm(lhs, rhs, mk(), table)
    out_k2 = blocksparse.block_gemm(lhs, rhs, mk(), table)
    out_t = blocksparse.block_gemm_twin(lhs, rhs, mk(), table)
    table.__dict__.pop("_groups", None)  # the twin's index arrays: GBs at D=8
    return rel_err(out_k, out_t), torch.equal(out_k, out_k2)


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


def tied_raw(raw, partner, gen):
    """``raw`` with 16 transpose pairs (and 16 entries of their own) set to
    +-2 max|raw|: a largest magnitude that appears many times, bit for bit,
    after the symmetrization."""
    out = raw.clone()
    m = 2 * float(raw.abs().max())
    idx = torch.randperm(raw.numel(), generator=gen, device=raw.device)[:32]
    sign = torch.where(torch.arange(32, device=raw.device) % 2 == 0, m, -m).to(raw.dtype)
    out[idx] = sign
    has = partner[idx] >= 0
    out[partner[idx][has]] = sign[has]
    return out


def pair_partners(n, gen, dev):
    """A transpose-partner table of ``n`` entries: random pairs that partner
    each other, 64 entries their own partner (a diagonal), and the rest (one
    in eight or so) without a partner (-1: a block the move does not make)."""
    perm = torch.randperm(n, generator=gen, device=dev)
    p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    m = (n * 7 // 8) // 2 * 2
    p[perm[0:m:2]], p[perm[1:m:2]] = perm[1:m:2], perm[0:m:2]
    p[perm[m:m + 64]] = perm[m:m + 64]
    return p


# K9's and K10's partitions past their kept values: more entries than a
# resident grid keeps in registers (KEEP = 8 a thread: 540,672 on 132 SMs),
# at odd counts
WIDE_C, WIDE_T = 20001, 1000003


def frozen_commit_checks(C, T, rawC, rawT, pC, pT) -> dict:
    """K9 ``frozen_commit`` against its twin on one frozen move's raw
    outputs, on a copy whose largest magnitude ties many times, and on a
    layout of odd sizes wider than the values the grid keeps in registers
    (:data:`WIDE_C`, :data:`WIDE_T`, :func:`pair_partners`: every thread
    reads some of its elements again after the barrier), and on a copy with
    a NaN in C' (C all NaN, as the twin's max); C, T bit-exact,
    (i, done) equal, dist2 <= 1e-12 relative; a state whose loop ended left
    untouched; two calls bit-identical; timed eagerly and in CUDA graphs
    beside its bound (32 bytes an element: raw, partner index, the committed
    value read and written; the partner's raw value is an element of the same
    raw buffer), the calls alternating between the two raw buffers so that
    every call commits (a repeated input gives dist2 = 0, which ends the
    loop)."""
    from tpeps_torch.kernels import frozen as kfrozen

    dev = rawC.device
    gen = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda n: torch.randn(n, generator=gen, device=dev, dtype=C.dtype)
    raws = {"the move's raw outputs": (C, T, rawC, rawT, pC, pT),
            "max ties": (C, T, tied_raw(rawC, pC, gen), tied_raw(rawT, pT, gen), pC, pT),
            f"a wide layout ({WIDE_C} + {WIDE_T} entries)":
                (rnd(WIDE_C), rnd(WIDE_T), rnd(WIDE_C), rnd(WIDE_T),
                 pair_partners(WIDE_C, gen, dev), pair_partners(WIDE_T, gen, dev)),
            "a NaN in C'": (C, T, with_nan(rawC), rawT, pC, pT)}
    errs = []
    for label, (C0, T0, rC, rT, qC, qT) in raws.items():
        for done in (0, 1):
            sk, s2, stw = (kfrozen.frozen_state(C0, T0, AB_FROZEN_MOVES, 0.0) for _ in range(3))
            for st in (sk, s2, stw):
                st.ctl[1] = done
            kfrozen.frozen_commit(sk, rC, rT, qC, qT)
            kfrozen.frozen_commit(s2, rC, rT, qC, qT)
            kfrozen.frozen_commit_twin(stw, rC, rT, qC, qT)
            e_d = 0.0 if same_float(sk.dist2, stw.dist2) else rel_err(sk.dist2, stw.dist2)
            errs.append(max(float((x - y).nan_to_num(0.0).abs().max())
                            for x, y in ((sk.C, stw.C), (sk.T, stw.T), (sk.dist2, stw.dist2))))
            untouched = torch.equal(sk.C, C0) and torch.equal(sk.T, T0)
            check(same_float(sk.C, stw.C) and same_float(sk.T, stw.T)
                  and e_d <= TOL[torch.float64] and torch.equal(sk.ctl[:2], stw.ctl[:2])
                  and untouched == bool(done) and all(same_float(x, y) for x, y in zip(sk, s2)),
                  f"frozen_commit on {label}{', loop ended' if done else ''}: C, T bit-exact, "
                  f"(i, done) {sk.ctl[:2].tolist()}, dist2 {float(sk.dist2):.6e} rel err "
                  f"{e_d:.1e} <= 1e-12, state {'untouched' if untouched else 'committed'}; two "
                  "calls bit-identical")
    nel = C.numel() + T.numel()
    (_, _, aC, aT, _, _), (_, _, bC, bT, _, _) = list(raws.values())[:2]
    sk, stw = (kfrozen.frozen_state(C, T, 10**9, 0.0) for _ in range(2))
    turn, turn_t = (itertools.cycle(((aC, aT), (bC, bT))) for _ in range(2))
    call = lambda: kfrozen.frozen_commit(sk, *next(turn), pC, pT)
    twin = lambda: kfrozen.frozen_commit_twin(stw, *next(turn_t), pC, pT)
    b_ms, b_by = bound(8 * 4 * nel, 6 * nel, FP64_CC)
    ms_e, tw_ms = cuda_ms(call, reps=6), cuda_ms(twin, reps=6)
    tw_ms, ms_e = min(tw_ms, cuda_ms(twin, reps=6)), min(ms_e, cuda_ms(call, reps=6))
    ms_g = graph_ms(call)
    check(int(sk.ctl[1]) == 0, "frozen_commit timing: every timed call committed (the loop "
                               "did not end)")
    print(f"  frozen_commit ({nel} entries): in CUDA graphs {ms_g * 1000:.2f} us, eager "
          f"{ms_e * 1000:.2f} us, twin {tw_ms * 1000:.2f} us, bound {b_ms * 1000:.2f} us "
          f"({b_by})")
    return {"max_abs_err": max(errs), "ms": ms_e, "plain_ms": tw_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "graph_ms": ms_g}


def wide_table(gen, dev):
    """K10's table of more outputs than a launch takes (130: it is walked in
    launches of 64), of odd lengths (one of 1), wider than the values the
    grid keeps in registers, written into slots in reverse order: the
    lengths and the table."""
    from tpeps_torch.kernels import frozen_generic as kgen

    lens = [1] + (torch.randint(0, 8000, (129,), generator=gen) * 2 + 1).tolist()
    ends = np.cumsum(lens[::-1])[::-1]
    return lens, kgen.segment_table([(int(e) - n, [n]) for e, n in zip(ends, lens)], dev)


def with_nan(raw, at=None):
    """A copy of ``raw`` with one NaN (at ``at``, else a third of the way in)."""
    out = raw.clone()
    out[raw.numel() // 3 if at is None else at] = math.nan
    return out


def vjp_agrees(got, ref, sg) -> tuple:
    """An epilogue VJP's outputs against the twin's: (agrees, max abs error,
    max relative error) -- NaN where the twin is NaN, and the rest bit for bit
    with the scale detached (``sg``), else within 1e-12 (f64) or 1e-5 (f32)
    relative (the dot's summation order)."""
    err = rel = 0.0
    ok = True
    for x, y in zip(got, ref):
        ok &= torch.equal(x.isnan(), y.isnan())
        x, y = x.nan_to_num(0.0), y.nan_to_num(0.0)
        err, rel = max(err, float((x - y).abs().max())), max(rel, rel_err(x, y))
        ok &= torch.equal(x, y) if sg else rel <= TOL[x.dtype]
    return ok, err, rel


def frozen_vjp_checks(rawC, rawT, pC, pT, gC, gT, blk) -> float:
    """K9 ``frozen_epilogue_vjp`` against its twin at ``sg_norm`` False and
    True on one frozen move's raw outputs, on a copy whose largest magnitude
    ties across many layout blocks in both signs (:func:`tied_raw`), on raw
    outputs whose symmetrized entries are all equal (every entry tied) and
    on a copy with a NaN in C' (C's cotangent all NaN, T's the twin's), each
    in f64 and f32 (:func:`vjp_agrees`); two calls bit-identical, a call
    captured in a CUDA graph the eager call's bits, the barrier words left
    0.  Returns the largest abs error."""
    from tpeps_torch.kernels import barrier_counters
    from tpeps_torch.kernels import frozen as kfrozen
    from tpeps_torch.kernels.build import library

    t0, dev = time.perf_counter(), rawC.device
    gen = torch.Generator(device=dev).manual_seed(14)
    equal = lambda r, p: torch.where(p >= 0, 1.0, 2.0).to(r.dtype)  # z = 1 everywhere
    cases = {"the move's raw outputs": (rawC, rawT),
             "max ties": (tied_raw(rawC, pC, gen), tied_raw(rawT, pT, gen)),
             "all entries equal": (equal(rawC, pC), equal(rawT, pT)),
             "a NaN in C'": (with_nan(rawC), rawT)}
    bar = barrier_counters(dev, "frozen_epilogue_vjp",
                           library().cdll.tpeps_frozen_epilogue_vjp_bar_words())
    err_max = 0.0
    for label, (rC, rT) in cases.items():
        for dtype in (torch.float64, torch.float32):
            for sg in (False, True):
                args = (rC.to(dtype), rT.to(dtype), pC, pT, gC.to(dtype), gT.to(dtype), *blk, sg)
                xk = kfrozen.frozen_epilogue_vjp(*args)
                same = all(same_float(a, b) for a, b in zip(xk, kfrozen.frozen_epilogue_vjp(*args)))
                graphed = all(same_float(a, b) for a, b in zip(xk, in_graph(
                    lambda: kfrozen.frozen_epilogue_vjp(*args))))
                ok, err, rel = vjp_agrees(xk, kfrozen.frozen_epilogue_vjp_twin(*args), sg)
                nan_c = bool(xk[0].isnan().all()) and not bool(xk[1].isnan().any())
                if dtype == torch.float64:
                    err_max = max(err_max, err)
                check(ok and same and graphed and int(bar.abs().sum()) == 0
                      and (nan_c if "NaN" in label else not bool(xk[0].isnan().any())),
                      f"frozen_epilogue_vjp on {label}, {str(dtype)[6:]}, sg_norm={sg}: "
                      f"{'bit-exact' if sg else f'rel err {rel:.1e}'}, NaN where the twin's; "
                      "two calls and a graphed call bit-identical; barrier words left 0")
    print(f"  frozen_epilogue_vjp checks: {time.perf_counter() - t0:.1f} s", flush=True)
    return err_max


def generic_vjp_checks(raw, g, seg) -> float:
    """K10 ``generic_epilogue_vjp`` against its twin at ``sg_norm`` False and
    True on one frozen move's raw outputs, on a copy whose largest output's
    maximum ties at entries in many layout blocks and in both signs, on a
    copy with an output all equal (every entry tied) and on a copy with a
    NaN in one output (that output's cotangent all NaN, the others the
    twin's), in f64 and f32, and on a table of 130 outputs (more than a
    launch takes: it walks the table in launches of 64), one of them NaN
    (:func:`vjp_agrees`); two calls bit-identical, a call captured in a CUDA
    graph the eager call's bits, the barrier words left 0.  Returns the
    largest abs error."""
    from tpeps_torch.kernels import barrier_counters
    from tpeps_torch.kernels import frozen_generic as kgen
    from tpeps_torch.kernels.build import library

    t0, dev = time.perf_counter(), raw.device
    gen = torch.Generator(device="cpu").manual_seed(15)
    host = seg.host.tolist()
    q = max(range(len(host)), key=lambda i: host[i][2])  # the largest output
    so, _, n, _, _ = host[q]
    tied = raw.clone()
    at = torch.randperm(n, generator=gen)[:15]
    at = so + torch.cat([at, (at[:1] + 1) % n]).to(dev)  # and neighbours, mostly in one block
    m = 2 * float(raw[so:so + n].abs().max())
    tied[at] = torch.where(torch.arange(len(at), device=dev) % 2 == 0, m, -m).to(raw.dtype)
    flat = raw.clone()
    flat[host[0][0]:host[0][0] + host[0][2]] = 0.5
    lens, wide = wide_table(gen, dev)
    raw_w = torch.randn(wide.numel, generator=gen, dtype=torch.float64).to(dev)
    g_w = torch.randn(wide.numel, generator=gen, dtype=torch.float64).to(dev)
    k = min(1, len(host) - 1)
    cases = {"the move's raw outputs": (raw, g, seg, None),
             f"a copy whose output {q} ties in many blocks in both signs": (tied, g, seg, None),
             "a copy with output 0 all equal": (flat, g, seg, None),
             f"a copy with a NaN in output {k}":
                 (with_nan(raw, host[k][0] + host[k][2] // 2), g, seg, k),
             f"{len(lens)} outputs of odd lengths, one of them NaN":
                 (with_nan(raw_w, sum(lens[:70]) + lens[70] // 2), g_w, wide, 70)}
    bar = barrier_counters(dev, "generic_epilogue_vjp",
                           library().cdll.tpeps_generic_epilogue_vjp_bar_words())
    err_max = 0.0
    for label, (r, gg, sq, nan_out) in cases.items():
        for dtype in (torch.float64, torch.float32):
            for sg in (False, True):
                args = (r.to(dtype), gg.to(dtype), sq, sg)
                xk = kgen.generic_epilogue_vjp(*args)
                same = same_float(xk, kgen.generic_epilogue_vjp(*args))
                graphed = same_float(xk, in_graph(lambda: kgen.generic_epilogue_vjp(*args))[0])
                ok, err, rel = vjp_agrees((xk,), (kgen.generic_epilogue_vjp_twin(*args),), sg)
                nans = torch.zeros_like(xk, dtype=torch.bool)
                if nan_out is not None:
                    a, _, n_out, _, _ = sq.host[nan_out].tolist()
                    nans[a:a + n_out] = True
                if dtype == torch.float64:
                    err_max = max(err_max, err)
                check(ok and same and graphed and int(bar.abs().sum()) == 0
                      and torch.equal(xk.isnan(), nans),
                      f"generic_epilogue_vjp on {label}, {str(dtype)[6:]}, sg_norm={sg}: "
                      f"{'bit-exact' if sg else f'rel err {rel:.1e}'}, NaN in that output only; "
                      "two calls and a graphed call bit-identical; barrier words left 0")
    print(f"  generic_epilogue_vjp checks: {time.perf_counter() - t0:.1f} s", flush=True)
    return err_max


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
    (_, perms), calls = record_dots(
        lambda: record_permutes(lambda: ab_ctmrg.ctm_move_sl(a, env, AB_PK)))
    check(len(calls) == 10, f"one dynamic move made {len(calls)} tensordots (10)")
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0, bytes=0, pairs=0, groups=0)
    by_class = {}
    err_max = 0.0
    big_perm, calls_tables = None, []
    for i, (x, y, axes, out_like) in enumerate(calls):
        plan, abuf, bbuf = x.dot_operands(y, axes, out_like)
        g = twin_plan(plan.gemm, dev)
        calls_tables.append(g)
        kern = lambda: blocksparse.block_gemm(abuf, bbuf, torch.empty(plan.out.numel,
                                              dtype=abuf.dtype, device=dev), g)
        twin = lambda: blocksparse.block_gemm_twin(abuf, bbuf, torch.empty(
            plan.out.numel, dtype=abuf.dtype, device=dev), g)
        out_k, out_t = kern().clone(), twin()
        same = torch.equal(out_k, kern())
        err = rel_err(out_k, out_t)
        err_max = max(err_max, float((out_k - out_t).abs().max()))
        ms_k, ms_t = min(cuda_ms(kern), cuda_ms(kern)), cuda_ms(twin, reps=2)
        ngroups = len(g.groups(dev)[3])
        flops, elems = g.work()
        b_ms, b_by = bound(8 * elems, flops, FP64_TC)
        for key, v in (("ms", ms_k), ("plain_ms", ms_t), ("bound_ms", b_ms), ("flops", flops),
                       ("bytes", 8 * elems), ("pairs", g.npairs), ("groups", ngroups)):
            totals[key] += v
        parts = []
        for cls in np.unique(g.ob_kind):  # each class alone: its tiles in one launch
            sub = g.restricted([cls])
            ms_c = cuda_ms(lambda: blocksparse.block_gemm(
                abuf, bbuf, torch.empty(plan.out.numel, dtype=abuf.dtype, device=dev), sub), reps=3)
            fc, ec = g.work([cls])
            bc = bound(8 * ec, fc, FP64_TC)[0]
            name = blocksparse.CLASS_NAMES[cls]
            acc = by_class.setdefault(name, dict(ms=0.0, bound_ms=0.0, blocks=0, tiles=0, dots=0))
            for key, v in (("ms", ms_c), ("bound_ms", bc), ("blocks", int((g.ob_kind == cls).sum())),
                           ("tiles", sub.ntiles), ("dots", 1)):
                acc[key] += v
            parts.append(f"{name} {int((g.ob_kind == cls).sum())} blocks {ms_c:.3f} ms "
                         f"(bound {bc:.4f})")
        check(err <= TOL[torch.float64] and same,
              f"block_gemm tensordot {i + 1}: {g.npairs} pairs in {ngroups} shape groups, "
              f"{g.nout} output blocks, {g.ntiles} tiles, {flops / 1e9:.3f} GFLOP, "
              f"{8 * elems / 1e6:.1f} MB; kernel {ms_k:.3f} ms, twin {ms_t:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}); by class: {'; '.join(parts)}; rel err {err:.1e} <= "
              f"1e-12, two calls bit-identical: {same}")
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
                         "shape_groups_per_move": totals["groups"], "by_class": by_class}
    print(f"  block_gemm, the move's 10 tensordots: kernel {totals['ms']:.3f} ms, twin (the JAX "
          f"package's design: one bmm per shape group + index_add_) {totals['plain_ms']:.3f} ms, "
          f"bound {totals['bound_ms']:.4f} ms (sum of the calls'), {totals['pairs']} pairs in "
          f"{totals['groups']} groups, {totals['flops'] / 1e9:.2f} GFLOP, "
          f"{totals['bytes'] / 1e9:.2f} GB; library: none (no one torch call computes a "
          "charge-matched grouped contraction)")
    csum = max(sum(v["ms"] for v in by_class.values()), 1e-12)
    for name, v in sorted(by_class.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  block_gemm class {name}: {v['ms']:.3f} ms over {v['dots']} tensordots "
              f"({v['blocks']} blocks, {v['tiles']} tiles; each class launched alone), bound "
              f"{v['bound_ms']:.4f} ms ({100 * v['bound_ms'] / max(v['ms'], 1e-12):.1f}% of it), "
              f"{100 * v['ms'] / csum:.1f}% of the classes' time")
    distinct = list({id(t): (src_p, t, numel) for src_p, t, numel, _ in perms}.values())
    small = sorted(distinct, key=lambda d: d[1].total)[:2]
    check(all(twin_plan_agrees(t, dev) for t in (calls_tables[0], calls_tables[1],
                                                   *(d[1] for d in small))),
          "the twins' index plans built on the card (chip_smoke.twin_plan) equal the host's "
          f"on tensordots 1 and 2 ({calls_tables[0].npairs}, {calls_tables[1].npairs} pairs) "
          f"and the two smallest permute tables ({small[0][1].total}, {small[1][1].total} "
          "entries)")
    del calls_tables
    nbad = [j for j, (src_p, tab, numel) in enumerate(distinct)
            if not permute_against_twin(src_p, tab, numel, dev)]
    check(not nbad, f"block_permute on every permute table of the move ({len(distinct)} "
                    "tables: operand layouts, transposes, the sector gathers, the isometry "
                    f"scatters; {sum(t.total for _, t, _ in distinct)} entries): bit-exact"
                    + (f"; tables {nbad} differ" if nbad else ""))
    del distinct
    del perms
    src, table = big_perm
    twin_plan(table, dev)
    dst_k = torch.empty(table.total, dtype=src.data.dtype, device=dev)
    dst_t = torch.empty_like(dst_k)
    blocksparse.block_permute(src.data, dst_k, table)
    blocksparse.block_permute_twin(src.data, dst_t, table)
    check(torch.equal(dst_k, dst_t), f"block_permute of the largest operand ({table.nblk} blocks "
                                     f"in {len(table.c_soff)} boxes, {table.total} entries, rank "
                                     f"{table.rank}): bit-exact")
    time_case(rec, "block_permute", lambda: blocksparse.block_permute(src.data, dst_k, table),
              lambda: blocksparse.block_permute_twin(src.data, dst_t, table), None,
              2 * 8 * table.total, 0, FP64_CC)
    rec["block_permute"]["library_ms"] = None
    # the sector gather of the corner (K9's first step) on block_permute, and its inverse
    M = ab_ctmrg.c2x2_sl(a, env.C, env.T)
    splan = ab_tensor._sector_plan(M, (0, 1, 2), (3, 4, 5))
    gk = torch.zeros(splan.numel, dtype=M.data.dtype, device=dev)
    gt = torch.zeros_like(gk)
    blocksparse.block_permute(M.data, gk, splan.table)
    blocksparse.block_permute_twin(M.data, gt, twin_plan(splan.table, dev))
    sizes = sorted(((q, v[7]) for q, v in splan.sectors.items()), key=lambda x: -x[1])
    check(torch.equal(gk, gt), f"block_permute sector gather of M ({len(M.struct.keys)} blocks "
                               f"into {len(sizes)} sector matrices, sides {[s for _, s in sizes]}): "
                               "bit-exact")
    check(permute_against_twin(gk, splan.table.inverse(), M.data.numel(), dev),
          "block_permute on the sector gather's inverse table (the sector matrices scattered "
          "back into M's blocks): bit-exact")
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
    rec["frozen_commit"] = frozen_commit_checks(C.data, T.data, nC.data, nT.data, pC, pT)
    del nC, nT

    # bench's case: 10 frozen moves, timed after one warm-up move (the host
    # plans: every frozen move has the same shapes)
    ab_frozen.run_frozen(a, C, T, keep, max_iter=1, conv_tol=0.0)
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


def adjoint_checks(label, na, nC, nT, gen, dev) -> dict:
    """K9's ``adjoint_commit`` against its twin at an adjoint's sizes (the
    site ``na``, C ``nC``, T ``nT`` entries) in float64 and float32: fresh
    buffers; u as one buffer cut at nC (the generic adjoint's views: uT off
    its 16-byte boundary when nC is odd); every buffer one element off its
    boundary and da_i two (their offsets apart), and every buffer three off;
    sizes 1 and odd; da bit-exact, delta within 1e-12 (f64) or 1e-5 (f32)
    relative, ctl bit-exact.  A loop that has ended leaves the state
    untouched, two calls from one state give the same bits.  Timed in CUDA
    graphs (float64, the state never done: u repeats, so delta never
    grows).  Returns the time and the sizes."""
    from tpeps_torch.kernels import frozen as kfrozen

    def state(da, gC, gT):  # the first carry, with da (its values, its place) as given
        st = kfrozen.adjoint_state(da, gC, gT, 100, 1e-8)
        return kfrozen.AdjointState(da, st.scal, st.ctl)

    def off(n, k, dtype):  # n entries k elements past a 16-byte boundary
        return torch.randn(n + k, generator=gen, device=dev, dtype=dtype)[k:]

    def agree(sk, st):
        e = rel_err(sk.scal[:1], st.scal[:1])
        return torch.equal(sk.da, st.da) and torch.equal(sk.ctl, st.ctl), e

    for dtype in (torch.float64, torch.float32):
        tag, tol = str(dtype).replace("torch.", ""), TOL[dtype]
        rnd = lambda n: torch.randn(n, generator=gen, device=dev, dtype=dtype)
        cases = []
        for sizes in ((na, nC, nT), (1, 1, 1), (7, 5, 13)):
            a, c, t = sizes
            gC, gT = rnd(c), rnd(t)
            v = rnd(c + t)
            cases += [(f"{sizes}, fresh buffers", rnd(a), rnd(a), rnd(c), rnd(t), gC, gT),
                      (f"{sizes}, u one buffer cut at nC", rnd(a), rnd(a), v[:c], v[c:], gC, gT),
                      (f"{sizes}, every buffer 1 element off, da_i 2", off(a, 1, dtype),
                       off(a, 2, dtype), off(c, 1, dtype), off(t, 1, dtype), gC, gT),
                      (f"{sizes}, every buffer 3 elements off", off(a, 3, dtype),
                       off(a, 3, dtype), off(c, 3, dtype), off(t, 3, dtype), gC, gT)]
        for name, da0, dai, uC, uT, gC, gT in cases:
            st = state(da0.clone(), gC, gT)
            sk = state(da0, gC, gT)
            kfrozen.adjoint_commit(sk, dai, uC, uT)
            kfrozen.adjoint_commit_twin(st, dai, uC, uT)
            ok, e = agree(sk, st)
            check(ok and e <= tol, f"adjoint_commit {tag} {label}, {name}: da bit-exact, delta "
                                   f"rel err {e:.1e} <= {tol:.0e}, ctl {sk.ctl.tolist()} bit-exact")
        # an ended loop: untouched; two calls from one state: the same bits
        da_i, uC, uT = rnd(na), rnd(nC), rnd(nT)
        ended = state(rnd(na), uC, uT)
        ended.ctl[1] = 1
        before = [x.clone() for x in ended]
        kfrozen.adjoint_commit(ended, da_i, uC, uT)
        check(all(torch.equal(x, y) for x, y in zip(ended, before)),
              f"adjoint_commit {tag} {label}: a loop that has ended leaves da, scal and ctl "
              "untouched")
        s1 = state(rnd(na), uC, uT)
        s2 = kfrozen.AdjointState(s1.da.clone(), s1.scal.clone(), s1.ctl.clone())
        kfrozen.adjoint_commit(s1, da_i, uC, uT)
        kfrozen.adjoint_commit(s2, da_i, uC, uT)
        check(all(torch.equal(x, y) for x, y in zip(s1, s2)),
              f"adjoint_commit {tag} {label}: two calls from one state bit-identical")
    rnd = lambda n: torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    da_i, uC, uT = rnd(na), rnd(nC), rnd(nT)
    sg = kfrozen.adjoint_state(rnd(na), uC, uT, 10**9, 0.0)
    ms = graph_ms(lambda: kfrozen.adjoint_commit(sg, da_i, uC, uT))
    check(int(sg.ctl[1]) == 0, f"adjoint_commit's timing loop never ended ({int(sg.ctl[0])} "
                               "steps)")
    print(f"  adjoint_commit {label} (site {na}, C {nC}, T {nT} entries) in CUDA graphs: "
          f"{ms * 1000:.2f} us")
    return {"graph_ms": ms, "entries": [na, nC, nT]}


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
        tab_a, tab_b = (twin_plan(t, dev) for t in plan.gemm.grad_tables())
        for side, tab, lhs, rhs, n_out in (("dA", tab_a, G, bbuf, abuf.numel()),
                                           ("dB", tab_b, abuf, G, bbuf.numel())):
            def kern(tab=tab, lhs=lhs, rhs=rhs, n_out=n_out):
                return blocksparse.block_gemm(lhs, rhs, torch.zeros(n_out, dtype=lhs.dtype,
                                                                    device=dev), tab)

            def twin(tab=tab, lhs=lhs, rhs=rhs, n_out=n_out):
                return blocksparse.block_gemm_twin(lhs, rhs, torch.zeros(
                    n_out, dtype=lhs.dtype, device=dev), tab)

            out_k, out_t = kern().clone(), twin()
            same = torch.equal(out_k, kern())
            err = rel_err(out_k, out_t)
            err_max = max(err_max, float((out_k - out_t).abs().max()))
            ms_k, ms_t = min(cuda_ms(kern), cuda_ms(kern)), cuda_ms(twin, reps=2)
            flops, elems = tab.work()
            b_ms, b_by = bound(8 * elems, flops, FP64_TC)
            for key, v in (("ms", ms_k), ("plain_ms", ms_t), ("bound_ms", b_ms),
                           ("flops", flops), ("bytes", 8 * elems)):
                tot[key] += v
            classes = ", ".join(f"{blocksparse.CLASS_NAMES[c]} {int((tab.ob_kind == c).sum())}"
                                for c in np.unique(tab.ob_kind))
            check(err <= TOL[torch.float64] and same,
                  f"block_gemm {side} table of tensordot {i + 1}: {tab.npairs} pairs, {tab.nout} "
                  f"blocks ({classes}), {tab.ntiles} tiles, {flops / 1e9:.3f} GFLOP, "
                  f"{8 * elems / 1e6:.1f} MB; kernel {ms_k:.3f} ms, twin {ms_t:.3f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); rel err {err:.1e} <= 1e-12, two calls "
                  f"bit-identical: {same}")
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
    inv = twin_plan(table.inverse(), dev)
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
    err_vjp = frozen_vjp_checks(nC.data, nT.data, pC, pT, gC, gT, blk)
    # bound: raw, partner index, ybar and xbar 8 bytes an element, the block
    # id 4 (the tie split's input)
    nel = nC.data.numel() + nT.data.numel()
    vjp = lambda: kfrozen.frozen_epilogue_vjp(nC.data, nT.data, pC, pT, gC, gT, *blk)
    time_case(rec, "frozen_epilogue_vjp", vjp,
              lambda: kfrozen.frozen_epilogue_vjp_twin(nC.data, nT.data, pC, pT, gC, gT, *blk),
              None, 36 * nel, 8 * nel, FP64_CC)
    rec["frozen_epilogue_vjp"]["max_abs_err"] = max(rec["frozen_epilogue_vjp"]["max_abs_err"],
                                                    err_vjp)
    rec["frozen_epilogue_vjp"]["graph_ms"] = graph_ms(vjp)
    print(f"  frozen_epilogue_vjp in CUDA graphs {rec['frozen_epilogue_vjp']['graph_ms'] * 1000:.2f}"
          f" us ({nel} entries)")
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
    rec["adjoint_commit"].update(adjoint_checks("C4v D=8", na, C.data.numel(), T.data.numel(),
                                                torch.Generator(device=dev).manual_seed(16), dev))
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


def gen_small_dynamic(st_c, where):
    """Phase 10(f)'s dynamic run of the D=3 state on ``where``: the corner
    spectra, the environment and the energy after GEN_SMALL_DYN sweeps."""
    from tpeps_torch.ctm.generic_abelian import ctmrg as gct
    from tpeps_torch.ctm.generic_abelian import env as genv
    from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN

    cfg_s = gen_cfg(["--chi", str(GEN_SMALL_CHI), "--CTMARGS_ctm_max_iter", str(GEN_SMALL_DYN),
                     "--CTMARGS_ctm_conv_tol", "0"])
    st_s = st_c.to(where)
    env_s, _ = gct.run(st_s, genv.init_env(st_s, GEN_SMALL_CHI), cfg_s.ctm)
    return (gct._corner_spectra(env_s, GEN_SMALL_CHI), env_s,
            float(J1J2_ABELIAN(j1=J1, j2=J2, device=where).energy_per_site(st_s, env_s)))


def gen_small_frozen(st_c, envc_s, keeps_s, where):
    """GEN_SMALL_FROZEN frozen sweeps of the D=3 state on ``where`` from the
    CPU-built closed start: ``(env, sweeps, dist2)``."""
    from tpeps_torch.ctm.generic_abelian import env as genv
    from tpeps_torch.ctm.generic_abelian import frozen as gfz

    e = genv.ENV_ABELIAN(GEN_SMALL_CHI, {k: t.to(where) for k, t in envc_s.C.items()},
                         {k: t.to(where) for k, t in envc_s.T.items()})
    return gfz.run_frozen_generic(st_c.to(where), e, keeps_s, max_iter=GEN_SMALL_FROZEN,
                                  conv_tol=0.0)


def gen_small_grad(st_g, profiles_g, ctx_g, where):
    """The gradient of the training loss (normalized sites, the frozen fixed
    point's implicit adjoint, the energy) on ``where`` from the CPU-built
    context: ``(loss, gradient on the CPU, stats, central difference along
    g/|g|)``, the last only off the CPU."""
    from tpeps_torch.ctm.generic_abelian import env as genv
    from tpeps_torch.ctm.generic_abelian import frozen as gfz
    from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN

    st_w = st_g.to(where)
    conv = gfz.make_converge_frozen_generic(st_w, GEN_GRAD_SMALL_CHI, profiles_g, gfz.MOVE_SEQ,
                                            30, 1e-10, 1e-12)
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
    fd_g = None
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
    return (float(lw.detach()), torch.cat([x.reshape(-1).cpu() for x in gw]), stats_w, fd_g)


def gen_small_cpu() -> dict:
    """Phase 10(f)'s CPU side, run in a worker process on one torch thread
    while the card runs (b)-(c): the D=3 state, its dynamic run, the closed
    frozen start and the frozen run from it, and on the Neel state of the CPU
    tests (whose frozen sweep reaches its fixed point) the context and the
    gradient."""
    from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
    from tpeps_torch.optim.abelian import generic_abelian_losses

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    st_c = gen_state(AB_SMALL_AUX, "cpu", seed=1)
    dyn = gen_small_dynamic(st_c, "cpu")
    _, keeps_s, envc_s = gen_frozen(st_c, dyn[1], GEN_SMALL_CHI)
    frozen = gen_small_frozen(st_c, envc_s, keeps_s, "cpu")
    st_g = neel_state_np(AB_SMALL_AUX)
    cfg_g = gen_cfg(["--chi", str(GEN_GRAD_SMALL_CHI), "--CTMARGS_ctm_max_iter", "30",
                     "--CTMARGS_ctm_conv_tol", "1e-10", "--GLOBALARGS_device", "cpu"])
    _, ctx_fn_g, _, _ = generic_abelian_losses(st_g, J1J2_ABELIAN(
        j1=J1, j2=J2, device="cpu").energy_per_site, cfg_g)
    with torch.no_grad():
        profiles_g, ctx_g = ctx_fn_g({c: a.data for c, a in st_g.sites.items()})
    grad = gen_small_grad(st_g, profiles_g, ctx_g, "cpu")
    return {"state": st_c, "dynamic": dyn, "frozen_start": (keeps_s, envc_s), "frozen": frozen,
            "grad_context": (st_g, profiles_g, ctx_g), "grad": grad,
            "seconds": time.perf_counter() - t0}


def phase10(dev) -> tuple:
    print(f"== phase 10: the generic abelian slice, U(1) 2-site bipartite J1-J2 D=8 "
          f"chi={AB_CHI} float64", flush=True)
    from tpeps_torch.ctm.generic_abelian import ctmrg as gct
    from tpeps_torch.ctm.generic_abelian import frozen as gfz
    from tpeps_torch.examples.j1j2.abelian import ctmrg_j1j2_u1
    from tpeps_torch.examples.j1j2.abelian.optim_j1j2_u1 import main as gen_opt_main
    from tpeps_torch.kernels import frozen_generic as kgen
    from tpeps_torch.kernels import (barrier_counters, blocksparse, launch_counts,
                                     reset_launch_counts)
    from tpeps_torch.kernels.build import library
    from tpeps_torch.models.abelian.j1j2 import J1J2_ABELIAN
    from tpeps_torch.optim import abelian as gen_optim
    from tpeps_torch.profiling import PhaseTimers
    from tpeps_torch.sym import tensor as ab_tensor
    from tpeps_torch.sym.io import write_ipeps_abelian

    # (f)'s CPU side runs in a worker process meanwhile (spawned: no CUDA
    # state is forked)
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    small_cpu = pool.submit(gen_small_cpu)
    # the plans of phases 8-9 hold the twins' element indices on the card
    # (GBs at D=8): drop them, so that the peaks below are this phase's
    ab_tensor.PLANS.clear()
    torch.cuda.empty_cache()
    rec = {}
    st = gen_state(AB_AUX, dev)
    model = J1J2_ABELIAN(j1=J1, j2=J2, device=dev)
    pk = ["--CTMARGS_projector_svd_reltol", "1e-12", "--CTMARGS_projector_eps_multiplet", "1e-12"]
    dirs = gct.sweep_directions(st, gfz.MOVE_SEQ)

    # the phase's seconds by part, and the host's plan building in each
    parts, marks = {}, [(time.perf_counter(), ab_tensor.plan_cache_stats()["build_seconds"])]

    def part_done(name):
        t, b = time.perf_counter(), ab_tensor.plan_cache_stats()["build_seconds"]
        parts[name] = (t - marks[-1][0], b - marks[-1][1])
        marks.append((t, b))

    part_done("set-up (the state, the worker started)")
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
        (wall_b, dev_b), gcalls = record_dots(
            lambda: busy_share(lambda: gct.ctm_move(dirs[0], st, envs[-1], AB_CHI, AB_PK)))
        # every distinct table twice (bit-identical); against the twin, whose
        # host index arrays cost ~1.5 s a table here, the first table of each
        # class mix (the set of classes its output blocks fall in)
        t_k8, gres, same_all, tables, mixes, gk = time.perf_counter(), [], [], [], set(), {}
        for x, y, axes, out_like in gcalls:
            plan, abuf, bbuf = x.dot_operands(y, axes, out_like)
            tab = plan.gemm
            if any(tab is t for t in tables):
                continue
            tables.append(tab)
            kinds = np.unique(tab.ob_kind)
            mix = tuple(blocksparse.CLASS_NAMES[c] for c in kinds)
            for c, name in zip(kinds, mix):
                gk[name] = gk.get(name, 0) + int((tab.ob_kind == c).sum())
            if mix in mixes:
                mk = lambda: torch.full((plan.out.numel,), 7.0, dtype=abuf.dtype,  # noqa
                                        device=dev)
                same_all.append(torch.equal(blocksparse.block_gemm(abuf, bbuf, mk(), tab),
                                            blocksparse.block_gemm(abuf, bbuf, mk(), tab)))
                continue
            mixes.add(mix)
            e, same = gemm_against_twin(tab, abuf, bbuf, plan.out.numel, dev)
            gres.append((e, mix))
            same_all.append(same)
        check(all(e <= TOL[torch.float64] for e, _ in gres) and all(same_all),
              f"block_gemm on one directional move's {len(gcalls)} tensordots ({len(tables)} "
              f"distinct tables, two calls bit-identical each) of the generic cell; the "
              f"first table of each of its {len(gres)} class mixes against the twin: max rel "
              f"err {max(e for e, _ in gres):.1e} <= 1e-12 (mixes "
              + "; ".join(f"{'+'.join(m)} {e:.1e}" for e, m in gres)
              + f"); output blocks by class {gk}; {time.perf_counter() - t_k8:.1f} s")
        del gcalls, gres, tables
        print(f"  one more dynamic directional move (a sixth of a sweep) under the profiler "
              f"(plans cached): {1000 * wall_b:.1f} ms, busy share {dev_b / wall_b:.3f} "
              f"({1000 * dev_b:.1f} ms device)")
        del envs

        part_done("(b) the entry point, the K8 checks, the profiled move")
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

    part_done("(e) the training epoch")
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
    W2 = X.clone()
    kgen.generic_epilogue(raw, seg, W2)
    check(torch.equal(Wk, Wt) and torch.equal(Wk, W2),
          f"generic_epilogue on one frozen move's {len(seg.host)} outputs ({raw.numel()} "
          f"entries, {seg.nblk} blocks): bit-exact; two calls bit-identical")
    del W2
    # the 130 outputs of wide_table, one of them holding a NaN (that output
    # NaN in both)
    gen = torch.Generator(device="cpu").manual_seed(10)
    lens, wide = wide_table(gen, dev)
    raw_w = torch.randn(wide.numel, generator=gen, dtype=torch.float64).to(dev)
    raw_w[sum(lens[:70]) + lens[70] // 2] = math.nan
    wk, wt, w2 = (torch.zeros_like(raw_w) for _ in range(3))
    kgen.generic_epilogue(raw_w, wide, wk)
    kgen.generic_epilogue_twin(raw_w, wide, wt)
    kgen.generic_epilogue(raw_w, wide, w2)
    gbar = barrier_counters(dev, "generic_epilogue",
                            library().cdll.tpeps_generic_epilogue_bar_words())
    check(same_float(wk, wt) and same_float(wk, w2) and int(torch.isnan(wk).sum()) == lens[70]
          and int(gbar.abs().sum()) == 0,
          f"generic_epilogue on {len(lens)} segments ({wide.numel} entries, odd lengths, one "
          f"of them NaN): bit-exact, that output NaN; two calls bit-identical; barrier words "
          "left 0")
    del wk, wt, w2, raw_w
    time_case(rec, "generic_epilogue", lambda: (kgen.generic_epilogue(raw, seg, Wk), Wk)[1],
              lambda: (kgen.generic_epilogue_twin(raw, seg, Wt), Wt)[1], None,
              8 * 2 * raw.numel(), raw.numel(), FP64_CC)
    rec["generic_epilogue"]["graph_ms"] = graph_ms(lambda: kgen.generic_epilogue(raw, seg, Wk))
    rec["generic_epilogue"]["segments"] = [int(x) for x in seg.host[:, 2]]
    print(f"  generic_epilogue in CUDA graphs {rec['generic_epilogue']['graph_ms'] * 1000:.2f} "
          f"us (segments {rec['generic_epilogue']['segments']})")
    sk, stw = kgen.sweep_state(X, 10, 0.0), kgen.sweep_state(X, 10, 0.0)
    kgen.sweep_commit(sk, Wk)
    kgen.sweep_commit_twin(stw, Wk)
    e_d = rel_err(sk.dist2, stw.dist2)
    check(torch.equal(sk.S, stw.S) and torch.equal(sk.ctl[:2], stw.ctl[:2])
          and e_d <= TOL[torch.float64],
          f"sweep_commit over the env's {X.numel()} entries: state bit-exact, (i, done) "
          f"{sk.ctl[:2].tolist()}, dist2 {float(sk.dist2):.6e} rel err {e_d:.1e} <= 1e-12")
    # the timing calls alternate the move's env and the start, so that every
    # call commits (a repeated W gives dist2 = 0 and ends the loop)
    sk2, st2 = kgen.sweep_state(X, 10**9, 0.0), kgen.sweep_state(X, 10**9, 0.0)
    turn_k, turn_t = itertools.cycle((Wk, X)), itertools.cycle((Wk, X))
    time_case(rec, "sweep_commit", lambda: (kgen.sweep_commit(sk2, next(turn_k)), sk2.S)[1],
              lambda: (kgen.sweep_commit_twin(st2, next(turn_t)), st2.S)[1], None,
              8 * 3 * X.numel(), 3 * X.numel(), FP64_CC)
    check(int(sk2.ctl[1]) == 0 and int(sk2.ctl[0]) > 10,
          f"sweep_commit's timing loop never ended ({int(sk2.ctl[0])} commits)")
    rec["sweep_commit"]["max_abs_err"] = max(rec["sweep_commit"]["max_abs_err"],
                                             float((sk.dist2 - stw.dist2).abs()))
    # K9's adjoint_commit at the generic adjoint's sizes (the two sites, the
    # env cut at its C entries: uT a view off its 16-byte boundary when odd)
    rec["adjoint_commit_generic"] = adjoint_checks(
        "generic 2-site D=8", int(gfz._Sites(st_c).flat().numel()), lay.numel_C,
        lay.numel - lay.numel_C, torch.Generator(device=dev).manual_seed(17), dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    g = torch.rand(X.numel(), generator=gen, device=dev, dtype=torch.float64) - 0.5
    err_vjp = generic_vjp_checks(raw, g, seg)
    # bound: raw, g and xbar 8 bytes an element, the block id 4 (the tie
    # split's input)
    vjp = lambda: kgen.generic_epilogue_vjp(raw, g, seg)
    time_case(rec, "generic_epilogue_vjp", vjp,
              lambda: kgen.generic_epilogue_vjp_twin(raw, g, seg), None,
              28 * raw.numel(), 5 * raw.numel(), FP64_CC)
    rec["generic_epilogue_vjp"]["max_abs_err"] = max(
        rec["generic_epilogue_vjp"]["max_abs_err"], err_vjp)
    rec["generic_epilogue_vjp"]["graph_ms"] = graph_ms(vjp)
    print(f"  generic_epilogue_vjp in CUDA graphs "
          f"{rec['generic_epilogue_vjp']['graph_ms'] * 1000:.2f} us ({raw.numel()} entries)")
    del raws, raw, Wk, Wt, sk, stw, sk2, st2, g

    part_done("(a) K10 against its twins")
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

    part_done("(c) the frozen and the dynamic sweep")
    # (f) D=3: card against the CPU twins, whose side the worker started at
    # the top of this phase computed from the same seeds
    ref = small_cpu.result()
    pool.shutdown()
    part_done("(f) waiting for the CPU worker")
    print(f"  D=3 CPU side from the worker process: {ref['seconds']:.1f} s, overlapped with "
          "(b)-(c)")
    st_c = ref["state"]
    out = [ref["dynamic"], gen_small_dynamic(st_c, dev)]
    d_spec = float(np.abs(out[0][0] - out[1][0]).max())
    check(d_spec <= AB_SMALL_TOL and abs(out[0][2] - out[1][2]) <= AB_SMALL_TOL,
          f"D=3 chi={GEN_SMALL_CHI} card vs CPU: {GEN_SMALL_DYN} dynamic sweeps' corner spectra "
          f"max diff {d_spec:.2e}, energy |dE| {abs(out[0][2] - out[1][2]):.2e} <= "
          f"{AB_SMALL_TOL:.0e}")
    keeps_s, envc_s = ref["frozen_start"]
    (ec, nc, dc), (ed, nd, dd) = ref["frozen"], gen_small_frozen(st_c, envc_s, keeps_s, dev)
    e_C = max(float((ec.C[k].data - ed.C[k].data.cpu()).abs().max()) for k in ec.C)
    e_T = max(float((ec.T[k].data.abs() - ed.T[k].data.cpu().abs()).abs().max()) for k in ec.T)
    e_Ts = max(float((ec.T[k].data - ed.T[k].data.cpu()).abs().max()) for k in ec.T)
    check(nc == nd and e_C <= AB_SMALL_TOL and e_T <= AB_SMALL_TOL,
          f"D=3 frozen {nc} sweeps card vs CPU: C elementwise {e_C:.2e}, |T| elementwise "
          f"{e_T:.2e} <= {AB_SMALL_TOL:.0e} (T signed {e_Ts:.2e}), dist2 {dd:.6e} vs {dc:.6e}")
    st_g, profiles_g, ctx_g = ref["grad_context"]
    (lc, gc, sc, _), (ld, gd, sd, fd_g) = ref["grad"], gen_small_grad(st_g, profiles_g, ctx_g,
                                                                      dev)
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
    part_done("(f) the D=3 card side")
    print("  phase 10 by part (seconds, of them host plan building): " + "; ".join(
        f"{k} {t:.1f} ({b:.1f})" for k, (t, b) in parts.items()))
    return rec, counts_entry, counts_frozen, counts_train


def tm_bound(chi, D_) -> tuple:
    """One width-1 transfer matvec's least time: 2 chi^3 D^4 + chi^2 D^8
    multiply-adds on the FP64 tensor cores, or its bytes (the edge and A
    read, the new edge written)."""
    D2 = D_ * D_
    flops = 2.0 * (2 * chi**3 * D2**2 + chi**2 * D2**4)
    return bound(8.0 * (2 * chi * D2 * chi + D2**4), flops, FP64_TC)


def tm_steps_ms(a, env, v) -> dict:
    """The width-1 matvec's steps timed alone (ms, CUDA events): its three
    products and the two permutes that lay their operands out, as
    ``corrf._column`` runs them."""
    from tpeps_torch.ctm.c4v.corrf import _aXa, _column_steps

    out = {}
    with torch.no_grad():
        x = v.reshape(env.chi, -1, env.chi)
        for name, step in _column_steps(_aXa(a), env.T):
            out[name] = cuda_ms(lambda: step(x))
            x = step(x)
    return out


def obs_spectrum_checks(a, env, dev) -> float:
    """(a)'s transfer spectrum: normalized, the same at m = 30 and 40, and
    the Ritz residual of the leading pair; returns the seconds at m = 30."""
    from tpeps_torch.ctm.c4v.transferops import get_Top_spec_c4v, top_matvec
    from tpeps_torch.linalg.arnoldi import arnoldi_eigs_vecs, seeded_start

    specs, secs = {}, {}
    for m in OBS_TOP_M:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        specs[m] = get_Top_spec_c4v(OBS_TOP_N, a, env, m=m)
        secs[m] = time.perf_counter() - t0
        print(f"  get_Top_spec_c4v({OBS_TOP_N}, m={m}) {secs[m]:.2f} s: "
              + ", ".join(f"{re:+.12f}{im:+.12f}j" for re, im in specs[m]))
    w30, w40 = (specs[m][:, 0] + 1j * specs[m][:, 1] for m in OBS_TOP_M)
    check(abs(abs(w30[0]) - 1.0) < 1e-12, f"|lambda_0| = {abs(w30[0]):.15f} (normalized)")
    e = float(np.abs(np.sort(np.abs(w30)) - np.sort(np.abs(w40))).max())
    check(e <= OBS_SPEC_TOL, f"|lambda| at m={OBS_TOP_M[0]} and m={OBS_TOP_M[1]}: max diff "
                             f"{e:.2e} <= {OBS_SPEC_TOL:.0e}")
    mv = top_matvec(a, env)
    n = env.chi * a.shape[1] ** 2 * env.chi
    w, X = arnoldi_eigs_vecs(mv, seeded_start(n, a), 1, m=OBS_TOP_M[0])
    x = torch.as_tensor(X[:, 0].astype(np.complex128), device=dev)
    with torch.no_grad():
        Ax = torch.complex(mv(x.real.contiguous()), mv(x.imag.contiguous()))
    res = float(torch.linalg.vector_norm(Ax - complex(w[0]) * x)) / abs(w[0])
    check(res <= OBS_RITZ_TOL, f"Ritz residual |Av - lambda v| / |lambda| = {res:.2e} <= "
                               f"{OBS_RITZ_TOL:.0e} for lambda_0 = {complex(w[0]):.12f}")
    return secs[OBS_TOP_M[0]]


def run_entry(argv) -> tuple:
    """``ctmrg_j1j2_c4v.main(argv)``, its printed lines echoed indented."""
    from tpeps_torch.examples.j1j2 import ctmrg_j1j2_c4v

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = ctmrg_j1j2_c4v.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"    | {line}")
    return out


def obs_small(where, path) -> tuple:
    """(c)'s D=2 entry point on ``where``: energy, correlators, spectrum."""
    e, _, _, out = run_entry(
        ["--instate", path, "--bond_dim", str(D_SMALL), "--chi", str(CHI_SMALL), "--j2", str(J2),
         "--CTMARGS_ctm_max_iter", "300", "--CTMARGS_ctm_conv_tol", "1e-12", "--corrf_r",
         str(OBS_ENTRY_R), "--top_n", str(OBS_TOP_N), "--GLOBALARGS_device", str(where)])
    return e, out["ss"].cpu(), out["top"]


def phase11(dev, a, env) -> tuple:
    print(f"== phase 11: the C4v observables slice, J1-J2 D={D} chi={CHI} float64", flush=True)
    from tpeps_torch.ctm.c4v import rdm, transferops
    from tpeps_torch.ctm.c4v.ctmrg import run_fixed_point
    from tpeps_torch.ctm.c4v.env import EnvC4v, init_env
    from tpeps_torch.ctm.c4v.fpcm import fpcm_move_sl
    from tpeps_torch.examples.j1j2 import optim_j1j2_c4v
    from tpeps_torch.ipeps.ipeps_c4v import IPEPS_C4V
    from tpeps_torch.kernels import launch_counts, reset_launch_counts
    from tpeps_torch.models.j1j2 import J1J2_C4V_BIPARTITE

    t_phase = time.perf_counter()
    model = J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=dev)
    # (a) phase 3's environment
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e_full = float(model.energy_1x1(a, env))
    t_full = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    e_low = float(model.energy_1x1_lowmem(a, env))
    print(f"  energy_1x1 {e_full:.14f} in {t_full:.2f} s (peak {peak / 2**30:.2f} GiB above the "
          f"state), energy_1x1_lowmem {e_low:.14f}")
    check(abs(e_full - e_low) <= OBS_E_TOL,
          f"energy_1x1 vs energy_1x1_lowmem |dE| = {abs(e_full - e_low):.2e} <= {OBS_E_TOL:.0e}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rho = rdm.rdm1x1_sl(a, env)
    torch.cuda.synchronize()
    print(f"  rdm1x1_sl in {time.perf_counter() - t0:.2f} s (peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the state)")
    check(bool(torch.isfinite(rho).all()) and abs(float(torch.trace(rho)) - 1) < 1e-12
          and float((rho - rho.mH).abs().max()) < 1e-14, "rdm1x1_sl finite, trace 1, hermitian")
    mv = transferops.top_matvec(a, env)
    v = torch.rand(env.chi * D * D * env.chi, dtype=a.dtype, device=dev,
                   generator=torch.Generator(dev).manual_seed(0))
    with torch.no_grad():
        ms = cuda_ms(lambda: mv(v))
    b_ms, b_by = tm_bound(env.chi, D)
    print(f"  one width-1 transfer matvec {ms:.3f} ms (CUDA events), bound {b_ms:.3f} ms "
          f"({b_by}): {b_ms / ms:.0%} of the bound's rate; by step: "
          + ", ".join(f"{k} {t:.3f}" for k, t in tm_steps_ms(a, env, v).items()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss = model.eval_corrf_SS(a, env, OBS_CORRF_R)["ss"]
    torch.cuda.synchronize()
    t_ss = time.perf_counter() - t0
    obs, labels = model.eval_obs(a, env)
    print(f"  eval_corrf_SS({OBS_CORRF_R}) {t_ss:.2f} s: "
          + ", ".join(f"r={i + 1} {x:.12f}" for i, x in enumerate(ss.tolist())))
    ss2x1 = obs[labels.index("SS2x1")]
    check(bool(torch.isfinite(ss).all()) and abs(float(ss[0]) - ss2x1) <= OBS_E_TOL,
          f"SS r=1 {float(ss[0]):.14f} vs eval_obs SS2x1 {ss2x1:.14f} <= {OBS_E_TOL:.0e}")
    t0 = time.perf_counter()
    dd = model.eval_corrf_DD_H(a, env, OBS_DD_R)["dd"]
    torch.cuda.synchronize()
    t_dd = time.perf_counter() - t0
    print(f"  eval_corrf_DD_H({OBS_DD_R}) {t_dd:.2f} s: "
          + ", ".join(f"{x:.12f}" for x in dd.tolist()))
    check(bool(torch.isfinite(dd).all()), "dimer-dimer correlations finite")
    t_top = obs_spectrum_checks(a, env, dev)
    print(f"  (a) took {time.perf_counter() - t_phase:.1f} s")
    del rho, v, mv
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the entry point at full width on phase 3's state
        path = str(Path(tmp) / "d7.json")
        IPEPS_C4V(a.detach().cpu()).write_to_file(path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        e7, obs7, _, out7 = run_entry(
            ["--instate", path, "--bond_dim", str(D), "--chi", str(CHI), "--j2", str(J2),
             "--CTMARGS_ctm_max_iter", str(OBS_ENTRY_MOVES), "--corrf_r", str(OBS_ENTRY_R),
             "--top_n", str(OBS_TOP_N)])
        torch.cuda.synchronize()
        counts = launch_counts()
        t_entry = time.perf_counter() - t0
        print(f"  (b) ctmrg_j1j2_c4v D={D} chi={CHI}, {OBS_ENTRY_MOVES} moves: {t_entry:.2f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
        top7 = out7["top"]
        check(all(math.isfinite(x) for x in [e7] + [abs(complex(o)) for o in obs7]
                  + out7["ss"].tolist() + top7.ravel().tolist()), "entry point outputs finite")
        check(abs(math.hypot(*top7[0]) - 1.0) < 1e-12, "entry point spectrum normalized")
        for name in OBS_PATH:
            check(counts[name] > 0, f"{name} launched {counts[name]} times on the entry point")

        # (c) D=2 chi=16: the entry point on the card against the CPU
        t0 = time.perf_counter()
        path2 = str(Path(tmp) / "d2.json")
        IPEPS_C4V(bench_state(D_SMALL, "cpu")).write_to_file(path2)
        (e_c, ss_c, top_c), (e_d, ss_d, top_d) = (obs_small(w, path2) for w in ("cpu", dev))
        check(abs(e_c - e_d) <= OBS_SMALL_TOL,
              f"(c) energy card vs CPU |dE| = {abs(e_c - e_d):.2e} <= {OBS_SMALL_TOL:.0e}")
        e = float((ss_c - ss_d).abs().max())
        check(e <= OBS_SMALL_TOL, f"(c) SS correlators card vs CPU {e:.2e} <= {OBS_SMALL_TOL:.0e}")
        e = float(np.abs(top_c - top_d).max())
        check(e <= OBS_SPEC_TOL, f"(c) spectrum card vs CPU {e:.2e} <= {OBS_SPEC_TOL:.0e}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            optim_j1j2_c4v.main(
                ["--bond_dim", str(D_SMALL), "--chi", str(CHI_SMALL), "--j2", str(J2),
                 "--opt_max_iter", "1", "--CTMARGS_projector_svd_method", "POWER",
                 "--OPTARGS_line_search", "backtracking", "--OPTARGS_line_search_svd_method",
                 "POWER", "--out_prefix", str(Path(tmp) / "opt"), "--top_freq", "1",
                 "--top_n", str(OBS_TOP_N)])
        tops = [l for l in buf.getvalue().splitlines() if l.startswith("TOP ")]
        print("    | " + (tops[0] if tops else "(no TOP line)"))
        check(len(tops) == 1, f"optim_j1j2_c4v --top_freq 1, one epoch: {len(tops)} TOP line")
        print(f"  (c) took {time.perf_counter() - t0:.1f} s")

    # (d) D=3: card against the CPU on one CPU-converged environment
    t0 = time.perf_counter()
    a3_c = bench_state(3, "cpu")
    env3_c, n3, _, _ = run_fixed_point(a3_c, init_env(a3_c, OBS_D3_CHI), max_iter=300,
                                       conv_tol=1e-11)
    a3, env3 = a3_c.to(dev), EnvC4v(env3_c.C.to(dev), env3_c.T.to(dev))
    model3 = {w: J1J2_C4V_BIPARTITE(j1=J1, j2=J2, device=w) for w in ("cpu", dev)}
    res = []
    for w, aw, ew in (("cpu", a3_c, env3_c), (dev, a3, env3)):
        res.append((transferops.get_Top2_spec_c4v(3, aw, ew),
                    model3[w].eval_corrf_DD_V(aw, ew, 2)["dd"].cpu(),
                    rdm.aux_rdm1x1(ew, 3).cpu(), rdm.ddA_rdm1x1(aw, ew).cpu()))
    (top2_c, ddv_c, aux_c, dda_c), (top2_d, ddv_d, aux_d, dda_d) = res
    print(f"  (d) D=3 chi={OBS_D3_CHI}: width-2 spectrum "
          + ", ".join(f"{re:+.12f}{im:+.12f}j" for re, im in top2_d)
          + "; DD_V " + ", ".join(f"{x:.12f}" for x in ddv_d.tolist()))
    e = float(np.abs(top2_c - top2_d).max())
    check(e <= OBS_SPEC_TOL, f"(d) width-2 spectrum card vs CPU {e:.2e} <= {OBS_SPEC_TOL:.0e}")
    e = float((ddv_c - ddv_d).abs().max())
    check(e <= OBS_SMALL_TOL, f"(d) eval_corrf_DD_V card vs CPU {e:.2e} <= {OBS_SMALL_TOL:.0e}")
    e = max(rel_err(aux_d, aux_c), rel_err(dda_d, dda_c))
    check(e <= TOL[torch.float64], f"(d) aux_rdm1x1, ddA_rdm1x1 card vs CPU rel {e:.2e} <= "
                                   f"{TOL[torch.float64]:.0e}")
    e_std = float(model3[dev].energy_1x1_lowmem(a3, env3))
    env_w, *_ = run_fixed_point(a3, init_env(a3, OBS_D3_CHI), max_iter=4, conv_tol=1e-30)
    t1 = time.perf_counter()
    e_fp = float(model3[dev].energy_1x1_lowmem(a3, fpcm_move_sl(a3, env_w)))
    print(f"  (d) FPCM after 4 moves {time.perf_counter() - t1:.2f} s: energy {e_fp:.14f}, the "
          f"standard fixed point's ({n3} moves) {e_std:.14f}")
    check(abs(e_fp - e_std) <= FPCM_E_TOL,
          f"(d) FPCM energy vs the standard fixed point {abs(e_fp - e_std):.2e} <= {FPCM_E_TOL:.0e}")
    print(f"  (d) took {time.perf_counter() - t0:.1f} s")
    secs = time.perf_counter() - t_phase
    print(f"  seconds: energy_1x1 {t_full:.2f}, eval_corrf_SS({OBS_CORRF_R}) {t_ss:.2f}, "
          f"eval_corrf_DD_H({OBS_DD_R}) {t_dd:.2f}, spectrum m={OBS_TOP_M[0]} {t_top:.2f}, "
          f"entry point {t_entry:.2f}; matvec {ms:.3f} ms (bound {b_ms:.3f}); phase {secs:.1f}")
    check(secs <= OBS_BUDGET_S, f"phase 11 took {secs:.1f} s <= {OBS_BUDGET_S:.0f} s")
    return counts


# the timing copies of K10's generic_epilogue and K9's frozen_commit: the
# launch alone, without the grid barrier, without stores; frozen_commit also
# without the last block's sum and without the partner gather
COMMIT_COPIES = {0: "whole", 1: "launch and set-up only", 2: "no grid barrier", 4: "no stores"}
FROZEN_COPIES = {**COMMIT_COPIES, 8: "no last block's sum", 16: "no partner gather"}
# the timing copies of K9's frozen_epilogue_vjp and K10's generic_epilogue_vjp
VJP_COPIES = {0: "whole", 32: "launch and set-up only", 64: "no grid barriers",
              256: "no second barrier", 128: "no stores"}
FROZEN_VJP_COPIES = {**VJP_COPIES, 512: "no partner gathers"}
# K5's ctm_commit and a copy of it in 16-byte vectors, four loads in flight a thread
CTM_COPIES = {0: "whole", "-DTPEPS_CTM_VEC=1": "16-byte copy"}
# K2's float32 kernel and its timing copies (csrc/corner_apply.cu)
K2F32_COPIES = {0: "whole", 1: "no copies", 2: "no wgmmas or splits", 4: "no split-K sum",
                3: "no copies, no wgmmas", 8: "one TF32 product (A_hi B_hi)",
                16: "no slab sums (one running sum)", 32: "no split of P",
                64: "no copies of P's planes", 128: "no copies of M2"}
# K9's adjoint_commit (csrc/frozen_commit.cu), timed whole beside the parent's
ADJ_COPIES = {0: "whole"}
# what each -DTPEPS_ABLATE bit leaves out (csrc/cholqr.cu, csrc/ozaki.cu,
# csrc/eigh_small.cu, csrc/double_layer.cu, csrc/corner_apply.cu,
# csrc/polar.cu); the copies of eigh_small.cu run every sweep (64) and those
# of polar.cu every step (8), as many as the whole kernel needed; a string key
# is a define of its own (K2's DMMA shape, K6's prefetch depth)
ABLATIONS = {"cholqr.cu": {0: "whole", 1: "no loads", 2: "no MMAs", 3: "no loads, no MMAs",
                           4: "no k loop", 8: "no panel updates", 16: "no substitutions",
                           24: "no panel updates, no substitutions",
                           56: "no panel updates, no substitutions, no tile loads or stores"},
             "ozaki.cu": {0: "whole", 2: "no wgmmas", 8: "no recombination", 16: "no stores",
                          32: "no plane stores", 64: "no digit pass"},
             "t_epilogue.cu": {0: "whole"},
             "eigh_small.cu": {0: "whole", 64: "whole, every sweep", 65: "no subproblems",
                               66: "no H updates", 68: "no V updates",
                               71: "no subproblems, no H or V updates",
                               72: "every subproblem a full sweep in every round"},
             "double_layer.cu": {0: "whole", 1: "no loads", 2: "no ket product",
                                 4: "no bra product", 8: "no stores",
                                 6: "no ket or bra product", 9: "no loads, no stores",
                                 7: "stores only", 14: "loads only",
                                 15: "no loads, products or stores",
                                 "-DTPEPS_DL_MMA_K=8": "m16n8k8"},
             "corner_apply.cu": {0: "whole", 1: "no copies", 2: "no DMMAs",
                                 4: "no split-K reduction", 3: "no copies, no DMMAs",
                                 "-DTPEPS_K2_MMA_K=8": "m16n8k8",
                                 "-DTPEPS_K2_MMA_K=16": "m16n8k16",
                                 "-DTPEPS_K2_WM=2": "64-row tiles",
                                 "-DTPEPS_K2_WM=3": "96-row tiles",
                                 "-DTPEPS_K2_STAGES=3": "3 stages"},
             "block_sparse.cu": {0: "whole"},
             "polar.cu": {0: "whole", 8: "every step to the cap", 9: "no exchange",
                          10: "no products", 13: "no exchange, no step barrier",
                          16: "no staging", 32: "no gather",
                          "-DTPEPS_POLAR_DEPTH=3": "12 k-steps of loads in flight"},
             "ctm_commit.cu": CTM_COPIES,
             "frozen_commit.cu": {**FROZEN_COPIES, **FROZEN_VJP_COPIES},
             "frozen_generic.cu": {**COMMIT_COPIES, **VJP_COPIES}}
ABLATE_KERNELS = ("gram_kernel", "ozaki_gemm_kernel", "trsm_kernel", "block_jacobi",
                  "double_layer_kernel", "corner_dmma_kernel", "layer_dmma_kernel",
                  "dmma_gemm_kernel", "polar_kernel", "polar_vjp_kernel", "block_gemm_kernel",
                  "block_permute_kernel", "split_rows", "split_cols", "t_epilogue_kernel",
                  "ctm_commit_kernel", "frozen_commit_kernel", "epilogue_kernel", "epilogue_vjp",
                  "vjp_")
# the parts of ablate(): the sources each builds, and those of the parent it needs
ABLATE_GROUPS = {"gram": ("cholqr.cu",), "ozaki": ("ozaki.cu",), "solves": ("cholqr.cu",),
                 "eigh": ("eigh_small.cu",), "fused": ("double_layer.cu", "corner_apply.cu"),
                 "polar": ("polar.cu",), "k8": ("block_sparse.cu",), "split": ("ozaki.cu",),
                 "epilogue": ("t_epilogue.cu",),
                 "commit": ("ctm_commit.cu", "frozen_commit.cu", "frozen_generic.cu"),
                 "vjp": ("frozen_commit.cu", "frozen_generic.cu"), "corner": ("corner_apply.cu",),
                 "adjoint": ("frozen_commit.cu",)}
# the copies a part builds where it needs fewer than ABLATIONS lists
ABLATE_KEYS = {"corner": {"corner_apply.cu": K2F32_COPIES},
               "adjoint": {"frozen_commit.cu": ADJ_COPIES}}
# the parent's sources each part times, and the sources linked with each
# (the parent's polar.cu calls the Gram of its cholqr.cu)
ABLATE_PARENT = {"solves": ("cholqr.cu",), "fused": ("layer_contract.cu", "corner_apply.cu"),
                 "polar": ("polar.cu",), "k8": ("block_sparse.cu",), "split": ("ozaki.cu",),
                 "epilogue": ("t_epilogue.cu",), "commit": ("frozen_commit.cu", "frozen_generic.cu"),
                 "vjp": ("frozen_commit.cu", "frozen_generic.cu"), "corner": ("corner_apply.cu",),
                 "adjoint": ("frozen_commit.cu",)}
PARENT_LINKED = {"polar.cu": ("cholqr.cu",)}


class ParentLayerGeom(ctypes.Structure):
    """The parent's ``struct LayerGeom`` (its two-launch ``layer_contract.cu``),
    for timing it beside the fused kernel."""

    _fields_ = [("K", ctypes.c_int64), ("P", ctypes.c_int64), ("N", ctypes.c_int64),
                ("kd", ctypes.c_int64 * 3), ("xk", ctypes.c_int64 * 3),
                ("pd", ctypes.c_int64 * 3), ("yp", ctypes.c_int64 * 3),
                ("nd", ctypes.c_int64 * 4), ("xn", ctypes.c_int64 * 4),
                ("yn", ctypes.c_int64 * 4)]


def parent_layer_geom(W, X, Y, n_k):
    """The parent's geometry of ``Y[p.., n..] = W[p, k] X[k.., n..]``
    (its wrapper's, ``tpeps_torch/kernels/layer.py``)."""
    pad = lambda vals, n, fill: (ctypes.c_int64 * n)(*([fill] * (n - len(vals)) + list(vals)))
    n_p = Y.dim() - (X.dim() - n_k)
    return ParentLayerGeom(
        K=W.shape[1], P=W.shape[0], N=math.prod(X.shape[n_k:]),
        kd=pad(X.shape[:n_k], 3, 1), xk=pad(X.stride()[:n_k], 3, 0),
        pd=pad(Y.shape[:n_p], 3, 1), yp=pad(Y.stride()[:n_p], 3, 0),
        nd=pad(X.shape[n_k:], 4, 1), xn=pad(X.stride()[n_k:], 4, 0),
        yn=pad(Y.stride()[n_p:], 4, 0))


def ablate(parent=None, only=None) -> dict:
    """Where the time of K3's Gram and solves, K7's ``ozaki_gemm``,
    ``eigh_small``, K1's fused double layer, K2's corner apply and K6
    (:func:`ablate_polar`) goes: each
    source built again with one part of its kernel left out
    (``-DTPEPS_ABLATE``, one nvcc each, all started together), each copy's
    ptxas registers, and each called through its C entry on the same seeded
    inputs and timed side by side (:func:`graph_ms`, the smaller of two
    means, the copies in turn and then in reverse).  The Gram at k = chi in
    f64, ``gram`` and ``gram_ridge``; ``ozaki_gemm`` at the sliced and the
    ket layers and at M2 P, beside FP64 ``torch.matmul``; the solves at n =
    chi D^2 and k = chi, chi + 8 in f64 and f32 beside
    ``torch.linalg.solve_triangular``; ``eigh_small`` on the Rayleigh-Ritz H
    of moves 4 and 31 of the D=7 path and on dense random H of k = 169 and
    64 beside ``torch.linalg.eigh``; K1 and K2 (:func:`ablate_fused`).  With
    ``parent``, the root of another checkout, its ``cholqr.cu``,
    ``layer_contract.cu``, ``corner_apply.cu`` and ``polar.cu`` are built too
    and its solves, layers, corner apply and K6 timed first and last in the
    same turns (parent, change, change, parent), and the cold start and the
    graphed move are timed in each checkout (:func:`move_compare`).
    K8 (:func:`ablate_k8`, ``k8``): with ``parent``, its
    ``block_sparse.cu`` beside this one, and the frozen move, the cached
    dynamic move, one adjoint iteration and host planning in each checkout
    (:func:`k8_move_compare`).  K7's ``ozaki_split`` (:func:`ablate_split`,
    ``split``) at every split shape of the Ozaki move, with ``parent`` its
    ``ozaki.cu`` beside this one and the Ozaki move, the graphed Ozaki move
    and ``run_ctmrg_mixed``'s float64 phase in each checkout
    (:func:`oz_move_compare`); K4's ``t_epilogue``
    (:func:`ablate_epilogue`, ``epilogue``) at the move's shape in f64 and
    f32, with ``parent`` its ``t_epilogue.cu`` and :func:`move_compare`.
    K5's ``ctm_commit``, K9's ``frozen_commit`` and K10's
    ``generic_epilogue`` (:func:`ablate_commit`, ``commit``; the last two
    also as the launch alone, without the grid barrier and without stores),
    with ``parent`` the parent's two,
    :func:`move_compare` and :func:`k8_move_compare`'s frozen move.
    K9's ``frozen_epilogue_vjp``, K10's ``generic_epilogue_vjp``,
    ``adjoint_commit`` and ``sweep_commit`` (:func:`ablate_vjp`, ``vjp``),
    with ``parent`` the parent's beside them and :func:`k8_move_compare`'s
    adjoint iteration.
    K2's float32 kernel (:func:`ablate_corner`, ``corner``) at every phase-2
    shape beside ``torch.matmul`` in float32, with its timing copies at the
    move's shape, and with ``parent`` the parent's K2 in both dtypes and
    ``run_ctmrg_mixed``'s phases and the graphed float32 move in each
    checkout (:func:`mixed_compare`); K9's ``adjoint_commit``
    (:func:`ablate_adjoint`, ``adjoint``) at the C4v and a 2-site-sized
    adjoint's sizes with its timing copies and two other designs.
    ``only`` names the parts to run (:data:`ABLATE_GROUPS`).  Run by
    ``chip_smoke.py --ablate [--parent DIR] [--only
    gram,ozaki,solves,eigh,fused,polar,k8,split,epilogue,commit,vjp,corner,adjoint]``."""
    from tpeps_torch.kernels import build as kb

    groups = tuple(ABLATE_GROUPS) if only is None else tuple(only)
    print(f"== ablation ({', '.join(groups)}): kernels with parts left out", flush=True)
    dev = torch.device("cuda", 0)
    out_dir = kb.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kb.find_nvcc(), {}
    variants = {}
    for grp in groups:
        for src in ABLATE_GROUPS[grp]:
            variants.setdefault(src, {}).update(ABLATE_KEYS.get(grp, {}).get(src, ABLATIONS[src]))
    builds = {(src, key): (key if isinstance(key, str) else f"-DTPEPS_ABLATE={key}", label,
                           (kb.CSRC_DIR / src,))
              for src, copies in variants.items() for key, label in copies.items()}
    if parent is not None:
        for grp in groups:
            for src in ABLATE_PARENT.get(grp, ()):
                path = Path(parent) / "tpeps_torch" / "csrc" / src
                if src == "layer_contract.cu" and not path.exists():  # a parent after PR 9
                    src, path = "double_layer.cu", path.with_name("double_layer.cu")
                linked = tuple(path.with_name(x) for x in PARENT_LINKED.get(src, ()))
                builds[src, "parent"] = ("-DTPEPS_ABLATE=0", "parent", (path, *linked))
    try:
        for (src, key), (flag, _, paths) in builds.items():
            tag = re.sub(r"\W+", "_", str(key))
            so = out_dir / f"{Path(src).stem}_{tag}.so"
            cmd = [nvcc, *kb.NVCC_FLAGS, *flag.split(), "-shared", *map(str, paths), "-o", str(so)]
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

    rec = {}
    if "split" in groups:
        rec.update(ablate_split(libs, in_turns, stream, dev, parent is not None))
        if parent is not None:
            rec["ozaki_moves"] = oz_move_compare(parent)
    if "epilogue" in groups:
        rec.update(ablate_epilogue(libs, in_turns, stream, dev, parent))
    if "commit" in groups:
        rec.update(ablate_commit(libs, in_turns, stream, dev, parent))
    if "vjp" in groups:
        rec.update(ablate_vjp(libs, in_turns, stream, dev, parent))
    if "adjoint" in groups:
        rec.update(ablate_adjoint(libs, in_turns, stream, dev, parent))
    if "corner" in groups:
        rec.update(ablate_corner(libs, in_turns, stream, dev, parent))
        if parent is not None:
            rec["mixed_driver"] = mixed_compare(parent)
    if "k8" in groups:
        rec.update(ablate_k8(libs, in_turns, stream, dev, parent is not None))
    if parent is not None and {"k8", "commit", "vjp"} & set(groups):
        rec["k8_moves"] = k8_move_compare(parent)
    if "polar" in groups:
        rec.update(ablate_polar(libs, in_turns, stream, dev, parent is not None))
    if parent is not None and {"fused", "polar", "epilogue", "commit"} & set(groups):
        rec["move"] = move_compare(parent)
    if "fused" in groups:
        rec.update(ablate_fused(libs, in_turns, stream, dev, parent is not None))
    if "solves" in groups:
        rec.update(ablate_solves(libs, in_turns, stream, dev, parent is not None))
    if "eigh" in groups:
        rec.update(ablate_eigh(libs, in_turns, stream, dev))
    if "gram" in groups:
        rec.update(ablate_gram(libs, in_turns, stream, dev))
    if "ozaki" in groups:
        rec.update(ablate_ozaki(libs, in_turns, stream, dev))
    return rec


def ablate_gram(libs, in_turns, stream, dev) -> dict:
    """:func:`ablate`'s part for K3's two Grams."""
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
    return rec


def ablate_ozaki(libs, in_turns, stream, dev) -> dict:
    """:func:`ablate`'s part for K7's ``ozaki_gemm``."""
    from tpeps_torch.kernels import ozaki

    gen = torch.Generator(device=dev).manual_seed(5)
    rec, n = {}, CHI * D * D
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
        for bits in (0, 2, 8, 16):
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
    return rec


def ablate_split(libs, in_turns, stream, dev, with_parent) -> dict:
    """:func:`ablate`'s part for K7's ``ozaki_split``: every split shape of the
    Ozaki move (:data:`SPLIT_SHAPES`) on seeded operands, the whole kernel,
    its copies without the plane stores (32) and without the digit pass (64),
    and the parent's kernel
    first and last in the turns ``with_parent``, in CUDA graphs, beside the
    bound and the target."""
    from tpeps_torch.kernels.ozaki import padded_k

    gen = torch.Generator(device=dev).manual_seed(6)
    rec = {}
    for label, (axis, rows, k, per_move) in SPLIT_SHAPES.items():
        X = torch.randn(*((rows, k) if axis == 1 else (k, rows)), generator=gen, device=dev,
                        dtype=torch.float64)
        kp = padded_k(k)
        planes = torch.empty(8, rows, kp, dtype=torch.int8, device=dev)
        e = torch.empty(rows, dtype=torch.float64, device=dev)
        calls = {}
        for bits in (("parent",) if with_parent else ()) + (0, 32, 64):
            def call(lib=libs["ozaki.cu", bits]):
                err = lib.tpeps_ozaki_split(X.data_ptr(), planes.data_ptr(), e.data_ptr(), rows, k,
                                            kp, 8, 7, axis, stream())
                if err:
                    fail(f"ozaki_split {label} launch: CUDA error {err}")
            calls[ABLATIONS["ozaki.cu"].get(bits, bits)] = call
        ms = in_turns(calls, 5, 4)
        bound_ms, _ = split_bound(axis, rows, k)
        rec[f"ozaki_split {label}"] = {"axis": axis, "rows": rows, "k": k, "ms": ms,
                                       "bound_ms": bound_ms, "target_ms": SPLIT_TARGET_MS.get(label),
                                       "launches_per_ozaki_move": per_move}
        print(f"  ozaki_split {label} (axis {axis}, rows {rows}, k {k}; {per_move} per Ozaki "
              f"move): " + ", ".join(f"{v} {t:.4f} ms" for v, t in ms.items())
              + f"; bound {bound_ms:.4f} ms"
              + (f", target <= {SPLIT_TARGET_MS[label]} ms" if label in SPLIT_TARGET_MS else ""),
              flush=True)
        del X, planes, e
    return rec


# a parent's t_epilogue entries from before the grid barrier's counters
PARENT_EPILOGUE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def ablate_epilogue(libs, in_turns, stream, dev, parent) -> dict:
    """:func:`ablate`'s part for K4's ``t_epilogue`` at the move's shape (D^2
    x chi x chi), f64 and f32, both normalisations, beside the twin, and the
    kernel of the checkout ``parent`` (if not None) first and last in the
    turns, called with the arguments its own source declares."""
    from tpeps_torch.kernels import barrier_counters, epilogue

    gen = torch.Generator(device=dev).manual_seed(7)
    bar = barrier_counters(dev, "t_epilogue")
    parent_bar = parent is not None and "unsigned* bar" in (
        Path(parent) / "tpeps_torch" / "csrc" / "t_epilogue.cu").read_text()
    rec = {}
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        x = torch.randn(D, D, CHI, CHI, generator=gen, device=dev, dtype=dtype)
        out = torch.empty_like(x)
        part = torch.empty(1024, dtype=dtype, device=dev)  # >= either kernel's partials
        for mode, norm in ((0, "inf"), (1, "fro")):
            calls = {}
            if parent is not None:
                pfn = getattr(libs["t_epilogue.cu", "parent"], f"tpeps_t_epilogue_{sfx}")
                if not parent_bar:
                    pfn.argtypes = PARENT_EPILOGUE_ARGS
                pargs = (bar.data_ptr(),) if parent_bar else ()

                def parent_call(fn=pfn, mode=mode, pargs=pargs):
                    err = fn(x.data_ptr(), out.data_ptr(), part.data_ptr(), *pargs, D * D, CHI,
                             mode, stream())
                    if err:
                        fail(f"parent t_epilogue launch: CUDA error {err}")
                # the parent's call must really write its result
                out.fill_(float("nan"))
                parent_call()
                tol = 1e-12 if dtype == torch.float64 else 1e-5
                check(torch.allclose(out, epilogue.t_epilogue_twin(x, norm), rtol=tol, atol=tol),
                      f"parent t_epilogue {sfx} {norm} wrote the twin's result")
                calls["parent"] = parent_call
            fn = getattr(libs["t_epilogue.cu", 0], f"tpeps_t_epilogue_{sfx}")

            def call(fn=fn, mode=mode):
                err = fn(x.data_ptr(), out.data_ptr(), part.data_ptr(), bar.data_ptr(), D * D, CHI,
                         mode, stream())
                if err:
                    fail(f"t_epilogue launch: CUDA error {err}")
            calls["whole"] = call
            calls["twin"] = lambda norm=norm: epilogue.t_epilogue_twin(x, norm)
            ms = in_turns(calls, 20, 5)
            bound_ms, _ = bound(2 * nbytes(x), 0, FP64_CC)
            rec[f"t_epilogue {sfx} {norm}"] = {"ms": ms, "bound_ms": bound_ms}
            print(f"  t_epilogue {sfx} {norm} {tuple(x.shape)}: "
                  + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
                  + f"; bound {bound_ms * 1000:.2f} us"
                  + (", target <= 12 us" if sfx == "f64" else ""), flush=True)
    return rec


def frozen_layout(dev):
    """Phase 8's frozen-move layout (U(1) D=8, chi=160: AB_WARM_MOVES dynamic
    moves from the seeded state, frozen and closed): the flat C and T, their
    transpose-partner tables, their block indices and block counts, and the
    site's entries."""
    from tpeps_torch.ctm.c4v_abelian import ctmrg as ab_ctmrg
    from tpeps_torch.ctm.c4v_abelian import frozen as ab_frozen
    from tpeps_torch.ctm.c4v_abelian.env import init_env as ab_init_env

    st = ab_state(AB_AUX, dev)
    a = st.site((0, 0))
    env = ab_init_env(st, AB_CHI)
    for _ in range(AB_WARM_MOVES):
        env = ab_ctmrg.ctm_move_sl(a, env, AB_PK)
    C, T = ab_frozen.close_structure(a, env.C, env.T, dict(ab_frozen.freeze_from_env(env)))
    return (C.data, T.data, ab_frozen.partner_index(C.struct, ab_frozen.C_PARTNER, dev),
            ab_frozen.partner_index(T.struct, ab_frozen.T_PARTNER, dev),
            (ab_frozen.block_index(C.struct, dev), ab_frozen.block_index(T.struct, dev),
             len(C.struct.keys), len(T.struct.keys)), a.data.numel())


# K10's timing table: a directional move of the 2-site D=8 chi=160 cell has
# six outputs and 507,472 entries (phase 10(a)); two corners and an edge a site
GEN_EPI_SEGMENTS = (3000, 3000, 247736, 3000, 3000, 247736)


# a read of this many bytes between two calls leaves none of the first
# call's data in the H100's 50 MB L2
L2_FLUSH_BYTES = 256 * 2**20


def cold_l2_ms(fn, flush, reps: int = 20) -> float:
    """Device ms of ``fn`` with the L2 flushed before each call: in CUDA
    graphs, (a read of ``flush``, then ``fn``) less (the read alone), the
    smaller of two means each, in the order both, read, read, both.  The
    writes ``fn`` leaves in L2 are written back during the next read, so
    they count, as its bound counts them."""
    sink = torch.empty((), dtype=flush.dtype, device=flush.device)
    read = lambda: torch.sum(flush, dim=0, out=sink)
    both = lambda: (read(), fn())
    t = [graph_ms(f, reps, 5) for f in (both, read, read, both)]
    return min(t[0], t[3]) - min(t[1], t[2])


def ctm_commit_in_move(dev) -> dict:
    """K5 ``ctm_commit`` inside the graphed f64 move (D=7, chi=147,
    ``"spec"``, :data:`MOVE_CODE`'s state after eight eager moves; a
    four-move MoveGraph that never ends), from a torch.profiler trace of five
    replays: each launch's device time, its inputs made by the move's last
    kernels and its state by the move before; the graphed moves' device
    time beside it.  ``ms`` None where the trace holds no kernel of the
    graph."""
    from torch.profiler import ProfilerActivity, profile

    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.ctm.c4v.move_graph import CHAIN_CONV_TOL, CHAIN_MAX_ITER, MoveGraph
    from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v

    x = np.random.RandomState(0).rand(2, D, D, D, D) - 0.5
    a = symmetrize_c4v(torch.as_tensor(x, dtype=torch.float64), normalize=True).to(dev)
    env = init_env(a, CHI, "CTMRG")
    C, T, W = env.C, mf.to_int_layout(env.T, D), None
    P = mf.cold_start_basis(CHI * D * D, CHI, a.dtype, dev)
    for _ in range(8):
        C, T, _, P, W = mf.ctm_move_w(a, C, T, P, W)
    g = MoveGraph(a, CHI, n_moves=4)
    g.load(a, C, T, P, max_iter=CHAIN_MAX_ITER, conv_tol=CHAIN_CONV_TOL, W=W)
    g.run()
    g.run()
    torch.cuda.synchronize()
    i0 = int(g.state.ctl[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            g.run()
        torch.cuda.synchronize()
    check(int(g.state.ctl[0]) == i0 + 20 and not g.done(),
          "ctm_commit in the graphed move: the 20 traced moves all committed")
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    k5 = [(b - a0) / 1e6 for name, a0, b in spans if "ctm_commit_kernel" in name]
    busy = sum(b - a0 for _, a0, b in spans) / 1e6 / 20
    out = {"ms": sorted(k5)[len(k5) // 2] if k5 else None, "ms_min": min(k5, default=None),
           "ms_max": max(k5, default=None), "launches_traced": len(k5),
           "kernels_traced": len(spans), "move_device_ms_summed": busy}
    if k5:
        print(f"  ctm_commit in the graphed f64 move (trace of 20 moves): median "
              f"{out['ms'] * 1000:.2f} us, {out['ms_min'] * 1000:.2f}-{out['ms_max'] * 1000:.2f} "
              f"us over {len(k5)} launches; the move's kernels {busy:.3f} ms summed", flush=True)
    else:
        print(f"  ctm_commit in the graphed f64 move: not measured (the trace holds "
              f"{len(spans)} device events, no ctm_commit_kernel)", flush=True)
    del g
    return out


def ablate_commit(libs, in_turns, stream, dev, parent) -> dict:
    """:func:`ablate`'s part for the loop-commit kernels, each in CUDA graphs
    beside its bound: K5's ``ctm_commit`` (D=7, chi=147: f64 and f32,
    ``conv_on`` "spec" and "env"; also with the L2 flushed before each call,
    :func:`cold_l2_ms`, and inside the graphed move, :func:`ctm_commit_in_move`), K9's ``frozen_commit`` (phase 8's
    frozen-move layout, seeded raw values: the work does not depend on them;
    the calls alternate between two raw buffers, so that every call commits)
    and K10's ``generic_epilogue`` (:data:`GEN_EPI_SEGMENTS`, f64): the
    kernels of this checkout and their timing copies (:data:`COMMIT_COPIES`,
    :data:`FROZEN_COPIES`),
    and those of the checkout ``parent`` (if not None) first and last in the
    turns, called with the arguments its own sources declare (its
    ``frozen_commit`` takes a scratch buffer and no barrier counters, its
    ``generic_epilogue`` partials where this one takes its counters).  The first call of every library but
    the timing copies is held to the twin."""
    from tpeps_torch.kernels import ctm_loop
    from tpeps_torch.kernels import frozen as kfrozen
    from tpeps_torch.kernels import frozen_generic as kgen

    gen = torch.Generator(device=dev).manual_seed(17)
    rec = {}
    flush = torch.ones(L2_FLUSH_BYTES // 8, dtype=torch.float64, device=dev)
    checked = lambda key: key in ("parent", 0)  # the timing copies compute nothing right
    sfx_of = {torch.float64: "f64", torch.float32: "f32"}
    for dtype, sfx in sfx_of.items():
        rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev, dtype=dtype)
        new = (rnd(CHI, CHI), rnd(D, D, CHI, CHI), rnd(CHI * D * D, CHI), rnd(CHI, CHI))
        spec2 = rnd(CHI)
        old = (rnd(CHI, CHI), rnd(D, D, CHI, CHI), rnd(CHI * D * D, CHI))
        part = torch.empty(4096, dtype=dtype, device=dev)
        for conv_on in ("spec", "env"):
            env_flag = int(conv_on == "env")
            calls = {}
            for key, label in CTM_COPIES.items():
                st = ctm_loop.loop_state(*old, 10**9, -1.0)
                fn = getattr(libs["ctm_commit.cu", key], f"tpeps_ctm_commit_{sfx}")

                def call(fn=fn, st=st):
                    err = fn(*(x.data_ptr() for x in st), part.data_ptr(),
                             *(x.data_ptr() for x in (*new, spec2)),
                             *(x.numel() for x in new), CHI, env_flag, stream())
                    if err:
                        fail(f"ctm_commit launch: CUDA error {err}")
                s1, s2 = ctm_loop.loop_state(*old, 10, -1.0), ctm_loop.loop_state(*old, 10, -1.0)
                s1.spec.copy_(spec2.abs() * 0.5)
                s2.spec.copy_(spec2.abs() * 0.5)
                call(st=s1)
                ctm_loop.ctm_commit_twin(s2, *new, spec2, conv_on)
                check(all(torch.equal(x, y) for x, y in zip(s1[:5], s2[:5]))
                      and rel_err(s1.dist, s2.dist) <= TOL[dtype] and torch.equal(s1.ctl, s2.ctl),
                      f"ctm_commit {sfx} {conv_on} ({label}): the first call is the twin's")
                calls[label] = call
            ms = in_turns(calls, 20, 5)
            cold = {label: cold_l2_ms(fn, flush) for label, fn in calls.items()}
            nb = 2 * nbytes(*new, spec2) + (nbytes(*new[:2]) if env_flag else 0)
            b_ms, _ = bound(nb, 0, FP64_CC)
            rec[f"ctm_commit {sfx} {conv_on}"] = {"ms": ms, "cold_l2_ms": cold, "bound_ms": b_ms}
            print(f"  ctm_commit {sfx} {conv_on} (D={D}, chi={CHI}, {nb / 1e6:.1f} MB): "
                  + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
                  + "; L2 flushed " + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in cold.items())
                  + f"; bound {b_ms * 1000:.2f} us", flush=True)
    del flush
    rec["ctm_commit in the graphed move"] = ctm_commit_in_move(dev)

    C, T, pC, pT, _, _ = frozen_layout(dev)
    nel = C.numel() + T.numel()
    rnd = lambda n: torch.randn(n, generator=gen, device=dev, dtype=C.dtype)
    raws = ((rnd(C.numel()), rnd(T.numel())), (rnd(C.numel()), rnd(T.numel())))
    part = torch.empty(4096, dtype=C.dtype, device=dev)
    sym = torch.empty(nel, dtype=C.dtype, device=dev)
    bar = torch.zeros(6, dtype=torch.int32, device=dev)  # K9's counters and maxima
    parent_sym = parent is not None and "double* sym" in (
        Path(parent) / "tpeps_torch" / "csrc" / "frozen_commit.cu").read_text()
    parent_key = [("parent", "parent")] if parent is not None else []
    calls = {}
    for key, label in parent_key + list(FROZEN_COPIES.items()):
        fn = libs["frozen_commit.cu", key].tpeps_frozen_commit_f64
        scratch = (sym, part) if key == "parent" and parent_sym else (part, bar)
        turn = itertools.cycle(raws)

        def call(fn=fn, scratch=scratch, turn=turn, st=None):
            rC, rT = next(turn)
            err = fn(*(x.data_ptr() for x in st), *(x.data_ptr() for x in scratch),
                     rC.data_ptr(), rT.data_ptr(), pC.data_ptr(), pT.data_ptr(), rC.numel(),
                     rT.numel(), stream())
            if err:
                fail(f"frozen_commit launch: CUDA error {err}")
        if checked(key):
            s1, s2 = kfrozen.frozen_state(C, T, 10, 0.0), kfrozen.frozen_state(C, T, 10, 0.0)
            call(st=s1, turn=iter(raws[:1]))
            kfrozen.frozen_commit_twin(s2, *raws[0], pC, pT)
            check(torch.equal(s1.C, s2.C) and torch.equal(s1.T, s2.T)
                  and rel_err(s1.dist2, s2.dist2) <= TOL[torch.float64]
                  and torch.equal(s1.ctl, s2.ctl) and int(bar.abs().sum()) == 0,
                  f"frozen_commit ({label}): the first call is the twin's; barrier counters "
                  "left 0")
        st = kfrozen.frozen_state(C, T, 10**9, 0.0)
        calls[label] = lambda call=call, st=st: call(st=st)
    ms = in_turns(calls, 20, 5)
    b_ms, _ = bound(8 * 4 * nel, 6 * nel, FP64_CC)
    rec["frozen_commit f64"] = {"ms": ms, "bound_ms": b_ms, "entries": nel}
    print(f"  frozen_commit f64 (U(1) D=8 chi={AB_CHI} frozen layout, {nel} entries): "
          + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
          + f"; bound {b_ms * 1000:.2f} us", flush=True)

    seg = kgen.segment_table([(sum(GEN_EPI_SEGMENTS[:i]), [n]) for i, n in
                              enumerate(GEN_EPI_SEGMENTS)], dev)
    raw = torch.randn(seg.numel, generator=gen, device=dev, dtype=torch.float64)
    env_k, env_t = torch.zeros_like(raw), torch.zeros_like(raw)
    kgen.generic_epilogue_twin(raw, seg, env_t)
    # K10's counters and per-segment maxima; the parent's kernel takes partials there
    gbar = torch.zeros(4 + 2 * 64, dtype=torch.int32, device=dev)
    parent_part = parent is not None and "unsigned* bar" not in (
        Path(parent) / "tpeps_torch" / "csrc" / "frozen_generic.cu").read_text()
    calls = {}
    for key, label in parent_key + list(COMMIT_COPIES.items()):
        fn = libs["frozen_generic.cu", key].tpeps_generic_epilogue_f64
        scratch = part if key == "parent" and parent_part else gbar

        def call(fn=fn, scratch=scratch):
            err = fn(raw.data_ptr(), seg.seg.data_ptr(), len(seg.host), scratch.data_ptr(),
                     env_k.data_ptr(), stream())
            if err:
                fail(f"generic_epilogue launch: CUDA error {err}")
        if checked(key):
            env_k.fill_(math.nan)
            call()
            check(torch.equal(env_k, env_t) and int(gbar.abs().sum()) == 0,
                  f"generic_epilogue ({label}): the first call is the twin's, bit for bit; "
                  "barrier counters left 0")
        calls[label] = call
    ms = in_turns(calls, 20, 5)
    b_ms, _ = bound(2 * nbytes(raw), raw.numel(), FP64_CC)
    rec["generic_epilogue f64"] = {"ms": ms, "bound_ms": b_ms, "segments": GEN_EPI_SEGMENTS}
    print(f"  generic_epilogue f64 ({len(GEN_EPI_SEGMENTS)} segments, {raw.numel()} entries): "
          + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
          + f"; bound {b_ms * 1000:.2f} us", flush=True)
    return rec


def takes_bar(path, fn) -> bool:
    """Whether the C entry ``fn`` of the source ``path`` takes barrier words
    (one cooperative launch) or not (the three-launch form)."""
    m = re.search(rf"int {fn}\(([^)]*)\)", Path(path).read_text())
    return m is not None and "unsigned* bar" in m.group(1)


# the generic_epilogue_vjp C entry without barrier words (its partials and
# tie counts zeroed by the caller)
PARENT_GVJP_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p)


def split_blocks(n, size=4096):
    """Block sizes of an output of ``n`` entries cut into blocks of about
    ``size`` (K10's timing table: the work does not depend on the cut)."""
    return [len(x) for x in np.array_split(np.arange(n), max(1, n // size))]


def ablate_vjp(libs, in_turns, stream, dev, parent) -> dict:
    """:func:`ablate`'s part for the backward kernels of the abelian frozen
    fixed points, each in CUDA graphs beside its bound: K9's
    ``frozen_epilogue_vjp`` on phase 8's frozen-move layout (C' and T',
    237,601 entries) and K10's ``generic_epilogue_vjp`` on
    :data:`GEN_EPI_SEGMENTS` (six outputs, 507,472 entries), both at
    ``sg_norm`` False and True, with their timing copies
    (:data:`VJP_COPIES`, K9's :data:`FROZEN_VJP_COPIES`) and the eager call
    through this checkout's wrapper;
    ``adjoint_commit`` at the C4v D=8 adjoint's sizes (the site, C and T)
    and ``sweep_commit`` at the 2-site env (1,989,344 entries).  The kernels
    of the checkout ``parent`` (if not None) first and last in the turns,
    called with the arguments their own sources declare (three launches and
    their tie counts zeroed before the call, as its wrappers did).  The
    first call of every library but the timing copies is held to the twin:
    ``sg_norm=True`` bit for bit, False to 1e-12; barrier words left 0."""
    from tpeps_torch.kernels import frozen as kfrozen
    from tpeps_torch.kernels import frozen_generic as kgen

    gen = torch.Generator(device=dev).manual_seed(14)
    rnd = lambda n: torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    src = lambda key: (Path(parent) if key == "parent" else Path(__file__).resolve().parent) / \
        "tpeps_torch" / "csrc"
    parent_key = [("parent", "parent")] if parent is not None else []
    keys = parent_key + list(VJP_COPIES.items())
    checked = lambda key: key in ("parent", 0)  # the timing copies compute nothing right
    part = torch.empty(64 * 1024, dtype=torch.float64, device=dev)
    rec = {}

    C, T, pC, pT, (bC, bT, nbC, nbT), na = frozen_layout(dev)
    nC, nT = C.numel(), T.numel()
    rawC, rawT, gC, gT = rnd(nC), rnd(nT), rnd(nC), rnd(nT)
    xC, xT = torch.empty_like(rawC), torch.empty_like(rawT)
    for sg in (False, True):
        ref = kfrozen.frozen_epilogue_vjp_twin(rawC, rawT, pC, pT, gC, gT, bC, bT, nbC, nbT, sg)
        calls = {}
        for key, label in parent_key + list(FROZEN_VJP_COPIES.items()):
            fn = libs["frozen_commit.cu", key].tpeps_frozen_epilogue_vjp_f64
            one_launch = takes_bar(src(key) / "frozen_commit.cu", "tpeps_frozen_epilogue_vjp_f64")
            if one_launch:
                cnt = torch.empty(nbC + nbT, dtype=torch.int32, device=dev)
                bar = torch.zeros(256, dtype=torch.int32, device=dev)
                scratch = lambda cnt=cnt, bar=bar: (cnt.data_ptr(), bar.data_ptr())
            else:
                cnt = torch.zeros(nbC + nbT, dtype=torch.int32, device=dev)
                bar = torch.zeros(1, dtype=torch.int32, device=dev)

                def scratch(cnt=cnt):  # the parent's wrapper zeroed its two tie counts
                    cnt.zero_()
                    return cnt.data_ptr(), cnt[nbC:].data_ptr()

            def call(fn=fn, scratch=scratch, sg=sg):
                err = fn(rawC.data_ptr(), rawT.data_ptr(), pC.data_ptr(), pT.data_ptr(),
                         gC.data_ptr(), gT.data_ptr(), bC.data_ptr(), bT.data_ptr(), *scratch(),
                         nbC, nbT, xC.data_ptr(), xT.data_ptr(), part.data_ptr(), nC, nT, int(sg),
                         stream())
                if err:
                    fail(f"frozen_epilogue_vjp launch: CUDA error {err}")
            if checked(key):
                xC.fill_(math.nan)
                xT.fill_(math.nan)
                call()
                same = torch.equal(xC, ref[0]) and torch.equal(xT, ref[1])
                e = max(rel_err(xC, ref[0]), rel_err(xT, ref[1]))
                # the three launches fused a product into a sum (an FMA): not bit for bit
                exact = sg and one_launch
                check((same if exact else e <= TOL[torch.float64]) and int(bar.abs().sum()) == 0,
                      f"frozen_epilogue_vjp sg_norm={sg} ({label}): the first call is the "
                      f"twin's (bit-identical {same}, rel err {e:.1e}); barrier words left 0")
            calls[label] = call
        ms = in_turns(calls, 20, 5)
        eager = cuda_ms(lambda sg=sg: kfrozen.frozen_epilogue_vjp(rawC, rawT, pC, pT, gC, gT, bC,
                                                                  bT, nbC, nbT, sg), reps=20)
        # raw, partner index, g and xbar 8 bytes an element, the block id 4
        # (not read with the scale detached)
        b_ms, _ = bound((32 if sg else 36) * (nC + nT), 8 * (nC + nT), FP64_CC)
        rec[f"frozen_epilogue_vjp f64 sg_norm={sg}"] = {
            "ms": ms, "eager_wrapper_ms": eager, "bound_ms": b_ms, "entries": nC + nT}
        print(f"  frozen_epilogue_vjp f64 sg_norm={sg} (C' {nC}, T' {nT} entries): "
              + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
              + f"; eager through the wrapper {eager * 1000:.2f} us; bound {b_ms * 1000:.2f} us"
              + ("" if sg else "; target <= 10 us"), flush=True)
    rec["frozen_epilogue_vjp f64 sg_norm=False"]["launches_per_call"] = 1

    da_i, uC, uT = rnd(na), rnd(nC), rnd(nT)
    calls = {}
    for key, label in keys[:2] if parent is not None else keys[:1]:
        fn = libs["frozen_commit.cu", key].tpeps_adjoint_commit_f64
        st = kfrozen.adjoint_state(torch.zeros_like(da_i), gC, gT, 10**9, 0.0)

        def call(fn=fn, st=st):
            err = fn(st.da.data_ptr(), da_i.data_ptr(), na, uC.data_ptr(), nC, uT.data_ptr(), nT,
                     st.scal.data_ptr(), st.ctl.data_ptr(), part.data_ptr(), stream())
            if err:
                fail(f"adjoint_commit launch: CUDA error {err}")
        calls[label] = call
    ms = in_turns(calls, 20, 5)
    b_ms, _ = bound(8 * (3 * na + nC + nT), na + 2 * (nC + nT), FP64_CC)
    rec["adjoint_commit f64"] = {"ms": ms, "bound_ms": b_ms, "entries": [na, nC, nT]}
    print(f"  adjoint_commit f64 (site {na}, C {nC}, T {nT} entries): "
          + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
          + f"; bound {b_ms * 1000:.2f} us", flush=True)
    del C, T, pC, pT, bC, bT, rawC, rawT, gC, gT, xC, xT, da_i, uC, uT

    seg = kgen.segment_table([(sum(GEN_EPI_SEGMENTS[:i]), split_blocks(n)) for i, n in
                              enumerate(GEN_EPI_SEGMENTS)], dev)
    nseg = len(seg.host)
    raw, g = rnd(seg.numel), rnd(seg.numel)
    out = torch.empty_like(raw)
    for sg in (False, True):
        ref = kgen.generic_epilogue_vjp_twin(raw, g, seg, sg)
        calls = {}
        for key, label in keys:
            fn = libs["frozen_generic.cu", key].tpeps_generic_epilogue_vjp_f64
            cnt = torch.zeros(seg.nblk, dtype=torch.int32, device=dev)
            bar = torch.zeros(256, dtype=torch.int32, device=dev)
            one_launch = takes_bar(src(key) / "frozen_generic.cu",
                                   "tpeps_generic_epilogue_vjp_f64")
            if one_launch:
                scratch = lambda cnt=cnt, bar=bar: (cnt.data_ptr(), bar.data_ptr())
            else:
                fn.argtypes = PARENT_GVJP_ARGS

                def scratch(cnt=cnt):  # the parent's wrapper zeroed its tie counts
                    cnt.zero_()
                    return (cnt.data_ptr(),)

            def call(fn=fn, scratch=scratch, sg=sg):
                err = fn(raw.data_ptr(), g.data_ptr(), seg.seg.data_ptr(), nseg,
                         seg.blk.data_ptr(), part.data_ptr(), *scratch(), int(sg),
                         out.data_ptr(), stream())
                if err:
                    fail(f"generic_epilogue_vjp launch: CUDA error {err}")
            if checked(key):
                out.fill_(math.nan)
                call()
                same, e = torch.equal(out, ref), rel_err(out, ref)
                exact = sg and one_launch
                check((same if exact else e <= TOL[torch.float64]) and int(bar.abs().sum()) == 0,
                      f"generic_epilogue_vjp sg_norm={sg} ({label}): the first call is the "
                      f"twin's (bit-identical {same}, rel err {e:.1e}); barrier words left 0")
            calls[label] = call
        ms = in_turns(calls, 20, 5)
        eager = cuda_ms(lambda sg=sg: kgen.generic_epilogue_vjp(raw, g, seg, sg), reps=20)
        # raw, g and xbar 8 bytes an element, the block id 4 (not read with
        # the scale detached)
        b_ms, _ = bound((24 if sg else 28) * raw.numel(), 5 * raw.numel(), FP64_CC)
        rec[f"generic_epilogue_vjp f64 sg_norm={sg}"] = {
            "ms": ms, "eager_wrapper_ms": eager, "bound_ms": b_ms, "segments": GEN_EPI_SEGMENTS,
            "blocks": seg.nblk}
        print(f"  generic_epilogue_vjp f64 sg_norm={sg} ({nseg} outputs, {raw.numel()} entries, "
              f"{seg.nblk} blocks): " + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
              + f"; eager through the wrapper {eager * 1000:.2f} us; bound {b_ms * 1000:.2f} us"
              + ("" if sg else "; target <= 12 us"), flush=True)
    rec["generic_epilogue_vjp f64 sg_norm=False"]["launches_per_call"] = 1
    del raw, g, out

    # the 2-site D=8 chi=160 env (phase 10); the calls alternate two W, so
    # that every call commits (a repeated W gives dist2 = 0 and ends the loop)
    n = 1989344
    Ws = (rnd(n), rnd(n))
    calls, states = {}, []
    for key, label in keys[:2] if parent is not None else keys[:1]:
        fn = libs["frozen_generic.cu", key].tpeps_sweep_commit_f64
        st = kgen.sweep_state(rnd(n), 10**9, 0.0)
        states.append(st)

        def call(fn=fn, st=st, turn=itertools.cycle(Ws)):
            err = fn(st.S.data_ptr(), next(turn).data_ptr(), n, st.dist2.data_ptr(),
                     st.conv_tol.data_ptr(), st.ctl.data_ptr(), part.data_ptr(), stream())
            if err:
                fail(f"sweep_commit launch: CUDA error {err}")
        calls[label] = call
    ms = in_turns(calls, 20, 5)
    check(all(int(st.ctl[1]) == 0 for st in states), "sweep_commit's timing loops never ended")
    b_ms, _ = bound(8 * 3 * n, 3 * n, FP64_CC)
    rec["sweep_commit f64"] = {"ms": ms, "bound_ms": b_ms, "entries": n}
    print(f"  sweep_commit f64 ({n} entries): "
          + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
          + f"; bound {b_ms * 1000:.2f} us", flush=True)
    return rec


OZ_MOVE_CODE = r"""
import json, time, numpy as np, torch
from tpeps_torch.ctm.c4v import move_factored as mf
from tpeps_torch.ctm.c4v.env import init_env
from tpeps_torch.ctm.c4v.move_graph import CHAIN_CONV_TOL, CHAIN_MAX_ITER, MoveGraph
from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
torch.backends.cuda.matmul.allow_tf32 = False
dev, D, chi = torch.device("cuda", 0), 7, 147
x = np.random.RandomState(0).rand(2, D, D, D, D) - 0.5
a = symmetrize_c4v(torch.as_tensor(x, dtype=torch.float64), normalize=True).to(dev)
env = init_env(a, chi, "CTMRG")
T = mf.to_int_layout(env.T, D)
P0 = mf.cold_start_basis(chi * D * D, chi, a.dtype, dev)
kw = dict(n_power=2, slice_phys=True, dot_impl="ozaki")
ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
eager = []
for _ in range(3):
    mf.ctm_move_sl_factored(a, env.C, T, P0, **kw)
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(3):
        mf.ctm_move_sl_factored(a, env.C, T, P0, **kw)
    ev[1].record()
    ev[1].synchronize()
    eager.append(ev[0].elapsed_time(ev[1]) / 3)
g = MoveGraph(a, chi, n_moves=4, **kw)
g.load(a, env.C, T, P0, max_iter=CHAIN_MAX_ITER, conv_tol=CHAIN_CONV_TOL)
g.run()
g.run()
torch.cuda.synchronize()
ev[0].record()
for _ in range(5):
    g.run()
ev[1].record()
ev[1].synchronize()
graphed = ev[0].elapsed_time(ev[1]) / 20
del g
f64 = []
for _ in range(2):
    stats = []
    mf.run_ctmrg_mixed(a, env, max_iter=48, conv_tol=1e-8, slice_phys=True, moves_per_sync=4,
                       stats=stats)
    f64.append([st for st in stats if st["phase"] == "f64"][0])
print("OZMOVE " + json.dumps({"eager_ozaki_move_ms": min(eager), "graphed_ozaki_move_ms": graphed,
                              "mixed_f64_phase_s": [st["seconds"] for st in f64],
                              "mixed_f64_phase_moves": [st["moves"] for st in f64]}))
"""


def oz_move_compare(parent) -> dict:
    """One Ozaki move (phase 7(c)'s, slice_phys), the graphed Ozaki move (a
    MoveGraph of 4) and ``run_ctmrg_mixed``'s float64 phase (twice, capture
    included) in the parent's checkout and in this one, in turns (parent,
    change, change, parent), each in a process of its own
    (:data:`OZ_MOVE_CODE`)."""
    out = {}
    here = Path(__file__).resolve().parent
    for i, (label, cwd) in enumerate((("parent", Path(parent)), ("change", here),
                                      ("change", here), ("parent", Path(parent)))):
        proc = subprocess.run([sys.executable, "-c", OZ_MOVE_CODE], cwd=cwd, capture_output=True,
                              text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("OZMOVE ")]
        check(proc.returncode == 0 and bool(line),
              f"Ozaki move in {label}'s checkout: rc {proc.returncode} {proc.stderr[-2000:]}")
        r = json.loads(line[-1][7:])
        out[f"{label} {i}"] = r
        print(f"  Ozaki move ({label}): eager {r['eager_ozaki_move_ms']:.2f} ms, graphed "
              f"{r['graphed_ozaki_move_ms']:.2f} ms/move; run_ctmrg_mixed's float64 phase "
              + ", ".join(f"{t:.3f} s ({n} moves)" for t, n in zip(r["mixed_f64_phase_s"],
                                                                 r["mixed_f64_phase_moves"])),
              flush=True)
    return out


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


def ablate_polar(libs, in_turns, stream, dev, with_parent) -> dict:
    """:func:`ablate`'s part for K6: ``polar_unitary`` on the overlaps of
    moves 1, 4 and 31 of the D=7 path, a random well-conditioned one (k =
    chi and 169) and a graded one near the guard's edge (sigma_max/sigma_min
    3e9), each first through the whole kernel (its steps), then every copy
    at that many steps and the whole kernel capped at one step (the set-up,
    one step and the write-out), beside the eigh-based twin (eager: cuSOLVER's
    eigh does not capture) and, with the parent, its kernel (first and
    last); ``polar_vjp`` at k = chi and 169 in f64 and f32 beside its twin
    (two products) and one ``torch.matmul`` of the shape, and the parent's."""
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.kernels import polar

    rec = {}
    a = bench_state(D, dev)
    env = init_env(a, CHI, "CTMRG")
    T_int = mf.to_int_layout(env.T, D)
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.inference_mode():
        cases = {f"O of move {n + 1}": near_unitary_overlap(a, env.C, T_int, n_moves=n)
                 for n in (0, 3, 30)}
    cases["random well-conditioned"] = well_conditioned(CHI, gen, torch.float64, dev)
    cases[f"random well-conditioned k={EIGH_BIG}"] = well_conditioned(EIGH_BIG, gen,
                                                                      torch.float64, dev)
    q = lambda: torch.linalg.qr(torch.randn(CHI, CHI, generator=gen, device=dev,
                                            dtype=torch.float64)).Q
    s_ = torch.logspace(0, -math.log10(3e9), CHI, dtype=torch.float64, device=dev)
    cases["graded, sigma_max/sigma_min 3e9"] = ((q() * s_) @ q().mT).contiguous()
    for label, O in cases.items():
        k = O.shape[0]
        W = torch.empty_like(O)
        info = torch.zeros(5, dtype=torch.int32, device=dev)

        def run(key, steps, O=O, W=W, info=info, k=k):
            err = libs["polar.cu", key].tpeps_polar_unitary_f64(
                O.data_ptr(), W.data_ptr(), info.data_ptr(), None, k, steps, stream())
            if err:
                fail(f"polar_unitary launch: CUDA error {err}")
        run(0, polar.MAX_STEPS)
        steps, conv, kept = info.tolist()[:3]
        calls = {}
        if with_parent:
            scratch = torch.empty(4 * k * k + k, dtype=O.dtype, device=dev)
            state = torch.zeros(5, dtype=torch.int32, device=dev)
            fp = libs["polar.cu", "parent"].tpeps_polar_unitary_f64
            fp.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

            def parent_call(fp=fp, O=O, W=W, scratch=scratch, state=state, k=k):
                err = fp(O.data_ptr(), scratch.data_ptr(), W.data_ptr(), state.data_ptr(), k, 20,
                         stream())
                if err:
                    fail(f"parent polar_unitary launch: CUDA error {err}")
            calls["parent"] = parent_call
        calls["whole"] = lambda: run(0, polar.MAX_STEPS)
        calls["one step"] = lambda: run(0, 1)
        for bits in (8, 9, 10, 13):
            calls[ABLATIONS["polar.cu"][bits]] = lambda b=bits: run(b, max(steps, 1))
        calls["whole, 12 k-steps of loads in flight"] = lambda: run("-DTPEPS_POLAR_DEPTH=3",
                                                                    polar.MAX_STEPS)
        if with_parent:
            calls["parent, again"] = calls["parent"]
        ms = in_turns(calls, 10, 3)
        ms["twin (eager)"] = cuda_ms(lambda: polar.polar_unitary_twin(O))
        rec[f"polar_unitary {label}"] = {"k": k, "steps": steps, "converged": conv, "kept": kept,
                                         **ms}
        print(f"  polar_unitary {label} (k={k}, {steps} steps, converged {conv}, kept {kept}): "
              + ", ".join(f"{v} {t * 1000:.1f} us" for v, t in ms.items()), flush=True)
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        for k in (CHI, EIGH_BIG):
            W = polar.polar_unitary(well_conditioned(k, gen, torch.float64, dev)).to(dtype)
            Wb = torch.randn(k, k, generator=gen, device=dev, dtype=dtype)
            Ob = torch.empty_like(W)
            calls = {}
            for key in (("parent",) if with_parent else ()) + (0, 16, 32):
                def call(f=getattr(libs["polar.cu", key], f"tpeps_polar_vjp_{sfx}"), k=k, W=W,
                         Wb=Wb, Ob=Ob):
                    err = f(W.data_ptr(), Wb.data_ptr(), Ob.data_ptr(), k, stream())
                    if err:
                        fail(f"polar_vjp launch: CUDA error {err}")
                calls[ABLATIONS["polar.cu"].get(key, key)] = call
            calls["twin (two products)"] = lambda W=W, Wb=Wb: polar.polar_vjp_twin(W, Wb)
            calls["torch.matmul (one product)"] = lambda W=W, Wb=Wb: torch.matmul(W.mT, Wb)
            if with_parent:
                calls["parent, again"] = calls["parent"]
            label = f"polar_vjp {sfx} k={k}"
            rec[label] = ms = in_turns(calls, 20, 5)
            print(f"  {label}: " + ", ".join(f"{v} {t * 1000:.1f} us" for v, t in ms.items()),
                  flush=True)
    return rec


def ablate_fused(libs, in_turns, stream, dev, with_parent) -> dict:
    """:func:`ablate`'s part for K1's fused double layer and K2's corner
    apply at the corner's shapes (D=7, chi=147; X and M2 seeded random, M2's
    rows padded to an even pitch as the move leaves them): every copy of
    ``double_layer.cu`` in f64 and f32 beside one ``torch.einsum`` of both
    layers and, with the parent, its two ``layer_contract`` launches (first
    and last); every copy of ``corner_apply.cu`` at n = chi D^2, m = chi in
    f64 beside ``torch.matmul`` and, with the parent, its ``corner_apply``
    on an unpadded M2 (its layout); K2's f32 kernel and the parent's."""
    from tpeps_torch.kernels import ARRIVAL_COUNTERS
    from tpeps_torch.kernels.layer import _DLGeom, bulk_runs, store_order, vector_rows

    rec, n, d = {}, CHI * D * D, 2
    gen = torch.Generator(device=dev).manual_seed(6)
    for dtype in (torch.float64, torch.float32):
        sfx = "f64" if dtype == torch.float64 else "f32"
        a = bench_state(D, dev, dtype)
        # X with its i axis padded to a multiple of 4, as the move lays it out
        cp = -(-CHI // 4) * 4
        Xbuf = torch.randn(D, D, CHI, D, D, cp, generator=gen, device=dev, dtype=dtype)
        X6 = Xbuf[..., :CHI]
        M2 = torch.empty((n, n + n % 2), dtype=dtype, device=dev)[:, :n]
        out = M2.view(CHI, D, D, CHI, D, D).permute(2, 5, 1, 4, 0, 3)
        Wk = a.permute(0, 3, 4, 1, 2).reshape(d * D * D, D * D).contiguous()
        WbT = a.permute(0, 2, 1, 3, 4).reshape(d * D * D, D * D).contiguous()
        geo = _DLGeom(nj=CHI, ni=CHI, xs=(ctypes.c_int64 * 6)(*X6.stride()),
                      os=(ctypes.c_int64 * 6)(*out.stride()),
                      order=(ctypes.c_int32 * 5)(*store_order(out)), d=d, D=D,
                      vec=int(vector_rows(X6)), bulk=int(bulk_runs(out)))
        check(geo.vec == 1 and geo.bulk == 1, "K1 timed on 16-byte copies of X's padded rows "
              "and bulk stores of M2's padded rows, as in the move")
        calls = {}
        if with_parent and ("double_layer.cu", "parent") in libs:
            def parent_layers(f=getattr(libs["double_layer.cu", "parent"],
                                        f"tpeps_double_layer_{sfx}")):
                f.argtypes = (ctypes.c_void_p,) * 6
                err = f(Wk.data_ptr(), WbT.data_ptr(), X6.data_ptr(), out.data_ptr(),
                        ctypes.byref(geo), stream())
                if err:
                    fail(f"parent double_layer launch: CUDA error {err}")
            calls["parent"] = parent_layers
        elif with_parent:
            q = torch.empty((d, D, D, D, CHI, D, CHI), dtype=dtype, device=dev)
            Wb = a.permute(3, 4, 0, 1, 2).reshape(D * D, d * D * D).contiguous()
            Xk = X6.permute(3, 0, 1, 2, 4, 5)
            qb = q.permute(0, 5, 3, 1, 2, 4, 6)
            g_ket, g_bra = parent_layer_geom(Wk, Xk, q, 2), parent_layer_geom(Wb, qb, out, 3)
            fn = getattr(libs["layer_contract.cu", "parent"], f"tpeps_layer_contract_{sfx}")
            fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_void_p)

            def parent_layers(fn=fn, Wk=Wk, Wb=Wb, Xk=Xk, q=q, g_ket=g_ket, g_bra=g_bra):
                for W, X, Y, g in ((Wk, Xk, q, g_ket), (Wb, qb, out, g_bra)):
                    err = fn(W.data_ptr(), X.data_ptr(), Y.data_ptr(), ctypes.byref(g), 0,
                             stream())
                    if err:
                        fail(f"parent layer_contract launch: CUDA error {err}")
            calls["parent"] = parent_layers
        for key, label in ABLATIONS["double_layer.cu"].items():
            def call(f=getattr(libs["double_layer.cu", key], f"tpeps_double_layer_{sfx}")):
                err = f(Wk.data_ptr(), WbT.data_ptr(), X6.data_ptr(), out.data_ptr(),
                        ctypes.byref(geo), stream())
                if err:
                    fail(f"double_layer launch: CUDA error {err}")
            calls[label] = call
        calls["torch.einsum"] = lambda a=a, X6=X6: torch.einsum("suler,svmfg,lmjuvi->jefirg",
                                                               a, a, X6)
        # about the same bytes moved by one plain contiguous copy (X read, written)
        flat = torch.empty(Xbuf.numel(), dtype=dtype, device=dev)
        calls["contiguous copy of X (torch)"] = lambda Xbuf=Xbuf, flat=flat: flat.copy_(
            Xbuf.view(-1))
        # the whole kernel on 8-byte copies of the same rows, and on X with
        # its unpadded odd pitch (rows 8-byte aligned)
        geo8 = _DLGeom.from_buffer_copy(geo)
        geo8.vec = 0
        geo_el = _DLGeom.from_buffer_copy(geo)
        geo_el.bulk = 0
        Xodd = torch.randn(D, D, CHI, D, D, CHI, generator=gen, device=dev, dtype=dtype)
        geo_odd = _DLGeom.from_buffer_copy(geo8)
        geo_odd.xs = (ctypes.c_int64 * 6)(*Xodd.stride())
        for label, X, g in (("whole, 8-byte copies", X6, geo8),
                            ("whole, unpadded X (8-byte copies)", Xodd, geo_odd),
                            ("whole, stores element by element", X6, geo_el)):
            def call(f=getattr(libs["double_layer.cu", 0], f"tpeps_double_layer_{sfx}"), X=X,
                     g=g):
                err = f(Wk.data_ptr(), WbT.data_ptr(), X.data_ptr(), out.data_ptr(),
                        ctypes.byref(g), stream())
                if err:
                    fail(f"double_layer launch: CUDA error {err}")
            calls[label] = call
        if with_parent:
            calls["parent, again"] = calls["parent"]
        label = f"double_layer {sfx} D={D} chi={CHI}"
        rec[label] = ms = in_turns(calls, 3, 2)
        print(f"  {label}: " + ", ".join(f"{v} {t:.3f} ms" for v, t in ms.items()), flush=True)
        del X6, Xbuf, Xodd, out, flat, calls
        # K2
        M2.copy_(torch.randn(n, n, generator=gen, device=dev, dtype=dtype))
        M2c = M2.contiguous()
        P = torch.randn(n, CHI, generator=gen, device=dev, dtype=dtype)
        Y = torch.empty(n, CHI, dtype=dtype, device=dev)
        calls = {}
        if with_parent and not hasattr(libs["corner_apply.cu", "parent"],
                                       "tpeps_corner_apply_scratch_f64"):
            fp = getattr(libs["corner_apply.cu", "parent"], f"tpeps_corner_apply_{sfx}")
            fp.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

            def parent_k2(fp=fp):  # a parent whose K2 takes a contiguous M2, no scratch
                err = fp(M2c.data_ptr(), P.data_ptr(), Y.data_ptr(), n, CHI, stream())
                if err:
                    fail(f"parent corner_apply launch: CUDA error {err}")
            calls["parent"] = parent_k2
        elif with_parent:
            calls["parent"] = k2_caller(libs["corner_apply.cu", "parent"], M2, P, Y, stream)
        keys = ABLATIONS["corner_apply.cu"] if dtype == torch.float64 else {0: "whole"}
        for key, klabel in keys.items():
            calls[klabel] = k2_caller(libs["corner_apply.cu", key], M2, P, Y, stream)
        calls["torch.matmul"] = lambda P=P: torch.matmul(M2, P)
        if with_parent:
            calls["parent, again"] = calls["parent"]
        label = f"corner_apply {sfx} {n} x {n} by {n} x {CHI}"
        if dtype == torch.float64:
            scratch = libs["corner_apply.cu", 0].tpeps_corner_apply_scratch_f64(n, CHI)
            label += f" (scratch {scratch} doubles)"
        rec[label] = ms = in_turns(calls, 5, 2)
        print(f"  {label}: " + ", ".join(f"{v} {t:.3f} ms" for v, t in ms.items()), flush=True)
        del M2, M2c, P, Y
    return rec


# phase 2's K2 shapes: (n, m, M2's rows padded to an even pitch)
K2_SHAPES = ((CHI * D * D, CHI, True), (CHI * D * D, CHI, False), (CHI * D * D, CHI + 8, True),
             ((CHI + 8) * D * D, CHI + 8, True), (EIGH_BIG * D * D, EIGH_BIG, True),
             (EIGH_BIG * D * D, 177, True), (1000, 33, False))
# the parent's first K2 float32 C entry (no scratch, no counters)
PARENT_K2_F32_ARGS = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def k2_caller(lib, M2, P, Y, stream):
    """A call of ``lib``'s K2 C entry for ``Y = M2 @ P`` in P's dtype (a
    parent whose float32 entry takes no scratch: its own arguments)."""
    from tpeps_torch.kernels import ARRIVAL_COUNTERS

    sfx = "f64" if P.dtype == torch.float64 else "f32"
    n, m = P.shape
    fn = getattr(lib, f"tpeps_corner_apply_{sfx}")
    if not hasattr(lib, f"tpeps_corner_apply_scratch_{sfx}"):
        fn.argtypes = PARENT_K2_F32_ARGS

        def call():
            err = fn(M2.data_ptr(), M2.stride(0), P.data_ptr(), Y.data_ptr(), n, m, stream())
            if err:
                fail(f"corner_apply {sfx} launch: CUDA error {err}")
        return call
    scratch = getattr(lib, f"tpeps_corner_apply_scratch_{sfx}")(n, m)
    if scratch < 0:
        fail(f"corner_apply {sfx} scratch query: CUDA error {-scratch}")
    part = torch.empty(max(scratch, 1), dtype=P.dtype, device=P.device)
    counters = torch.zeros(ARRIVAL_COUNTERS, dtype=torch.int32, device=P.device)

    def call():
        err = fn(M2.data_ptr(), M2.stride(0), P.data_ptr(), Y.data_ptr(), part.data_ptr(),
                 part.numel(), counters.data_ptr(), counters.numel(), n, m, stream())
        if err:
            fail(f"corner_apply {sfx} launch: CUDA error {err}")
    return call


def ablate_corner(libs, in_turns, stream, dev, parent) -> dict:
    """:func:`ablate`'s part for K2's float32 kernel: at every phase-2 shape
    (:data:`K2_SHAPES`) this checkout's kernel, the parent's (first and last,
    ``parent`` given) and ``torch.matmul`` in float32 (TF32 off) in CUDA
    graphs; at the move's shape (7203 x 7203 by 147, M2's pitch padded) also
    every timing copy (:data:`K2F32_COPIES`), each copy's relative error to
    the twin printed (the one-product and one-sum copies compute; the
    others do not).  The first call of this checkout's kernel and of the
    parent's is held to the twin (1e-5 relative).  With ``parent`` also the
    float64 kernel against the parent's at the move's shape: the same bits,
    timed beside it."""
    gen = torch.Generator(device=dev).manual_seed(18)
    rec = {}
    for n, m, pad in K2_SHAPES:
        M2 = torch.randn(n, n + (n % 2 if pad else 0), generator=gen, device=dev,
                         dtype=torch.float32)[:, :n]
        P = torch.randn(n, m, generator=gen, device=dev, dtype=torch.float32)
        Y = torch.empty(n, m, dtype=torch.float32, device=dev)
        ref = M2 @ P
        keys = [("parent", "parent")] if parent is not None else []
        move_shape = (n, m, pad) == K2_SHAPES[0]
        keys += list(K2F32_COPIES.items()) if move_shape else [(0, "whole")]
        calls, errs = {}, {}
        for key, label in keys:
            call = k2_caller(libs["corner_apply.cu", key], M2, P, Y, stream)
            Y.fill_(math.nan)
            call()
            errs[label] = rel_err(Y, ref)
            if key in ("parent", 0):
                check(errs[label] <= TOL[torch.float32],
                      f"K2 float32 ({label}) n={n} m={m} pitch {M2.stride(0)}: rel err "
                      f"{errs[label]:.2e} <= 1e-5")
            calls[label] = call
        calls["torch.matmul"] = lambda M2=M2, P=P: torch.matmul(M2, P)
        if parent is not None:
            calls["parent, again"] = calls["parent"]
        label = f"corner_apply f32 {n} x {n} by {n} x {m}, pitch {M2.stride(0)}"
        ms = in_turns(calls, 5, 2)
        rec[label] = {"ms": ms, "rel_err": errs}
        print(f"  {label} (CUDA graphs): " + ", ".join(f"{v} {t:.4f} ms" for v, t in ms.items())
              + "; rel err " + ", ".join(f"{v} {e:.1e}" for v, e in errs.items()), flush=True)
        del M2, P, Y, ref, calls
    if parent is not None:
        n, m = CHI * D * D, CHI
        M2 = torch.randn(n, n + 1, generator=gen, device=dev, dtype=torch.float64)[:, :n]
        P = torch.randn(n, m, generator=gen, device=dev, dtype=torch.float64)
        Ys = {k: torch.empty(n, m, dtype=torch.float64, device=dev) for k in ("parent", 0)}
        calls = {("parent" if k == "parent" else "whole"):
                 k2_caller(libs["corner_apply.cu", k], M2, P, Ys[k], stream) for k in Ys}
        for call in calls.values():
            call()
        check(torch.equal(Ys["parent"], Ys[0]), f"K2 float64 {n} x {n} by {n} x {m}: the same "
                                                "bits as the parent's kernel")
        calls["parent, again"] = calls["parent"]
        ms = in_turns(calls, 5, 2)
        rec[f"corner_apply f64 {n} x {n} by {n} x {m}"] = {"ms": ms}
        print(f"  corner_apply f64 {n} x {n} by {n} x {m} (CUDA graphs): "
              + ", ".join(f"{v} {t:.4f} ms" for v, t in ms.items()), flush=True)
    return rec


def ablate_adjoint(libs, in_turns, stream, dev, parent) -> dict:
    """:func:`ablate`'s part for K9's ``adjoint_commit`` in CUDA graphs, f64:
    at the C4v D=8 adjoint's sizes (site 1,126, C 4,715, T 232,886; fresh
    buffers, as that adjoint passes) and at a 2-site-sized one (2,252 site
    entries, the 2-site env's 1,989,344 cut at an odd 37,721, uT a view off
    its 16-byte boundary, as the generic adjoint passes), the parent's first
    and last, this checkout's between (:data:`ADJ_COPIES`).  The first call
    of each is held to the twin (da bit-exact, delta <= 1e-12, ctl
    bit-exact); the timing states never end (u repeats: delta never grows)."""
    from tpeps_torch.kernels import frozen as kfrozen

    gen = torch.Generator(device=dev).manual_seed(19)
    rnd = lambda n: torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    part = torch.empty(4096, dtype=torch.float64, device=dev)
    keys = ([("parent", "parent")] if parent is not None else []) + list(ADJ_COPIES.items())
    rec = {}
    for label, (na, nC, nT, one_buffer) in {"C4v D=8": (1126, 4715, 232886, False),
                                            "2-site-sized": (2252, 37721, 1951623, True)}.items():
        da_i = rnd(na)
        if one_buffer:
            v = rnd(nC + nT)
            uC, uT = v[:nC], v[nC:]
        else:
            uC, uT = rnd(nC), rnd(nT)
        calls, da0 = {}, rnd(na)
        for key, klabel in keys:
            fn = libs["frozen_commit.cu", key].tpeps_adjoint_commit_f64
            st = kfrozen.adjoint_state(da0, uC, uT, 10**9, 0.0)
            st = kfrozen.AdjointState(da0.clone(), st.scal, st.ctl)

            def call(fn=fn, st=st):
                return fn(st.da.data_ptr(), da_i.data_ptr(), na, uC.data_ptr(), nC,
                          uT.data_ptr(), nT, st.scal.data_ptr(), st.ctl.data_ptr(),
                          part.data_ptr(), stream())
            err = call()
            if err:
                fail(f"adjoint_commit ({klabel}) launch: CUDA error {err}")
            tw = kfrozen.adjoint_state(da0, uC, uT, 10**9, 0.0)
            tw = kfrozen.AdjointState(da0.clone(), tw.scal, tw.ctl)
            kfrozen.adjoint_commit_twin(tw, da_i, uC, uT)
            e = rel_err(st.scal[:1], tw.scal[:1])
            check(torch.equal(st.da, tw.da) and torch.equal(st.ctl, tw.ctl)
                  and e <= TOL[torch.float64],
                  f"adjoint_commit ({klabel}) {label}: the first call is the twin's (da, "
                  f"ctl bit-exact, delta rel err {e:.1e})")

            def timed(call=call):
                if call():
                    fail("adjoint_commit launch failed")
            calls[klabel] = timed
        if parent is not None:
            calls["parent, again"] = calls["parent"]
        ms = in_turns(calls, 20, 5)
        b_ms, _ = bound(8 * (3 * na + nC + nT), na + 2 * (nC + nT), FP64_CC)
        rec[f"adjoint_commit f64 {label}"] = {"ms": ms, "bound_ms": b_ms, "entries": [na, nC, nT]}
        print(f"  adjoint_commit f64 {label} (site {na}, C {nC}, T {nT} entries): "
              + ", ".join(f"{v} {t * 1000:.2f} us" for v, t in ms.items())
              + f"; bound {b_ms * 1000:.2f} us", flush=True)
    return rec


MIXED_CODE = r"""
import json, time, numpy as np, torch
from tpeps_torch.ctm.c4v import move_factored as mf
from tpeps_torch.ctm.c4v.env import init_env
from tpeps_torch.ctm.c4v.move_graph import CHAIN_CONV_TOL, CHAIN_MAX_ITER, MoveGraph
from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
from tpeps_torch.kernels import LAUNCHES
torch.backends.cuda.matmul.allow_tf32 = False
dev, D, chi = torch.device("cuda", 0), 7, 147
x = np.random.RandomState(0).rand(2, D, D, D, D) - 0.5
a = symmetrize_c4v(torch.as_tensor(x, dtype=torch.float64), normalize=True).to(dev)
env = init_env(a, chi, "CTMRG")
orig, k2 = mf.run_ctmrg, []
def counted(*args, **kw):
    before = LAUNCHES["corner_apply"]
    out = orig(*args, **kw)
    k2.append(LAUNCHES["corner_apply"] - before)
    return out
mf.run_ctmrg = counted
runs = []
for _ in range(2):
    stats, k2[:] = [], []
    mf.run_ctmrg_mixed(a, env, max_iter=48, conv_tol=1e-8, slice_phys=True, moves_per_sync=4,
                       stats=stats)
    runs.append([{"phase": st["phase"], "moves": st["moves"], "seconds": st["seconds"],
                  "ms_per_move": 1000 * st["seconds"] / max(st["moves"], 1),
                  "corner_apply_launches": n} for st, n in zip(stats, k2)])
a32 = a.float()
g = MoveGraph(a32, chi, n_moves=4)
g.load(a32, env.C.float(), mf.to_int_layout(env.T, D).float(),
       mf.cold_start_basis(chi * D * D, chi, torch.float32, dev), max_iter=CHAIN_MAX_ITER,
       conv_tol=CHAIN_CONV_TOL)
g.run()
g.run()
torch.cuda.synchronize()
ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
ev[0].record()
for _ in range(5):
    g.run()
ev[1].record()
ev[1].synchronize()
print("MIXED " + json.dumps({"runs": runs,
                             "graphed_f32_ms_per_move": ev[0].elapsed_time(ev[1]) / 20}))
"""


def mixed_compare(parent) -> dict:
    """``run_ctmrg_mixed`` with bench_case's arguments (phase 7(e), twice:
    the first run captures its graphs) by phase (moves, host ms/move, K2's
    launches) and the graphed float32 move (a MoveGraph of 4), in the
    parent's checkout and in this one, in turns (parent, change, change,
    parent), each in a process of its own (:data:`MIXED_CODE`)."""
    out = {}
    here = Path(__file__).resolve().parent
    for i, (label, cwd) in enumerate((("parent", Path(parent)), ("change", here),
                                      ("change", here), ("parent", Path(parent)))):
        proc = subprocess.run([sys.executable, "-c", MIXED_CODE], cwd=cwd, capture_output=True,
                              text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MIXED ")]
        check(proc.returncode == 0 and bool(line),
              f"mixed driver in {label}'s checkout: rc {proc.returncode} {proc.stderr[-2000:]}")
        r = json.loads(line[-1][6:])
        out[f"{label} {i}"] = r
        print(f"  mixed driver ({label}): graphed f32 move {r['graphed_f32_ms_per_move']:.3f} "
              "ms/move; phases " + "; ".join(
                  ", ".join(f"{p['phase']} {p['moves']} moves {p['ms_per_move']:.2f} ms/move "
                            f"(K2 {p['corner_apply_launches']})" for p in run)
                  for run in r["runs"]), flush=True)
    return out


def parent_gemm_tiles(m, n) -> np.ndarray:
    """The parent's ``block_gemm`` tile list (one size for all: 64 x 64 tiles
    of blocks at least 16 wide, else 128 elements a tile), for timing its
    kernel on this checkout's tables."""
    m, n = np.asarray(m, np.int64), np.asarray(n, np.int64)
    big = (m >= 16) & (n >= 16)
    ncol = (n + 63) // 64
    nt = np.where(big, (m + 63) // 64 * ncol, (m * n + 127) // 128)
    o = np.repeat(np.arange(len(m)), nt)
    local = np.arange(int(nt.sum())) - np.repeat(np.cumsum(nt) - nt, nt)
    kind = big[o]
    r0 = np.where(kind, (local // ncol[o]) * 64, local * 128)
    c0 = np.where(kind, (local % ncol[o]) * 64, 0)
    return np.stack([o, kind, r0, c0], axis=1).astype(np.int32)


def ablate_k8(libs, in_turns, stream, dev, with_parent) -> dict:
    """:func:`ablate`'s part for K8 at the D=8 U(1) C4v shapes (phase 8's
    state after its warm-up moves): ``block_gemm`` on each of a dynamic
    move's ten tensordots and on the twenty backward tables of a frozen
    move's, ``block_permute`` on the largest operand's table and its inverse,
    each through this checkout's ``block_sparse.cu`` and, with the parent, its kernel
    on its own tile list and table layout (first and last in the turns),
    in CUDA graphs; the permutes beside their twin."""
    from tpeps_torch.ctm.c4v_abelian import ctmrg as ab_ctmrg
    from tpeps_torch.ctm.c4v_abelian import frozen as ab_frozen
    from tpeps_torch.ctm.c4v_abelian.env import init_env as ab_init_env
    from tpeps_torch.kernels import blocksparse

    vp, ci, c64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    st = ab_state(AB_AUX, dev)
    a = st.site((0, 0))
    env = ab_init_env(st, AB_CHI)
    for _ in range(AB_WARM_MOVES):
        env = ab_ctmrg.ctm_move_sl(a, env, AB_PK)
    keep = ab_frozen.freeze_from_env(env)
    C, T = ab_frozen.close_structure(a, env.C, env.T, dict(keep))
    _, calls = record_dots(lambda: ab_ctmrg.ctm_move_sl(a, env, AB_PK))
    _, fcalls = record_dots(lambda: ab_frozen._move_raw(a, C, T, dict(keep)))
    mine = {ABLATIONS["block_sparse.cu"][key]: lib for (src, key), lib in libs.items()
            if src == "block_sparse.cu" and key != "parent"}
    parent = libs.get(("block_sparse.cu", "parent")) if with_parent else None
    if parent is not None:  # the parent's C signatures
        parent.tpeps_block_gemm_f64.argtypes = (vp,) * 12 + (ci, ci, ci, vp)
        parent.tpeps_block_permute_f64.argtypes = (vp,) * 9 + (ci, ci, c64, vp)
    gen = torch.Generator(device=dev).manual_seed(9)
    rnd = lambda n: torch.rand(n, generator=gen, device=dev, dtype=torch.float64) - 0.5  # noqa

    def gemm_calls(t, lhs, rhs, out):
        tt = t.on(dev)
        cnt, scr = blocksparse.workspace(dev, out.dtype, t)
        fns = {}
        if parent is not None:
            ptiles = torch.from_numpy(parent_gemm_tiles(t.ob_m, t.ob_n)).to(dev)

            def f_parent(ptiles=ptiles):
                err = parent.tpeps_block_gemm_f64(
                    lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), tt["ob_off"].data_ptr(),
                    tt["ob_m"].data_ptr(), tt["ob_n"].data_ptr(), tt["ob_ptr"].data_ptr(),
                    tt["pr_a"].data_ptr(), tt["pr_b"].data_ptr(), tt["pr_k"].data_ptr(),
                    tt["pr_s"].data_ptr(), ptiles.data_ptr(), len(ptiles), int(t.trans_a),
                    int(t.trans_b), stream())
                if err:
                    fail(f"parent block_gemm launch: CUDA error {err}")
            fns["parent"] = f_parent
        for label, lib in mine.items():
            def f(lib=lib):
                err = lib.tpeps_block_gemm_f64(
                    lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(), tt["ob_off"].data_ptr(),
                    tt["ob_m"].data_ptr(), tt["ob_n"].data_ptr(), tt["ob_ptr"].data_ptr(),
                    tt["pr_a"].data_ptr(), tt["pr_b"].data_ptr(), tt["pr_k"].data_ptr(),
                    tt["pr_s"].data_ptr(), tt["tiles"].data_ptr(), tt["units"].data_ptr(),
                    tt["grp_base"].data_ptr(), tt["grp_n"].data_ptr(), cnt.data_ptr(),
                    scr.data_ptr(), t.ntiles, t.kinds, int(t.trans_a), int(t.trans_b), stream())
                if err:
                    fail(f"block_gemm launch: CUDA error {err}")
            fns[label] = f
        if parent is not None:
            fns["parent, again"] = fns["parent"]
        return fns

    def permute_calls(t, src, dst):
        tt = t.on(dev)
        fns = {}
        if parent is not None:
            old = {f: torch.from_numpy(np.ascontiguousarray(getattr(t, f))).to(dev)
                   for f in ("soff", "doff", "shape", "sstr", "dstr")}
            sizes = t.shape.astype(np.int64).prod(axis=1)  # its per-element search table
            old["ecum"] = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])).to(dev)
            sc = None if t.scale is None else torch.from_numpy(t.scale).to(dev)

            def f_parent(old=old, sc=sc):
                err = parent.tpeps_block_permute_f64(
                    src.data_ptr(), dst.data_ptr(), old["ecum"].data_ptr(),
                    old["soff"].data_ptr(), old["doff"].data_ptr(), old["shape"].data_ptr(),
                    old["sstr"].data_ptr(), old["dstr"].data_ptr(),
                    None if sc is None else sc.data_ptr(), t.nblk, t.rank, t.total, stream())
                if err:
                    fail(f"parent block_permute launch: CUDA error {err}")
            fns["parent"] = f_parent
        for label, lib in mine.items():
            def f(lib=lib):
                err = lib.tpeps_block_permute_f64(
                    src.data_ptr(), dst.data_ptr(), tt["c_soff"].data_ptr(),
                    tt["c_doff"].data_ptr(), tt["c_meta"].data_ptr(),
                    tt["c_scale"].data_ptr() if "c_scale" in tt else None,
                    tt["tile_ptr"].data_ptr(), t.ntiles, t.rank, stream())
                if err:
                    fail(f"block_permute launch: CUDA error {err}")
            fns[label] = f
        fns["twin"] = lambda: blocksparse.block_permute_twin(src, dst, t)
        if parent is not None:
            fns["parent, again"] = fns["parent"]
        return fns

    def timed(name, fns, out, bound_ms, classes=""):
        ref = None
        for label, f in fns.items():  # every copy and the parent give the same result
            out.fill_(7.0)
            f()
            if ref is None:
                ref = out.clone()
            else:
                check(rel_err(out, ref) <= TOL[torch.float64],
                      f"{name}: {label} agrees with {next(iter(fns))}")
        ms = in_turns(fns, 10, 5)
        print(f"  K8 {name}{classes}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" ms; bound {bound_ms:.4f}", flush=True)
        return {**ms, "bound_ms": bound_ms}

    rec, sums = {}, {}

    def add(group, ms):
        acc = sums.setdefault(group, {})
        for k, v in ms.items():
            acc[k] = acc.get(k, 0.0) + v

    big = None
    for i, (x, y, axes, out_like) in enumerate(calls):
        plan, A, B = x.dot_operands(y, axes, out_like)
        t = plan.gemm
        out = torch.empty(plan.out.numel, dtype=A.dtype, device=dev)
        fl, el = t.work()
        cls = ", ".join(f"{blocksparse.CLASS_NAMES[c]} {int((t.ob_kind == c).sum())}"
                        for c in np.unique(t.ob_kind))
        r = timed(f"tensordot {i + 1}", gemm_calls(t, A, B, out), out,
                  bound(8 * el, fl, FP64_TC)[0], f" ({cls})")
        rec[f"block_gemm tensordot {i + 1}"] = r
        add("the move's 10 tensordots", r)
        for src, p in ((x, plan.perm_a), (y, plan.perm_b)):
            if p is not None and (big is None or p.total > big[1].total):
                big = (src, p)
    for i, (x, y, axes, out_like) in enumerate(fcalls):
        plan, A, B = x.dot_operands(y, axes, out_like)
        G = rnd(plan.out.numel)
        ta, tb = plan.gemm.grad_tables()
        for side, t, lhs, rhs, n in (("dA", ta, G, B, A.numel()), ("dB", tb, A, G, B.numel())):
            out = torch.zeros(n, dtype=A.dtype, device=dev)
            fl, el = t.work()
            cls = ", ".join(f"{blocksparse.CLASS_NAMES[c]} {int((t.ob_kind == c).sum())}"
                            for c in np.unique(t.ob_kind))
            r = timed(f"{side} table of tensordot {i + 1}", gemm_calls(t, lhs, rhs, out), out,
                      bound(8 * el, fl, FP64_TC)[0], f" ({cls})")
            rec[f"block_gemm {side} table {i + 1}"] = r
            add("a frozen move's 20 backward tables", r)
            if side == "dB" and set(np.unique(t.ob_kind)) == {blocksparse.SPLIT}:
                add("the four dB tables of the skinny tensordots", r)
        del G
    src, p = big
    out = torch.empty(p.total, dtype=src.data.dtype, device=dev)
    rec["block_permute largest operand"] = timed(
        f"block_permute, the largest operand ({p.nblk} blocks, {p.total} entries)",
        permute_calls(p, src.data, out), out, 2 * 8 * p.total / HBM_BPS * 1e3)
    g = rnd(p.total)
    out = torch.zeros(src.data.numel(), dtype=src.data.dtype, device=dev)
    rec["block_permute inverse"] = timed("block_permute, its inverse table",
                                         permute_calls(p.inverse(), g, out), out,
                                         2 * 8 * p.total / HBM_BPS * 1e3)
    for group, acc in sums.items():
        print(f"  K8 {group}: " + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()) + " ms")
        rec[f"sum: {group}"] = acc
    return rec


K8_MOVE_CODE = r"""
import json, time, torch
from tpeps_torch.ctm.c4v_abelian import ctmrg, frozen
from tpeps_torch.ctm.c4v_abelian.env import init_env
from tpeps_torch.ipeps.ipeps_abelian import random_c4v_abelian
from tpeps_torch.sym.tensor import AbelianTensor, leg, plan_cache_stats
torch.backends.cuda.matmul.allow_tf32 = False
dev, sync = torch.device("cuda", 0), torch.cuda.synchronize
PK = dict(svd_reltol=1e-12, eps_multiplet=1e-12)
st = random_c4v_abelian(torch.Generator().manual_seed(0), "U1", leg({-1: 1, 1: 1}),
                        leg({-2: 1, -1: 2, 0: 2, 1: 2, 2: 1}), 1).to(dev)
a = st.site((0, 0))
env = init_env(st, 160)
first = []
for _ in range(4):  # the first dynamic moves build their plans as they go
    b0 = plan_cache_stats()["build_seconds"]
    sync()
    t0 = time.perf_counter()
    prev, env = env, ctmrg.ctm_move_sl(a, env, PK)
    sync()
    first.append((time.perf_counter() - t0, plan_cache_stats()["build_seconds"] - b0))
cached = []
for _ in range(3):  # the last move again: every plan cached
    sync()
    t0 = time.perf_counter()
    ctmrg.ctm_move_sl(a, prev, PK)
    sync()
    cached.append(time.perf_counter() - t0)
keep = frozen.freeze_from_env(env)
C, T = frozen.close_structure(a, env.C, env.T, dict(keep))
frozen.run_frozen(a, C, T, dict(keep), max_iter=1, conv_tol=0.0)
sync()
t0 = time.perf_counter()
frozen.run_frozen(a, C, T, dict(keep), max_iter=3, conv_tol=0.0)
sync()
frozen_ms = (time.perf_counter() - t0) / 3 * 1e3
leaves = [x.data.detach().requires_grad_() for x in (a, C, T)]
sync()
t0 = time.perf_counter()
with torch.enable_grad():
    yC, yT = frozen.move_frozen(*(AbelianTensor._flat(x, x.struct, v) for x, v in
                                  zip((a, C, T), leaves)), dict(keep), 1e-12, sg_norm=False)
sync()
graph_ms = (time.perf_counter() - t0) * 1e3
gen = torch.Generator(device=dev).manual_seed(1)
u = [torch.rand(y.data.shape, generator=gen, device=dev, dtype=torch.float64) - 0.5
     for y in (yC, yT)]
vjp = []
for _ in range(3):  # an adjoint iteration: the move's VJP on the built graph
    sync()
    t0 = time.perf_counter()
    torch.autograd.grad([yC.data, yT.data], leaves, grad_outputs=u, retain_graph=True,
                        allow_unused=True)
    sync()
    vjp.append((time.perf_counter() - t0) * 1e3)
print("K8MOVE " + json.dumps({
    "first_4_dynamic_moves_ms": [1e3 * w for w, _ in first],
    "host_planning_ms_per_move": [1e3 * p for _, p in first],
    "plans_built_s": sum(p for _, p in first),
    "cached_dynamic_move_ms": 1e3 * min(cached), "frozen_move_ms": frozen_ms,
    "frozen_move_graph_ms": graph_ms, "adjoint_iteration_ms": min(vjp)}))
"""


def k8_move_compare(parent) -> dict:
    """A frozen move, a cached dynamic move and an adjoint iteration (the
    move's VJP on its built graph) at phase 8's D=8 state, and the host
    planning of the first four dynamic moves (an empty plan cache), in the
    parent's checkout and in this one, in turns (parent, change, change,
    parent), each in a process of its own (:data:`K8_MOVE_CODE`)."""
    out = {}
    here = Path(__file__).resolve().parent
    for i, (label, cwd) in enumerate((("parent", Path(parent)), ("change", here),
                                      ("change", here), ("parent", Path(parent)))):
        proc = subprocess.run([sys.executable, "-c", K8_MOVE_CODE], cwd=cwd, capture_output=True,
                              text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("K8MOVE ")]
        check(proc.returncode == 0 and bool(line),
              f"K8 moves in {label}'s checkout: rc {proc.returncode} {proc.stderr[-2000:]}")
        r = json.loads(line[-1][7:])
        out[f"{label} {i}"] = r
        print(f"  K8 moves ({label}): frozen move {r['frozen_move_ms']:.2f} ms, cached dynamic "
              f"move {r['cached_dynamic_move_ms']:.2f} ms, adjoint iteration "
              f"{r['adjoint_iteration_ms']:.2f} ms (the move's graph built in "
              f"{r['frozen_move_graph_ms']:.2f} ms); first 4 dynamic moves "
              + ", ".join(f"{x:.1f}" for x in r["first_4_dynamic_moves_ms"])
              + " ms, of them host planning "
              + ", ".join(f"{x:.1f}" for x in r["host_planning_ms_per_move"])
              + f" ms, plans built in {r['plans_built_s']:.2f} s", flush=True)
    return out


# the first 48 eager D=7 chi=147 f64 moves from the cold start (the second of
# two such runs: the first builds and warms up), then one eager move's peak
# memory and time, and the graphed move's (MoveGraph, 4 moves a replay): run
# in a checkout's root by move_compare
MOVE_CODE = r"""
import json, time, numpy as np, torch
from tpeps_torch.ctm.c4v import move_factored as mf
from tpeps_torch.ctm.c4v.env import init_env
from tpeps_torch.ctm.c4v.move_graph import CHAIN_CONV_TOL, CHAIN_MAX_ITER, MoveGraph
from tpeps_torch.ipeps.ipeps_c4v import symmetrize_c4v
torch.backends.cuda.matmul.allow_tf32 = False
dev, D, chi = torch.device("cuda", 0), 7, 147
x = np.random.RandomState(0).rand(2, D, D, D, D) - 0.5
a = symmetrize_c4v(torch.as_tensor(x, dtype=torch.float64), normalize=True).to(dev)
env = init_env(a, chi, "CTMRG")
ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
for _ in range(2):
    C, T, W = env.C, mf.to_int_layout(env.T, D), None
    P = mf.cold_start_basis(chi * D * D, chi, a.dtype, dev)
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(48):
        C, T, _, P, W = mf.ctm_move_w(a, C, T, P, W)
    ev[1].record()
    ev[1].synchronize()
cold = ev[0].elapsed_time(ev[1])
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
mf.ctm_move_w(a, C, T, P, W)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated() - base
ev[0].record()
for _ in range(4):
    mf.ctm_move_w(a, C, T, P, W)
ev[1].record()
ev[1].synchronize()
eager = ev[0].elapsed_time(ev[1]) / 4
g = MoveGraph(a, chi, n_moves=4)
g.load(a, C, T, P, max_iter=CHAIN_MAX_ITER, conv_tol=CHAIN_CONV_TOL, W=W)
g.run()
torch.cuda.synchronize()
ev[0].record()
for _ in range(5):
    g.run()
ev[1].record()
ev[1].synchronize()
print("MOVE " + json.dumps({"peak_bytes_above_state": peak, "eager_ms_per_move": eager,
                            "cold_start_48_moves_ms": cold,
                            "graphed_ms_per_move": ev[0].elapsed_time(ev[1]) / 20}))
"""


def move_compare(parent) -> dict:
    """The first 48 moves from the cold start, the graphed and the eager
    factored move and its peak memory, in the parent's checkout and in this
    one, in turns (parent, change, change, parent), each in a process of its
    own (:data:`MOVE_CODE`)."""
    out = {}
    here = Path(__file__).resolve().parent
    for i, (label, cwd) in enumerate((("parent", Path(parent)), ("change", here),
                                      ("change", here), ("parent", Path(parent)))):
        proc = subprocess.run([sys.executable, "-c", MOVE_CODE], cwd=cwd, capture_output=True,
                              text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MOVE ")]
        check(proc.returncode == 0 and bool(line),
              f"move in {label}'s checkout: rc {proc.returncode} {proc.stderr[-2000:]}")
        r = json.loads(line[-1][5:])
        out[f"{label} {i}"] = r
        print(f"  move ({label}): first 48 moves from the cold start "
              f"{r['cold_start_48_moves_ms']:.2f} ms, graphed {r['graphed_ms_per_move']:.3f} ms/move, eager "
              f"{r['eager_ms_per_move']:.3f} ms/move, peak {r['peak_bytes_above_state'] / 2**20:.1f}"
              " MiB above the state", flush=True)
    return out


def main() -> None:
    laps = [0.0]

    def lap(n):  # the script's seconds so far, at the end of phase n, and the phase's own
        now = time.perf_counter() - T_START
        print(f"  phase {n} ended at {now:.1f} s, took {now - laps[-1]:.1f} s", flush=True)
        laps.append(now)

    smi = phase0()
    dev = torch.device("cuda", 0)
    phase1()
    lap(1)
    rec = phase2(dev)
    rec.update(phase2_large_d(dev))
    lap(2)
    counts_fwd, a7, env7 = phase3(dev)
    lap(3)
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
    rec["adjoint_commit"]["generic"] = rec.pop("adjoint_commit_generic")
    lap(10)
    counts_obs = phase11(dev, a7, env7)
    del a7, env7
    lap(11)
    rec["corner_apply"]["f32"]["mixed_driver_phases"] = MIXED_PHASES
    rec["polar_unitary"]["steps_by_run"] = K6_STEPS
    rec["polar_unitary"]["dropped_w_by_run"] = K6_DROPPED
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
         "launches_generic_training": cg_train[name],
         "launches_c4v_observables": counts_obs[name], **rec[name]}
        for name in SOURCES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ablate"]:
        args = dict(zip(sys.argv[2::2], sys.argv[3::2]))
        only = args["--only"].split(",") if "--only" in args else None
        print(phase0())
        phase1()
        print(json.dumps({"ablation": ablate(args.get("--parent"), only)}))
    else:
        main()
