#!/usr/bin/env python3
"""Smoke run of the tpeps_torch port on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card and ``nvcc`` (CUDA_HOME, PATH or the toolkit's default
prefix).  It needs no network and no JAX.

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
   what a symmetric result needs.
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
   same start (spectrum <= 1e-11, C and T <= 1e-10); (d) ``MoveGraph``
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
   the dynamic profile against ``keep``), ``converge_frozen`` to 1e-8 or 48
   moves with its energy; (d) D=3, chi=18 card against the CPU twins: 6
   dynamic moves' spectra and the energy (1e-10), 10 frozen moves (C
   elementwise, T's magnitudes elementwise, 1e-10).

Phase 2 also holds the kernels of the large-D slice against their twins at
its shapes: ``eigh_small`` on Rayleigh-Ritz matrices of the D=7 path and on
a dense random matrix of its largest k, 169 (eigenvalues <= 1e-12
relative, residual and orthogonality <= 1e-12), ``ozaki_split`` on
the corner M2 (7203 x 7203), a basis P (7203 x 147) and a layer's operands
(98 x 49, 49 x 1.06M) (digit planes and exponents bit-identical),
``ozaki_gemm`` of M2 P and of the layer (<= 1e-15 relative), ``ctm_commit``
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
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

D, CHI, D_SMALL, CHI_SMALL = 7, 147, 2, 16
MAX_ITER, CONV_TOL, N_POWER = 48, 1e-8, 2
J1, J2 = 1.0, 0.3
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
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
}
FORWARD = ("layer_contract", "corner_apply", "gram_ridge", "gram", "trsm_right_lower_h",
           "t_epilogue", "polar_unitary", "eigh_small")
# the large-D slice (phase 7): the on-card loop and the Ozaki polish
LARGE_D = ("ozaki_split", "ozaki_gemm", "ctm_commit")
OZ_TOL, OZ_MOVE_SPEC_TOL, OZ_MOVE_ENV_TOL = 1e-15, 1e-11, 1e-10
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
AB_CONVERGE_ITER, AB_CONVERGE_TOL = 48, 1e-8
AB_PK = dict(svd_reltol=1e-12, eps_multiplet=1e-12)  # bench.py's projector arguments
AB_SMALL_AUX, AB_SMALL_CHI, AB_SMALL_TOL = {-1: 1, 0: 1, 1: 1}, 18, 1e-10
# the frozen against the dynamic engine over the same 10 moves from the
# frozen start (neither converged): one reading on the H100 gave |dE| 3.3e-6
AB_E_FROZEN_TOL = 1e-4
ABELIAN = ("block_permute", "block_gemm", "frozen_commit")
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
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


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


def phase2(dev) -> dict:
    """Kernel vs twin at the slice's shapes; returns per-kernel records."""
    print(f"== phase 2: kernels vs twins at D={D}, chi={CHI}", flush=True)
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.kernels import cholqr, corner, epilogue, layer, polar

    rec = {}
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
            e = rel_err(cholqr.trsm_right_lower_h(L, Pm), cholqr.trsm_right_lower_h_twin(L, Pm))
            check(e <= tol, f"K3 trsm_right_lower_h {tag}: rel err {e:.2e} <= {tol:.0e}")
            e = rel_err(cholqr.trsm_right_lower(L, Pm), cholqr.trsm_right_lower_twin(L, Pm))
            check(e <= tol, f"K3 trsm_right_lower {tag}: rel err {e:.2e} <= {tol:.0e}")
            e = rel_err(cholqr.gram(Pm, P), cholqr.gram_twin(Pm, P))
            check(e <= tol, f"K3 gram (two operands) {tag}: rel err {e:.2e} <= {tol:.0e}")
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
            del M2, M2b, q, q1
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
        # eigh_small on the Rayleigh-Ritz matrices of an early and a late move
        Hs = {n: rayleigh_ritz_H(a, env.C, T_int, n) for n in (3, 30)}
        for n, H in Hs.items():
            w, V = eigh_small(H, info=info)
            sweeps, conv = info.tolist()[:2]
            e_w, e_r, e_o = eigh_errors(H, w, V, eigh_small_twin(H)[0])
            check((conv == 1 or dev.type == "cpu") and max(e_w, e_r, e_o) <= tol,
                  f"eigh_small on H of move {n + 1}: {sweeps} sweeps, converged={bool(conv)}; "
                  f"eigenvalues rel err {e_w:.2e}, residual {e_r:.2e}, orthogonality {e_o:.2e} "
                  f"<= {tol:.0e}")
        H = Hs[30]
        k = CHI
        time_case(rec, "eigh_small", lambda: torch.sort(eigh_small(H)[0]).values,
                  lambda: eigh_small_twin(H)[0], lambda: torch.linalg.eigh(H),
                  nbytes(H, H) + 8 * k, 4 * k ** 3, FP64_TC)
        print(f"  eigh_small: {int(info[0])} Jacobi sweeps on the late move's H")
        # the largest k, on a dense random symmetric matrix: the hardest start
        X = torch.randn(EIGH_BIG, EIGH_BIG, generator=gen, device=dev, dtype=torch.float64)
        Hb = (0.5 * (X + X.mT)).contiguous()
        w, V = eigh_small(Hb, info=info)
        sweeps, conv = info.tolist()[:2]
        e_w, e_r, e_o = eigh_errors(Hb, w, V, eigh_small_twin(Hb)[0])
        ms_k = cuda_ms(lambda: eigh_small(Hb))
        ms_l = cuda_ms(lambda: torch.linalg.eigh(Hb))
        rec["eigh_small"][f"ms_dense_k{EIGH_BIG}"] = ms_k
        check((conv == 1 or dev.type == "cpu") and max(e_w, e_r, e_o) <= tol,
              f"eigh_small k={EIGH_BIG}, dense random H: {sweeps} sweeps, converged="
              f"{bool(conv)}; eigenvalues rel err {e_w:.2e}, residual {e_r:.2e}, orthogonality "
              f"{e_o:.2e} <= {tol:.0e}; kernel {ms_k:.3f} ms, torch.linalg.eigh {ms_l:.3f} ms")

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
        Y = ozaki.ozaki_gemm(Ap, ea, Bp, eb)
        Yt = ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7)
        e = rel_err(Y, Yt)
        e64 = rel_err(Y, M2 @ P)
        check(e <= OZ_TOL, f"ozaki_gemm M2 P (s={s}): rel err {e:.2e} <= {OZ_TOL:.0e} vs the "
                           f"twin; {e64:.2e} vs the FP64 product")
        time_case(rec, "ozaki_split", lambda: ozaki.ozaki_split(M2, s, 7, 1),
                  lambda: ozaki.ozaki_split_twin(M2, s, 7, 1), None,
                  nbytes(M2) + s * Ap.shape[1] * Ap.shape[2] + 8 * n, 0, FP64_CC)
        print("  ozaki_split bound: read M2 once, write its 8 digit planes")
        ops = s * (s + 1) // 2 * 2 * n * n * k
        time_case(rec, "ozaki_gemm", lambda: ozaki.ozaki_gemm(Ap, ea, Bp, eb),
                  lambda: ozaki.ozaki_gemm_twin(Ap, ea, Bp, eb, 7), lambda: torch.matmul(M2, P),
                  nbytes(Ap, Bp, ea, eb, Y), ops, INT8_TC)
        fp64_ms, _ = bound(nbytes(M2, P, Y), 2 * n * n * k, FP64_TC)
        rec["ozaki_gemm"]["fp64_bound_ms"] = fp64_ms
        print(f"  ozaki_gemm: {ops / 1e9:.0f} G int8 operations; the same product in FP64: "
              f"bound {fp64_ms:.4f} ms at 67 TFLOP/s")
        del M2, Ap, Y, Yt, split
        # a layer shape of the Ozaki move (the ket layer without slicing):
        # A (s,e,r) x (u,l) = 98 x 49 by B (u,l) x (m,j,v,i) = 49 x 1.06M
        q1 = (T_int.permute(0, 1, 3, 2).reshape(D * D * CHI, CHI)
              @ (env.C @ T_int.permute(3, 0, 1, 2).reshape(CHI, D * D * CHI)))
        A_l = a.permute(0, 3, 4, 1, 2).reshape(2 * D * D, D * D).contiguous()
        B_l = q1.view(D, D, CHI, D, D, CHI).permute(3, 0, 1, 2, 4, 5).reshape(D * D, -1)
        B_l = B_l.contiguous()
        del q1
        split = {}
        for label, X, axis in (("A", A_l, 1), ("B", B_l, 0)):
            Xp, ex = ozaki.ozaki_split(X, s, 7, axis)
            Xpt, ext = ozaki.ozaki_split_twin(X, s, 7, axis)
            same = torch.equal(Xp, Xpt) and torch.equal(ex, ext)
            del Xpt, ext
            check(same, f"ozaki_split layer {label} {tuple(X.shape)} axis={axis}: digit planes "
                        f"{tuple(Xp.shape)} and exponents bit-identical to the twin")
            split[label] = (Xp, ex)
        (Alp, eal), (Blp, ebl) = split["A"], split["B"]
        Yl = ozaki.ozaki_gemm(Alp, eal, Blp, ebl)
        e = rel_err(Yl, ozaki.ozaki_gemm_twin(Alp, eal, Blp, ebl, 7))
        e64 = rel_err(Yl, A_l @ B_l)
        check(e <= OZ_TOL, f"ozaki_gemm layer {tuple(A_l.shape)} x {tuple(B_l.shape)}: rel err "
                           f"{e:.2e} <= {OZ_TOL:.0e} vs the twin; {e64:.2e} vs the FP64 product")
        ms_split = cuda_ms(lambda: ozaki.ozaki_split(B_l, s, 7, 0))
        ms_gemm = cuda_ms(lambda: ozaki.ozaki_gemm(Alp, eal, Blp, ebl))
        ms_fp64 = cuda_ms(lambda: A_l @ B_l)
        rec["ozaki_split"]["ms_layer_shape"] = ms_split
        rec["ozaki_gemm"]["ms_layer_shape"] = ms_gemm
        print(f"  at the layer shape: ozaki_split of B {ms_split:.3f} ms, ozaki_gemm "
              f"{ms_gemm:.3f} ms, FP64 torch.matmul {ms_fp64:.3f} ms")
        del A_l, B_l, Yl, split, Alp, Blp

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


def phase7(dev) -> dict:
    print(f"== phase 7: the large-D slice, J1-J2 C4v D={D} chi={CHI}", flush=True)
    from tpeps_torch.ctm.c4v import move_factored as mf
    from tpeps_torch.ctm.c4v.env import init_env
    from tpeps_torch.ctm.c4v.move_graph import MoveGraph, run_fixed_point_factored
    from tpeps_torch.kernels import launch_counts, reset_launch_counts
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
    for impl in ("xla", "ozaki"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moves[impl] = mf.ctm_move_sl_factored(a, env0.C, T_int, P0, n_power=N_POWER,
                                              slice_phys=True, dot_impl=impl)
        torch.cuda.synchronize()
        print(f"  one move, slice_phys, dot_impl={impl}: {1000 * (time.perf_counter() - t0):.1f} ms "
              "(first call)")
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
    return counts


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


def busy_share(fn):
    """``(wall s, summed device kernel s)`` of ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += getattr(evt, "self_device_time_total", None) or \
                getattr(evt, "self_cuda_time_total", 0.0)
    return wall, dev_us / 1e6


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
        ngroups = len(g.groups(dev)[0])
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
    # converge_frozen (forward) to 1e-8 or 48 moves: the frozen engine's main path
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
    (sp_c, e_c, env_c, a_c), (sp_d, e_d, _, _) = res
    d_spec = max(float(np.abs(x / x[0] - y / y[0]).max()) for x, y in zip(sp_c, sp_d))
    check(d_spec <= AB_SMALL_TOL and abs(e_c - e_d) <= AB_SMALL_TOL,
          f"D=3 chi={AB_SMALL_CHI} card vs CPU: 6 dynamic moves' spectra max diff {d_spec:.2e}, "
          f"energy |dE| {abs(e_c - e_d):.2e} <= {AB_SMALL_TOL:.0e}")
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


def main() -> None:
    smi = phase0()
    dev = torch.device("cuda", 0)
    phase1()
    rec = phase2(dev)
    rec.update(phase2_large_d(dev))
    counts_fwd = phase3(dev)
    phase4(dev)
    counts_train = phase5(dev)
    phase6(dev)
    counts_large = phase7(dev)
    rec_ab, counts_ab, counts_fz = phase8(dev)
    rec.update(rec_ab)
    # launches: on the training path for its kernels, on the large-D slice
    # for K5/K7, on the abelian entry point for K8 and converge_frozen for
    # K9, else on the forward path (K1, K2, K4 and eigh_small)
    main_run = lambda name: (counts_train if name in TRAIN
                             else counts_large if name in LARGE_D
                             else counts_fz if name == "frozen_commit"
                             else counts_ab if name in ABELIAN else counts_fwd)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": main_run(name)[name],
         "launches_forward_slice": counts_fwd[name],
         "launches_training_slice": counts_train[name],
         "launches_large_d_slice": counts_large[name],
         "launches_abelian_entry_point": counts_ab[name],
         "launches_abelian_frozen": counts_fz[name], **rec[name]}
        for name in SOURCES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
