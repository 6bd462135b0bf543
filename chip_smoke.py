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
}
FORWARD = ("layer_contract", "corner_apply", "gram_ridge", "gram", "trsm_right_lower_h",
           "t_epilogue", "polar_unitary")
# the training path (reference-layout moves and their VJPs): K3 and K6
TRAIN = ("gram_ridge", "gram", "trsm_right_lower_h", "trsm_right_lower", "polar_unitary",
         "polar_vjp")
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP64 on the tensor cores
# (DMMA) and on the CUDA cores
HBM_BPS, FP64_TC, FP64_CC = 3.35e12, 67e12, 34e12


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
    from tpeps_torch.ctm.c4v import move_factored
    from tpeps_torch.kernels import LAUNCHES, cholqr, corner, epilogue, layer, polar
    from tpeps_torch.linalg import power

    before = dict(LAUNCHES)
    with mock.patch.object(move_factored, "layer_contract", layer.layer_contract_twin), \
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
            # bra K=98)
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
                                   lambda: k1_layers(layer.layer_contract_twin), None,
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
            for name, (kern, twin, lib, nb, fl, peak) in cases.items():
                ref = twin().clone()  # k1_layers reuses its output buffer
                err = float((kern() - ref).abs().max())
                # kernel, twin, twin, kernel: a drift of clocks hits both alike
                ms, plain_ms = cuda_ms(kern), cuda_ms(twin)
                plain_ms2, ms2 = cuda_ms(twin), cuda_ms(kern)
                bound_ms, bound_by = bound(nb, fl, peak)
                rec[name] = {"max_abs_err": err, "ms": min(ms, ms2),
                             "plain_ms": min(plain_ms, plain_ms2), "bound_ms": bound_ms,
                             "bound_by": bound_by,
                             "library_ms": cuda_ms(lib) if lib is not None else None}
                lib_txt = (f", library {rec[name]['library_ms']:.3f} ms"
                           if lib is not None else "")
                print(f"  {name}: kernel {rec[name]['ms']:.3f} ms, twin "
                      f"{rec[name]['plain_ms']:.3f} ms{lib_txt}, bound {bound_ms:.4f} ms "
                      f"({bound_by}), max abs err {err:.2e}")
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


def main() -> None:
    smi = phase0()
    dev = torch.device("cuda", 0)
    phase1()
    rec = phase2(dev)
    counts_fwd = phase3(dev)
    phase4(dev)
    counts_train = phase5(dev)
    phase6(dev)
    # launches: on the training path for its kernels, else on the forward
    # path (K1, K2, K4 run only there)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": (counts_train if name in TRAIN else counts_fwd)[name],
         "launches_forward_slice": counts_fwd[name],
         "launches_training_slice": counts_train[name], **rec[name]}
        for name in SOURCES
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
