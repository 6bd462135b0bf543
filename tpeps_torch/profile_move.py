"""Where a factored C4v move spends its time on one CUDA card.

Usage::

    python -m tpeps_torch.profile_move [--D 7] [--chi 147] [--moves 4] [--warmup 2] [--slice-phys]

Builds the benchmark-case state (RandomState(0), C4v-symmetrized, float64),
runs ``--warmup`` moves from the cold start, then profiles ``--moves`` moves with
``torch.profiler`` and prints the device time per kernel name (self time,
summed over the window, per move), the host wall time per move, the
device busy share (summed kernel time over wall time), and the host ops by
their own CPU time.  Needs a CUDA card;
it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--D", type=int, default=7)
    ap.add_argument("--chi", type=int, default=147)
    ap.add_argument("--moves", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--slice-phys", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_move needs a CUDA card", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from .ctm.c4v import move_factored as mf
    from .ctm.c4v.env import init_env
    from .ipeps.ipeps_c4v import symmetrize_c4v

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    D, chi = args.D, args.chi
    x = np.random.RandomState(0).rand(2, D, D, D, D) - 0.5
    a = symmetrize_c4v(torch.as_tensor(x, dtype=torch.float64), normalize=True).to(dev)
    env = init_env(a, chi, "CTMRG")
    C, T_int = env.C, mf.to_int_layout(env.T, D)
    P = mf.cold_start_basis(chi * D * D, chi, a.dtype, dev)

    def moves(n):
        nonlocal C, T_int, P
        for _ in range(n):
            C, T_int, _, P = mf.ctm_move_sl_factored(a, C, T_int, P, slice_phys=args.slice_phys)
        torch.cuda.synchronize()

    moves(args.warmup)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        moves(args.moves)
        wall = time.perf_counter() - t0
    rows, host = [], []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host.append((evt.self_cpu_time_total, evt.count, evt.key))
            continue  # a host op's device time is its kernels' time
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1000.0
    n = args.moves
    print(f"card: {smi}")
    print(f"D={D} chi={chi} slice_phys={args.slice_phys}, after {args.warmup} moves: "
          f"{1000 * wall / n:.2f} ms/move wall, "
          f"{busy_ms / n:.2f} ms/move summed device time, busy share {busy_ms / (1000 * wall):.3f}")
    print(f"{'ms/move':>9} {'calls/move':>10}  kernel")
    for us, count, key in rows[: args.top]:
        print(f"{us / 1000.0 / n:9.3f} {count / n:10.1f}  {key[:110]}")
    host.sort(reverse=True)
    print(f"host ops by self CPU time: {sum(h[0] for h in host) / 1000.0 / n:.2f} ms/move in all")
    for us, count, key in host[: args.top]:
        print(f"{us / 1000.0 / n:9.3f} {count / n:10.1f}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
