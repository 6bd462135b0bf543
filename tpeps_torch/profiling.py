"""Profiling utilities (counterpart of tpeps/profiling.py).

``PhaseTimers`` accumulates named phases: on a CUDA device with CUDA
events around the phase (device time as seen by the stream, read after a
synchronize), on the CPU with the host clock.  ``log_device_mem`` reports
the CUDA caching allocator's current and peak use.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def log_device_mem(prefix: str = "", device=None) -> str:
    """One-line memory report of a CUDA device; "n/a" without one."""
    if not torch.cuda.is_available():
        return f"{prefix} mem: n/a"
    gib = 1024**3
    return (
        f"{prefix} mem: in_use {torch.cuda.memory_allocated(device) / gib:.2f} GiB, "
        f"peak {torch.cuda.max_memory_allocated(device) / gib:.2f} GiB, "
        f"reserved {torch.cuda.memory_reserved(device) / gib:.2f} GiB"
    )


class PhaseTimers:
    """Named accumulators of seconds for algorithm phases."""

    def __init__(self):
        self.t = defaultdict(float)
        self.n = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time a phase.  With a CUDA ``device`` the phase is bracketed by
        CUDA events on the current stream and the end is synchronized, so
        asynchronous launches are counted where they run."""
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            try:
                yield
            finally:
                end.record(torch.cuda.current_stream(dev))
                end.synchronize()
                self.t[name] += start.elapsed_time(end) / 1000.0
                self.n[name] += 1
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.t[name] += time.perf_counter() - t0
            self.n[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": self.t[k], "calls": self.n[k]} for k in self.t}
