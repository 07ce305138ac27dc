"""Throughput metering and profiler traces (torch port of
lbm_tpu/utils/profiling.py): `Meter`, a steps -> MLUPS meter around any
block, and `trace(log_dir)`, a torch.profiler trace of a block (CPU
activity, and CUDA activity when a card is present) exported as a Chrome
trace into log_dir (open in chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time


class Meter:
    """Accumulating lattice-update throughput meter."""

    def __init__(self, n_sites: int):
        self.n_sites = int(n_sites)
        self.steps = 0
        self.seconds = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        self._t0 = None

    def add_steps(self, n: int):
        self.steps += n

    @property
    def mlups(self) -> float:
        if self.seconds == 0:
            return 0.0
        return self.n_sites * self.steps / self.seconds / 1e6

    def report(self) -> str:
        return (
            f"{self.steps} steps, {self.seconds*1e3:.1f} ms total, "
            f"{self.mlups:.1f} MLUPS"
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block with torch.profiler and write
    <log_dir>/trace.json (Chrome trace format); yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


__all__ = ["Meter", "trace"]
