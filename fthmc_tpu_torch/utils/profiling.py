"""Profiling hooks: a ``torch.profiler`` trace around any run, and a
steps/s meter.

Counterpart of ``fthmc_tpu/utils/profiling.py``, whose ``trace`` is a
``jax.profiler`` trace. Here it records the host's activity, and the
card's kernels when a card is present, and writes a Chrome trace (viewable
in Perfetto or chrome://tracing) into the directory.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "Timer"]


@contextlib.contextmanager
def trace(logdir: str | None):
    """Context manager: profile the block and write its Chrome trace to
    ``logdir/trace_<pid>_<ns>.json`` (a no-op if logdir is None)."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Steps/sec meter with exponential moving average."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rate = None
        self._last = time.perf_counter()

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        r = n / dt if dt > 0 else 0.0
        self.rate = r if self.rate is None else (
            self.alpha * r + (1 - self.alpha) * self.rate)
        return self.rate
