"""Profiling hooks: a ``torch.profiler`` trace around any run, and the
named spans the samplers open on the profiler's timeline.

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

__all__ = ["trace", "span"]

_OFF = contextlib.nullcontext()
# looked up once: a span's cost with no profiler is this one call
_profiler_enabled = torch.autograd._profiler_enabled


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


def span(name: str):
    """Context manager: a range named ``name`` on the profiler's timeline
    while a ``torch.profiler`` session runs (``trace``, or any other), so
    the card's work and idle time can be charged to it; otherwise one
    shared no-op context, whose cost is the one check. The samplers' names
    start with ``fthmc.``."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
