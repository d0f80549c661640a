"""The traced slice of a run: whole blocks, about ``SLICE_S`` seconds, under
``torch.profiler`` (CPU and CUDA), reduced in memory to what the per-layer
metrics read.

The slice's own timeline gives everything: its wall length (the
``bench.slice`` span), the union of the device's kernel, copy and set
intervals inside it (busy time), each kernel's launches and device time by
name, and the idle gaps between device intervals, each named by the
innermost host operation running at its middle on the thread that drove
the blocks.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

SLICE_S = 2.5        # the slice's seconds, rounded to whole blocks
SLICE_SPAN = "bench.slice"
BLOCK_SPAN = "bench.block"
NAME_CHARS = 120     # an operation's name in the breakdown, cut to this


def profile_blocks(run_block, n_blocks: int):
    """Run ``n_blocks`` blocks under the profiler; returns its events."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SLICE_SPAN):
            for _ in range(n_blocks):
                with record_function(BLOCK_SPAN):
                    run_block()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    """An operation on the card: not a host event, and not the device-side
    copy of a host span (the profiler mirrors ``record_function`` ranges
    onto the device's timeline)."""
    return (e.device_type() != torch.autograd.DeviceType.CPU
            and not getattr(e, "is_user_annotation", bool)()
            and not e.name().startswith("bench."))


def _is_kernel(e) -> bool:
    """A kernel, not a copy or a set (the profiler names those
    ``Memcpy ...`` and ``Memset ...``)."""
    name = e.name()
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def reduce_events(events) -> dict:
    """The slice's numbers: ``window_s`` (its span), ``busy_s`` (the union
    of device intervals in it), ``kernels`` {name: [launches, seconds]},
    ``kernel_launches``, ``device_ops`` (the top 10 by time) and
    ``idle_gaps`` (idle time by what the host was doing, the top 10)."""
    span = [e for e in events if e.name() == SLICE_SPAN
            and e.device_type() == torch.autograd.DeviceType.CPU]
    if not span:
        raise RuntimeError("the profiler recorded no slice span")
    t0 = span[0].start_ns()
    t1 = t0 + span[0].duration_ns()
    thread = span[0].start_thread_id()
    dev, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        if _is_device(e):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            dev.append((a, b))
            if _is_kernel(e):
                k = kernels[e.name()]
                k[0] += 1
                k[1] += (b - a) * 1e-9
        elif (e.device_type() == torch.autograd.DeviceType.CPU
              and e.start_thread_id() == thread and e.name() != SLICE_SPAN):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
    dev.sort()
    busy, gaps, cur_a, cur_b = 0, [], None, None
    prev_end = t0
    for a, b in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > prev_end:
                gaps.append((prev_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        prev_end = max(prev_end, cur_b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if prev_end < t1 and dev:
        gaps.append((prev_end, t1))
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return {"window_s": (t1 - t0) * 1e-9, "busy_s": busy * 1e-9,
            "kernels": dict(kernels),
            "kernel_launches": sum(v[0] for v in kernels.values()),
            "device_ops": [[n[:NAME_CHARS], v[1]] for n, v in by_time[:10]],
            "idle_gaps": _name_gaps(gaps, host)}


def _name_gaps(gaps, host) -> list:
    """Idle seconds summed by the innermost host operation that covers each
    gap's middle (a sweep over the host events in start order, whose
    intervals nest on one thread); "host (no operation)" where none
    does."""
    host.sort(key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    totals = defaultdict(float)
    stack, j = [], 0
    for m, length in mids:
        j_new = bisect.bisect_right(starts, m, lo=j)
        for h in host[j:j_new]:
            while stack and stack[-1][1] <= h[0]:
                stack.pop()
            stack.append(h)
        j = j_new
        while stack and stack[-1][1] <= m:
            stack.pop()
        name = stack[-1][2] if stack else "host (no operation)"
        totals[name] += length * 1e-9
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return [[n[:NAME_CHARS], s] for n, s in top]
