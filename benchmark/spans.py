"""The program's phase spans in a traced slice, with the card's work and
idle time charged to them.

Whenever a profiler runs, the port opens the span ``fthmc.step`` around
each trajectory, holding ``fthmc.step.{momenta,integrate,energy,accept,
observe}`` (``fthmc_tpu_torch.utils.profiling.span``). The profiler
records them on the clock of the card's kernels, so ``charge`` can put
each device operation of a slice (``tracing.profile_blocks``'s events) to
the innermost ``fthmc.`` span that was open on the thread driving the
blocks when its runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
..., matched by the kineto correlation id) was made, and each idle gap of
the device's timeline (cut as ``tracing.reduce_events`` cuts it) to the
innermost span open at the gap's middle. ``block_edge_idle_ms`` and
``step_extra_device_ms``, the two per-layer numbers this gives, read a
context shaped as the harness hands one to a metric's reader, the charge
under ``slice["spans"]``. ``tracing.reduce_events`` makes no such key, so
the benchmark's traced runs do not report them; this module's command
line does.

Run alone, on a card, it traces one cell as a traced run does (set-up and
thermalisation, then whole blocks for about ``tracing.SLICE_S``) and
prints the charge and both numbers as one JSON line:

    python3 -m benchmark.spans --workload hmc64_headline --seed 7
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from benchmark import harness, tracing

PREFIX = "fthmc."
STEP = "fthmc.step"
INTEGRATE = "fthmc.step.integrate"
OUTSIDE = "-"        # under no ``fthmc.`` span
UNMATCHED = "?"      # device work whose runtime call the trace lacks
RUNTIME = "cu"       # the CUDA runtime's and driver's calls begin so
TOP_KERNELS = 5
SIZING_S = 3.0       # untraced blocks timed to size the slice


def charge(events) -> dict:
    """{span name, ``OUTSIDE``, and ``UNMATCHED`` where needed: {"calls",
    "host_s", "device_s", "idle_s", "kernels"}} of a slice's events.
    ``host_s`` is a span's summed durations clipped to the slice (for
    ``OUTSIDE`` the slice's time outside every span), ``device_s`` the
    device seconds of the kernels, copies and sets launched under it
    (``kernels``: the top ``TOP_KERNELS`` of them by name), ``idle_s``
    the idle gaps whose middle lies under it."""
    cpu = torch.autograd.DeviceType.CPU
    sl = [e for e in events if e.name() == tracing.SLICE_SPAN
          and e.device_type() == cpu]
    if not sl:
        raise RuntimeError("the profiler recorded no slice span")
    t0, thread = sl[0].start_ns(), sl[0].start_thread_id()
    t1 = t0 + sl[0].duration_ns()
    spans, calls, dev = [], {}, []
    for e in events:
        if tracing._is_device(e):
            a = max(e.start_ns(), t0)
            b = min(e.start_ns() + e.duration_ns(), t1)
            if b > a:
                dev.append((a, b, e.correlation_id(),
                            e.name() if tracing._is_kernel(e) else None))
        elif e.device_type() == cpu:
            if e.name().startswith(RUNTIME):
                calls[e.correlation_id()] = e.start_ns()
            elif (e.name().startswith(PREFIX)
                  and e.start_thread_id() == thread):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.name()))
    out = defaultdict(lambda: {"calls": 0, "host_s": 0.0, "device_s": 0.0,
                               "idle_s": 0.0, "kernels": defaultdict(float)})
    outside = out[OUTSIDE]
    for a, b, name in spans:
        a, b = max(a, t0), min(b, t1)
        if b > a:
            out[name]["calls"] += 1
            out[name]["host_s"] += (b - a) * 1e-9
    outside["host_s"] = (t1 - t0 - _covered(spans, t0, t1)) * 1e-9
    matched = [d for d in dev if d[2] in calls]
    for (a, b, _, kernel), name in zip(
            matched, _innermost(spans, [calls[d[2]] for d in matched])):
        _add_device(out[name], a, b, kernel)
    for a, b, corr, kernel in dev:
        if corr not in calls:
            _add_device(out[UNMATCHED], a, b, kernel)
    gaps = _gaps(sorted((a, b) for a, b, _, _ in dev), t0, t1)
    for (a, b), name in zip(gaps, _innermost(spans, [(a + b) // 2
                                                     for a, b in gaps])):
        out[name]["idle_s"] += (b - a) * 1e-9
    for v in out.values():
        top = sorted(v["kernels"].items(), key=lambda kv: -kv[1])
        v["kernels"] = {n[:tracing.NAME_CHARS]: s
                        for n, s in top[:TOP_KERNELS]}
    return dict(out)


def _add_device(entry: dict, a: int, b: int, kernel) -> None:
    entry["device_s"] += (b - a) * 1e-9
    if kernel is not None:
        entry["kernels"][kernel] += (b - a) * 1e-9


def _covered(spans, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1] under at least one span."""
    total, end = 0, t0
    for a, b, _ in sorted(spans):
        a, b = max(a, end), min(b, t1)
        if b > a:
            total += b - a
            end = b
    return total


def _gaps(dev, t0: int, t1: int) -> list:
    """The device's idle gaps in [t0, t1], as ``reduce_events`` cuts them:
    from the slice's start to the first interval, between the unions of
    overlapping intervals, and from the last to the slice's end."""
    gaps, end = [], t0
    for a, b in dev:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if dev and end < t1:
        gaps.append((end, t1))
    return gaps


def _innermost(spans, times) -> list:
    """For each time, the name of the innermost span open at it (spans
    nest on one thread), else ``OUTSIDE``; a sweep over the times in
    order."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    names = [OUTSIDE] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            names[i] = stack[-1][2]
    return names


def block_edge_idle_ms(ctx):
    """The ms a block that the card waits while the host is outside every
    step: ``run_blocks``' fetch of the history, the driver's stack and
    block start, the callback (None where no step span was recorded, or
    off the card)."""
    s = ctx["slice"]
    sp = s.get("spans", {})
    if not ctx["on_card"] or STEP not in sp or s["blocks"] == 0:
        return None
    return 1e3 * sp[OUTSIDE]["idle_s"] / s["blocks"]


def step_extra_device_ms(ctx):
    """The device ms a trajectory charged to no ``fthmc.step.integrate``
    span: the momenta, the energies (FT-HMC's two flows), the accept, the
    observables and the block edge (None as above)."""
    s = ctx["slice"]
    sp = s.get("spans", {})
    if not ctx["on_card"] or STEP not in sp or s["traj"] == 0:
        return None
    extra = sum(v["device_s"] for k, v in sp.items() if k != INTEGRATE)
    return 1e3 * extra / s["traj"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="One cell's traced slice, charged to the program's "
                    "phase spans (a card only).")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.ROOT, args.workload)
    c = cell.cell
    sampler = cell.driver.Sampler(cell.config, c, args.seed, device,
                                  cell.root)
    tally = harness.Tally(sampler, 0, np.random.default_rng(0))
    for _ in range(max(1, math.ceil(c["therm"] / c["block"]))):
        tally.block()
    torch.cuda.synchronize(device)
    gc.collect()
    gc.freeze()
    tally.reset()
    t0 = time.perf_counter()
    while not tally.stamps or tally.stamps[-1] - t0 < SIZING_S:
        tally.block()
    block_s = float(np.median(np.diff([t0, *tally.stamps])))
    n_slice = max(1, round(tracing.SLICE_S / block_s))
    traj0 = tally.traj
    events = tracing.profile_blocks(
        lambda: sampler.run_block(tally.delivered), n_slice)
    red = tracing.reduce_events(events)
    sp = charge(events)
    ctx = {"on_card": red["busy_s"] > 0,
           "slice": {"spans": sp, "traj": tally.traj - traj0,
                     "blocks": n_slice}}
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           "power_limit_w": harness.power_limit(),
           "block_ms_untraced": 1e3 * block_s,
           "blocks": n_slice, "traj": ctx["slice"]["traj"],
           "window_s": red["window_s"], "busy_s": red["busy_s"],
           "kernel_launches": red["kernel_launches"],
           "device_s_over_busy_s": (sum(v["device_s"] for v in sp.values())
                                    / red["busy_s"]),
           "block_edge_idle_ms": block_edge_idle_ms(ctx),
           "step_extra_device_ms": step_extra_device_ms(ctx),
           "spans": sp, "device_ops": red["device_ops"],
           "idle_gaps": red["idle_gaps"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
