"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by name under the benchmark's root:
``workloads/<cell>.json`` (its configuration's name, its chains, block,
thermalisation and check), ``configs/<config>.json`` (the physics,
the sampler, the precision), ``drivers/<sampler>.py`` (the adapter that
calls the program's driver and names its reference) and
``metrics/<metric>.py`` (a reader of one per-layer metric, ``read(ctx)``,
returning None where it finds nothing to read).

The window drives whole blocks through the program's driver; the
callback that ``run_blocks`` calls at each block's delivery stamps the
host clock. The window ends at the first block delivered after
``seconds``. Blocks to compare are drawn from the seed by reservoir
sampling as the window runs: for each, the start state, the generator
state and the last reading before it are kept, and its history after.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import check as chk
from benchmark import tracing
from benchmark.drivers.common import seeds

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fthmc_tpu")
DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's files, found by its name under ``root``."""

    def __init__(self, root: Path, name: str):
        self.root, self.name = Path(root), name
        self.cell = read_json(self.root / "workloads" / f"{name}.json")
        self.config = read_json(self.root / "configs"
                                / f"{self.cell['config']}.json")
        sampler = self.config["sampler"]
        self.driver = load_module(self.root / "drivers" / f"{sampler}.py",
                                  f"benchmark_driver_{sampler}")

    def readers(self) -> dict:
        """{metric: module} of every per-layer metric's reader."""
        return {p.stem: load_module(p, f"benchmark_metric_{p.stem}")
                for p in sorted((self.root / "metrics").glob("*.py"))}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Tally:
    """What the window counts at each block's delivery, and the blocks kept
    for the comparison (a reservoir of ``keep`` blocks, drawn with
    ``rng``)."""

    def __init__(self, sampler, keep: int, rng):
        self.sampler, self.keep, self.rng = sampler, keep, rng
        self.stamps, self.traj, self.accepted, self.attempted = [], 0, 0.0, 0
        self.failed, self.hist = 0, None
        self.kept, self.seen = [], 0

    def delivered(self, done, hist) -> None:
        """``run_blocks``'s callback."""
        del done
        self.stamps.append(time.perf_counter())
        self.hist = hist
        self.traj += hist.acc.shape[0]
        self.accepted += float(hist.acc.sum())
        self.attempted += hist.acc.numel()
        self.failed += int((~torch.isfinite(hist.dh)).sum())

    def _row(self) -> dict:
        return {"plaq": self.hist.plaq[-1], "q": self.hist.q[-1]}

    def block(self) -> None:
        """One block, kept for the comparison where the reservoir draws it."""
        slot = None
        if self.keep > 0:
            if self.seen < self.keep:
                slot = self.seen
            else:
                j = int(self.rng.integers(0, self.seen + 1))
                slot = j if j < self.keep else None
        self.seen += 1
        if slot is None:
            self.sampler.run_block(self.delivered)
            return
        s = self.sampler
        snap = {"start": s.state.clone(), "gen": s.generator.get_state(),
                "prev": self._row()}
        s.run_block(self.delivered)
        snap["hist"] = self.hist
        if slot < len(self.kept):
            self.kept[slot] = snap
        else:
            self.kept.append(snap)

    def reset(self) -> None:
        """Forget the counts (after set-up); keep the last history."""
        self.stamps, self.traj, self.accepted, self.attempted = [], 0, 0.0, 0
        self.failed, self.seen = 0, 0


def power_limit() -> float | None:
    """The card's power limit (W), as nvidia-smi reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def compare(cell: Cell, kept: list, device, dtype, allow_tf32=False) -> dict:
    """The numbers of ``kept`` blocks against the cell's reference computed
    in ``dtype`` (the configuration's reference dtype; a lower one is the
    control's)."""
    ref_sampler = cell.driver.reference(cell.config, cell.root, device,
                                        dtype, allow_tf32=allow_tf32)
    ref = (ref_sampler.replay([k["start"].to(dtype) for k in kept],
                              [k["gen"] for k in kept], device)
           if kept else None)
    return chk.compare([k["hist"] for k in kept], [k["prev"] for k in kept],
                       ref, cell.cell["check"].get("decision_margin"))


def _traced(cell: Cell, sampler, tally: Tally, window: dict, on_card: bool):
    """The traced slice after the window (whole blocks, about
    ``tracing.SLICE_S``): the per-layer metrics and the slice's
    reduction."""
    n_slice = max(1, round(tracing.SLICE_S
                           / (window["block_median_ms"] / 1e3)))
    traj0 = tally.traj
    launches0 = cell.driver.launches()
    events = tracing.profile_blocks(
        lambda: sampler.run_block(tally.delivered), n_slice)
    launches1 = cell.driver.launches()
    red = tracing.reduce_events(events)
    ctx = {"config": cell.config, "cell": cell.cell,
           "on_card": on_card and red["busy_s"] > 0, "window": window,
           "slice": dict(red, traj=tally.traj - traj0, blocks=n_slice,
                         launches={k: v - launches0.get(k, 0)
                                   for k, v in launches1.items()})}
    metrics = {}
    for name, reader in cell.readers().items():
        val = reader.read(ctx)
        if val is not None:
            metrics[name] = {"value": val, "unit": reader.UNIT}
    return metrics, red, ctx["slice"]


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=sys.stderr) -> dict:
    """One run; returns the result line's object (``check`` last)."""
    on_card = torch.device(device).type == "cuda"
    t_cell = time.perf_counter()
    cell = Cell(root, name)
    cfg, c = cell.config, cell.cell
    sampler = cell.driver.Sampler(cfg, c, seed, device, cell.root)
    t_therm = time.perf_counter()
    tally = Tally(sampler, 0, np.random.default_rng(seeds(seed, 2)[1]))
    for _ in range(max(1, math.ceil(c["therm"] / c["block"]))):
        tally.block()
    _sync(device)
    # what set-up made stays alive for the run: keep it out of the cyclic
    # collector's full passes, whose pauses would land in the window
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print(f"setup: {setup_s:.6f} s: imports {t_cell - t_start:.6f}, "
          f"sampler {t_therm - t_cell:.6f}, thermalisation "
          f"{t0 - t_therm:.6f}", file=log)
    tally.reset()
    tally.keep = c["check"]["blocks"]
    while not tally.stamps or tally.stamps[-1] - t0 < seconds:
        tally.block()
    window_s = tally.stamps[-1] - t0
    gc.unfreeze()
    gaps_ms = np.diff([t0, *tally.stamps]) * 1e3
    window = {"traj": tally.traj, "seconds": window_s,
              "chains": sampler.chains,
              "block_median_ms": float(np.median(gaps_ms))}
    q = np.percentile(gaps_ms, [50, 95, 99, 100])
    print(f"window: {len(tally.stamps)} blocks, {tally.traj} trajectories, "
          f"{window_s:.6f} s, block ms p50 {q[0]:.6f} p95 {q[1]:.6f} "
          f"p99 {q[2]:.6f} max {q[3]:.6f}", file=log)
    attempted, failed = tally.attempted, tally.failed
    dev, red = {}, None
    if trace:
        metrics, red, sl = _traced(cell, sampler, tally, window, on_card)
        print(f"slice: {sl['blocks']} blocks, {sl['traj']} trajectories, "
              f"{red['window_s']:.6f} s, busy {red['busy_s']:.6f} s, "
              f"{red['kernel_launches']} kernel launches", file=log)
        dev = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
    else:
        steps = sampler.chains * sampler.steps_per_traj * tally.traj
        metrics = {
            "chain_steps_per_s": {"value": steps / window_s,
                                  "unit": "chain-steps/s"},
            "block_ms_p95": {"value": percentile(gaps_ms, 95), "unit": "ms"},
            "acceptance": {"value": tally.accepted / attempted,
                           "unit": "fraction"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kept = tally.kept
    sampler.release()
    del sampler, tally
    if on_card:
        torch.cuda.empty_cache()

    t_chk = time.perf_counter()
    numbers = compare(cell, kept, device, DTYPES[cfg["reference"]["dtype"]])
    print(f"check: {len(kept)} blocks replayed by the reference in "
          f"{time.perf_counter() - t_chk:.3f} s", file=log)
    limits = c["check"]["limits"]
    result = {"correct": chk.verdict(numbers, limits) and failed == 0,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak),
                         "power_limit_w": power_limit() if on_card else None,
                         **dev}}
    if trace:
        result["breakdown"] = {"device_ops": red["device_ops"],
                               "idle_gaps": red["idle_gaps"]}
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=log)
    return result


def main(argv=None, t_start: float | None = None) -> int:
    """The command line; ``t_start`` is the process's first clock reading
    (the set-up time counts from it)."""
    import argparse
    if t_start is None:
        t_start = time.perf_counter()
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    chips = read_json(ROOT / "workloads"
                      / f"{args.workload}.json").get("chips", 1)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no card: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
