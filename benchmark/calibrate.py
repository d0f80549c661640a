"""The readings a cell's limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

For each seed, one process runs what a benchmark run runs (set-up,
thermalisation, a window of ``--seconds`` at the cell's own load, the
blocks kept by the seed's reservoir) and prints the compared numbers of the
program against the reference (the lower readings). With ``--control``,
the reference computed in the configuration's control precision (the
nearest below the one it states: bf16 for the plain fp32 step, TF32 convs
for the fp32 flow) is put in the program's place on the same blocks, from
the same starts and generator states, and its numbers are printed beside
(the upper readings). One JSON line a seed; the benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check as chk  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.drivers.common import seeds  # noqa: E402


class _Hist:
    """A replay's rows in the shape of the program's history."""

    def __init__(self, rows: dict):
        self.dh, self.acc = rows["dh"], rows["acc"]
        self.plaq, self.q = rows["plaq"], rows["q"]


def control_numbers(cell, kept, device) -> dict:
    """The control in the program's place on the kept blocks: its own
    readings of each block's start and first trajectory against the
    reference's."""
    ctl, refc = cell.config["control"], cell.config["reference"]
    dt_c, dt_r = harness.DTYPES[ctl["dtype"]], harness.DTYPES[refc["dtype"]]
    drv = cell.driver
    ref_s = drv.reference(cell.config, cell.root, device, dt_r)
    ctl_s = drv.reference(cell.config, cell.root, device, dt_c,
                          allow_tf32=ctl.get("allow_tf32", False))
    gens = [k["gen"] for k in kept]
    ref = ref_s.replay([k["start"].to(dt_r) for k in kept], gens, device)
    got = ctl_s.replay([k["start"].to(dt_c) for k in kept], gens, device)
    sizes = [k["start"].shape[0] for k in kept]
    hists = [_Hist({f: t[None] for f, t in zip(("dh", "acc", "plaq", "q"),
                                              rows)})
             for rows in zip(*(got[f].split(sizes)
                               for f in ("dh", "acc", "plaq", "q")))]
    prevs = [{"plaq": p, "q": q} for p, q in
             zip(got["start_plaq"].split(sizes), got["start_q"].split(sizes))]
    return chk.compare(hists, prevs, ref,
                       cell.cell["check"].get("decision_margin"))


def one_seed(cell, seed: int, seconds: float, device, control: bool):
    c = cell.cell
    t0 = time.perf_counter()
    sampler = cell.driver.Sampler(cell.config, c, seed, device, cell.root)
    tally = harness.Tally(sampler, 0,
                          np.random.default_rng(seeds(seed, 2)[1]))
    for _ in range(max(1, -(-c["therm"] // c["block"]))):
        tally.block()
    tally.reset()
    tally.keep = c["check"]["blocks"]
    t1 = time.perf_counter()
    while not tally.stamps or tally.stamps[-1] - t1 < seconds:
        tally.block()
    kept = tally.kept
    out = {"seed": seed, "setup_s": t1 - t0, "blocks": len(tally.stamps),
           "acceptance": tally.accepted / tally.attempted}
    sampler.release()
    t = time.perf_counter()
    out["program"] = harness.compare(
        cell, kept, device, harness.DTYPES[cell.config["reference"]["dtype"]])
    out["reference_s"] = time.perf_counter() - t
    if control:
        t = time.perf_counter()
        out["control"] = control_numbers(cell, kept, device)
        out["control_s"] = time.perf_counter() - t
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(harness.ROOT, args.workload)
    rows = []
    for seed in args.seeds:
        row = one_seed(cell, seed, args.seconds, device, args.control)
        rows.append(row)
        print(json.dumps(row), flush=True)
    for who in ("program", "control"):
        if all(who in r for r in rows):
            print(who, json.dumps({k: [min(r[who][k] for r in rows),
                                       max(r[who][k] for r in rows)]
                                   for k in rows[0][who]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
