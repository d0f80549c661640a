#!/usr/bin/env python3
"""Seconds a trajectory of chip_smoke.py's dynamical path A (64^2, beta=6,
m=0.1, 64 chains, tau=2, 16 Omelyan steps) in two checkouts of the repo,
in turns (first, second, second, first), on one CUDA card:

    python3 ab_dyn.py OLD_CHECKOUT NEW_CHECKOUT [NTRAJ]

Each turn is a process of its own that imports the checkout's
fthmc_tpu_torch and chip_smoke, builds its kernels, runs 6 trajectories
from near-equilibrium links and times NTRAJ (default 24) more. Prints one
JSON line a turn and the card's name and power limit.
"""
import json
import subprocess
import sys

TURN = r'''
import dataclasses, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from fthmc_tpu_torch.schwinger import run_hmc_dyn
dev = torch.device("cuda")
x = cs.near_equilibrium(torch.Generator(device=dev).manual_seed(51), 64, 64,
                        6.0, dev)
for ntraj, seed, timed in ((6, 1, False), (NTRAJ, 2, True)):
    cfg = dataclasses.replace(cs.DYN["A"], ntraj=ntraj)
    t0 = time.perf_counter()
    x, _ = run_hmc_dyn(cfg, x0=x, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
print("S_PER_TRAJ", (time.perf_counter() - t0) / ntraj)
'''


def main() -> None:
    old, new = sys.argv[1], sys.argv[2]
    ntraj = int(sys.argv[3]) if len(sys.argv) > 3 else 24
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for name, tree in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        r = subprocess.run([sys.executable, "-c",
                            TURN.replace("NTRAJ", str(ntraj))],
                           capture_output=True, text=True, cwd=tree)
        got = [ln for ln in r.stdout.splitlines()
               if ln.startswith("S_PER_TRAJ")]
        if r.returncode or not got:
            sys.exit(f"{name} ({tree}) failed:\n{r.stderr[-2000:]}")
        print(json.dumps({"checkout": name, "path": tree,
                          "s_per_traj": float(got[0].split()[1])}),
              flush=True)


if __name__ == "__main__":
    main()
