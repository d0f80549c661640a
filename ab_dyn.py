#!/usr/bin/env python3
"""Two checkouts of the repo timed in turns (first, second, second, first)
on one CUDA card: seconds a trajectory of chip_smoke.py's dynamical paths
A (64^2, beta=6, m=0.1, 64 chains, tau=2, 16 Omelyan steps), B (16^2, 128
chains, 10 steps, the CG on chains-last planes) and C (FT-HMC with the
trained flow, 16^2, 128 chains, tau=0.5, 4 steps, from z0 = f^-1(0)), of
the flagship FT-HMC (the trained flow, 16^2, beta=6, 64 chains, tau=0.5, 8
Omelyan steps, from z0 = f^-1(0)), the plain-HMC headline's
chain-steps/s with 'auto' (K2) and 'fused' (K4) as chip_smoke.py times it
(fthmc_tpu/bench.py's configuration and definition), and kernels' times
(chip_smoke.graph_ms, the card's time, or cuda_ms, CUDA events over
back-to-back wrapper calls): K1 at the FT (16^2 x 64), path A (64^2 x 64),
path B (16^2 x 128) and headline (64^2 x 1024) shapes by graph_ms, K3 at
32^2 x 1024 and K2, K4, K5 at the headline, 25 steps, by cuda_ms:

    python3 ab_dyn.py OLD_CHECKOUT NEW_CHECKOUT [NTRAJ]

Each turn is a process of its own that imports the checkout's
fthmc_tpu_torch and chip_smoke, builds its kernels, and for each path runs
6 trajectories (from near-equilibrium links, or f^-1(0) for C and the
flagship) and times NTRAJ (default 24) more, then times the headline and
the kernels. Prints one JSON line a turn and the card's name and power
limit.
"""
import json
import subprocess
import sys

TURN = r'''
import dataclasses, json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from fthmc_tpu_torch.config import LeapfrogConfig
from fthmc_tpu_torch.hmc import run_fthmc
from fthmc_tpu_torch.models.flow import flow_reverse
from fthmc_tpu_torch.ops import lattice_kernels as lk
from fthmc_tpu_torch.schwinger import run_fthmc_dyn, run_hmc_dyn
from fthmc_tpu_torch.weights import load_flow_npz
dev = torch.device("cuda")
params, spec = load_flow_npz(device=dev)
out = {}
for path, seed in (("A", 51), ("B", 52), ("C", None)):
    base = cs.DYN[path]
    B, L = base.n_chains, base.L
    if seed is None:
        x, _ = flow_reverse(params, torch.zeros((B, 2, L, L), device=dev),
                            spec)
    else:
        x = cs.near_equilibrium(torch.Generator(device=dev).manual_seed(seed),
                                B, L, 6.0, dev)
    for ntraj, s in ((6, 1), (NTRAJ, 2)):
        cfg = dataclasses.replace(base, ntraj=ntraj)
        gen = torch.Generator(device=dev).manual_seed(s)
        t0 = time.perf_counter()
        if seed is None:
            x, _ = run_fthmc_dyn(params, spec, cfg, z0=x, generator=gen,
                                 device=dev)
        else:
            x, _ = run_hmc_dyn(cfg, x0=x, generator=gen, device=dev)
        torch.cuda.synchronize()
    out[f"path_{path}_s_per_traj"] = (time.perf_counter() - t0) / ntraj
z, _ = flow_reverse(params, torch.zeros((cs.B, 2, cs.L, cs.L), device=dev),
                    spec)
lf = LeapfrogConfig(tau=cs.TAU, nstep=cs.NSTEP)
for ntraj, s in ((6, 3), (NTRAJ, 4)):
    gen = torch.Generator(device=dev).manual_seed(s)
    t0 = time.perf_counter()
    z, _ = run_fthmc(params, spec, lf, beta=cs.BETA, ntraj=ntraj, z0=z,
                     generator=gen, integrator="omelyan", device=dev)
    torch.cuda.synchronize()
out["fthmc_s_per_traj"] = (time.perf_counter() - t0) / ntraj
for b in ("auto", "fused"):
    r = cs.headline_rate(dev, b)
    out[f"headline_{b}"] = {k: r[k] for k in ("chain_steps_per_s",
                                              "s_per_traj")}
for name, b, n in (("FT", 64, 16), ("A", 64, 64), ("B", 128, 16),
                   ("headline", 1024, 64)):
    xk = cs.near_equilibrium(torch.Generator(device=dev).manual_seed(53), b,
                             n, 6.0, dev)
    out[f"K1_{name}_graph_ms"] = cs.graph_ms(lambda: lambda: lk.force(xk,
                                                                      6.0))
g = torch.Generator(device=dev).manual_seed(1)
x3 = cs.near_equilibrium(g, 1024, 32, 6.0, dev)
v3 = torch.randn(x3.shape, generator=g, device=dev)
a = (6.0, 0.04, 25)
out["K3_event_ms"] = cs.cuda_ms(lambda: lk.leapfrog_cl(x3, v3, *a))
xh, vh, uh, sh = cs.traj_inputs(g, 1024, 64, dev)
out["K2_event_ms"] = cs.cuda_ms(lambda: lk.leapfrog(xh, vh, *a))
out["K4_event_ms"] = cs.cuda_ms(lambda: lk.hmc_traj(xh, sh, *a))
out["K5_event_ms"] = cs.cuda_ms(lambda: lk.hmc_traj_hostrng(xh, vh, uh, *a))
print("RESULT", json.dumps(out))
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
        got = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
        if r.returncode or not got:
            sys.exit(f"{name} ({tree}) failed:\n{r.stderr[-2000:]}")
        print(json.dumps({"checkout": name, "path": tree,
                          **json.loads(got[0].split(" ", 1)[1])}),
              flush=True)


if __name__ == "__main__":
    main()
