"""Partial-trivialization demo: FT-HMC at beta = 4/5/6 on 16^2 with the
8^2-trained beta=3 flow, unchanged (the exported
``fthmc_tpu_torch/data/flow8x8_b3_rncp24.npz``).

Counterpart of the JAX package's ``examples/demo_highbeta.py``: a smooth
flow trained at a lower beta integrates well at a higher one, where it
only flattens the landscape and the Metropolis step corrects the rest.
From a hot start, ``run_fthmc_chunked`` in blocks of 16 Omelyan
trajectories, the force through the kernels on the card (K7, K1, K8; K6
for the energies):

    python -m fthmc_tpu_torch.examples.demo_highbeta [--beta 6.0] [--ntraj 128]

``--ckpt`` takes another exported flow of the same architecture; a path
that does not exist raises.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.diagnostics import _host as host
from fthmc_tpu_torch.hmc import run_fthmc_chunked
from fthmc_tpu_torch.weights import DATA_DIR, load_flow_npz

# the JAX demo's architecture (24-layer rncp, hidden (32, 32), 8
# components, s_clip 3) and its run's block
SPEC = FlowSpec(n_layers=24, coupling="rncp", n_mixture=8,
                hidden_sizes=(32, 32), s_clip=3.0)
BLOCK = 16
DEFAULT_CKPT = str(DATA_DIR / "flow8x8_b3_rncp24.npz")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fthmc_tpu_torch.examples.demo_highbeta",
        description="FT-HMC at high beta with the beta=3 flow, unchanged")
    p.add_argument("--beta", type=float, default=6.0)
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--ntraj", type=int, default=128)
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--nstep", type=int, default=128)
    p.add_argument("--ckpt", default=DEFAULT_CKPT,
                   help="exported flow (.npz) of the demo's architecture")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    return p


def load_flow(path, device=None):
    """(params, spec) of the exported flow at ``path``, read as the demo's
    architecture (``SPEC``; the arrays must fit it)."""
    return load_flow_npz(path, device=device,
                         spec_overrides=dataclasses.asdict(SPEC))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    params, spec = load_flow(args.ckpt, device)
    print(f"beta=3 flow restored ({args.ckpt}); running FT-HMC at "
          f"{args.L}^2 beta={args.beta}", flush=True)

    lf = LeapfrogConfig(tau=1.0, nstep=args.nstep)
    z0 = lattice.hot_start(torch.Generator(device).manual_seed(1),
                           args.chains, args.L, device=device)
    z, h = run_fthmc_chunked(params, spec, lf, beta=args.beta,
                             ntraj=args.ntraj, z0=z0,
                             generator=torch.Generator(device).manual_seed(2),
                             block=BLOCK, integrator="omelyan", device=device)
    t = args.ntraj // 4
    q = host(h.q)[t:]
    out = {"beta": args.beta, "L": args.L, "chains": args.chains,
           "ntraj": args.ntraj, "nstep": args.nstep, "therm": t,
           "acc": float(host(h.acc)[t:].mean()),
           "exp_mdh": float(host(h.exp_mdh)[t:].mean()),
           "plaq": float(host(h.plaq)[t:].mean()),
           "plaq_exact": lattice.PLAQ_EXACT.get(args.beta),
           "chi_q": float(np.mean(q ** 2)),
           "q_mobility": float(np.mean((q[1:] - q[:-1]) ** 2))}
    print(f"acc      = {out['acc']:.3f}")
    print(f"<exp-dH> = {out['exp_mdh']:.4f}  (exact: 1)")
    print(f"<plaq>   = {out['plaq']:.5f}  (exact: {out['plaq_exact']})")
    print(f"chi_Q    = {out['chi_q']:.3f}")
    print(f"Q mobility <(dQ)^2> = {out['q_mobility']:.3f} "
          "per trajectory (plain HMC at beta=6: ~0.002)")
    return out


if __name__ == "__main__":
    main()
