"""Topological-mobility probe: a fixed-budget timed burst for selecting flow
candidates on wall-clock mobility.

Counterpart of ``fthmc_tpu/mobility.py``. Acceptance and ESS are the wrong
selection metrics for flows: a smoother flow can accept more and still move
topology more slowly. Wall-clock mobility, B*mob/s (tunnelling events a
wall-second over the chain ensemble), is the right one.

  - ``mobility_stats`` reduces a (ntraj, n_chains) topological-charge series
    to the mobility a trajectory, with a chain-bootstrap error and the
    count of tunnelling events;
  - ``mobility_probe`` runs a short timed FT-HMC or HMC burst (quenched or
    two-flavour Schwinger) on the port's samplers and returns B*mob/s +-
    err. On the card the samplers launch the port's kernels (K6-K8 and K1
    for FT-HMC, K1 for the plain Omelyan step, K11 for the solves).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from fthmc_tpu_torch.config import HMCConfig, LeapfrogConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import run_fthmc, run_hmc
from fthmc_tpu_torch.models.flow import flow_reverse
from fthmc_tpu_torch.schwinger import (SchwingerConfig, run_fthmc_dyn,
                                       run_hmc_dyn)

__all__ = ["mobility_stats", "mobility_probe"]


def mobility_stats(q, *, s_per_traj: float | None = None, n_boot: int = 400,
                   seed: int = 0) -> dict[str, Any]:
    """Mobility summary of a (ntraj, n_chains) topological-charge series
    (numpy or a tensor).

    mobility = mean |Q_{t+1} - Q_t|^2 a trajectory. Error: bootstrap over
    the chains of the per-chain means (chains are independent); one chain
    takes the Poisson error of its events. n_events counts the exact
    transitions (ntraj - 1 a chain). With s_per_traj, adds the wall-clock
    metric B_mob_per_s = mobility * n_chains / s_per_traj.
    """
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    q = np.asarray(q, dtype=np.float64)
    if q.ndim == 1:
        q = q[:, None]
    dq2 = np.abs(np.diff(q, axis=0)) ** 2          # (ntraj-1, B)
    if dq2.shape[0] == 0:
        raise ValueError("need >= 2 trajectories for a mobility estimate")
    per_chain = dq2.mean(axis=0)                   # (B,)
    mob = float(per_chain.mean())
    nchain = per_chain.shape[0]
    if nchain > 1:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, nchain, size=(n_boot, nchain))
        err = float(per_chain[idx].mean(axis=1).std(ddof=1))
    else:
        nev = max(dq2.sum(), 1.0)
        err = mob / float(np.sqrt(nev))
    out = {
        "mobility": mob,
        "mobility_err": err,
        "n_events": float(dq2.sum()),
        "n_chains": nchain,
        "ntraj": int(q.shape[0]),
    }
    if s_per_traj is not None:
        out["s_per_traj"] = float(s_per_traj)
        out["B_mob_per_s"] = mob * nchain / s_per_traj
        out["B_mob_per_s_err"] = err * nchain / s_per_traj
    return out


def _runner(params, spec, *, L, beta, mass, n_chains, tau, nstep,
            cg_maxiter, sampler, generator, device):
    """run(z, n) -> (z, TrajMetrics) of the probe's sampler."""
    if mass > 0.0:
        cfg = SchwingerConfig(L=L, beta=beta, mass=mass, tau=tau,
                              nstep=nstep, n_chains=n_chains, ntraj=0,
                              cg_maxiter=cg_maxiter)
        if sampler == "ft":
            def run(z, n):
                return run_fthmc_dyn(params, spec,
                                     dataclasses.replace(cfg, ntraj=n), z0=z,
                                     generator=generator, device=device)
        else:
            def run(z, n):
                return run_hmc_dyn(dataclasses.replace(cfg, ntraj=n), x0=z,
                                   generator=generator, device=device)
        return run
    if sampler == "ft":
        lf = LeapfrogConfig(tau=tau, nstep=nstep)

        def run(z, n):
            return run_fthmc(params, spec, lf, beta=beta, ntraj=n, z0=z,
                             generator=generator, integrator="omelyan",
                             device=device)
    else:
        cfg = HMCConfig(beta=beta, L=L, tau=tau, nstep=nstep, ntraj=0,
                        n_chains=n_chains)

        def run(z, n):
            return run_hmc(dataclasses.replace(cfg, ntraj=n), x0=z,
                           generator=generator, integrator="omelyan",
                           device=device)
    return run


def mobility_probe(params, spec, *, L: int, beta: float, mass: float = 0.0,
                   n_chains: int = 128, ntraj: int = 768, therm: int = 256,
                   tau: float = 0.5, nstep: int = 4,
                   generator: torch.Generator | None = None,
                   call_block: int = 256, cg_maxiter: int = 1500,
                   sampler: str = "ft", min_events: float = 0.0,
                   max_extra_blocks: int = 0, on_block=None,
                   device=None) -> dict[str, Any]:
    """Fixed-budget timed mobility burst for a flow candidate, on
    ``device`` (the card by default), drawing from ``generator`` (one on
    the device seeded with 0 by default).

    sampler='ft' runs FT-HMC with (params, spec) (the kernel force);
    sampler='plain' ignores the flow and runs plain HMC ('xla' Omelyan
    steps, K1 on the card). mass > 0 runs the two-flavour Schwinger
    samplers; mass == 0 the quenched ones.

    Cold start (ft: the latents f^-1 of unit links; plain: unit links), at
    least ``therm`` untimed trajectories, then ``ntraj`` timed ones, both in
    blocks of min(call_block, ntraj) trajectories (ntraj rounds up to whole
    blocks): the untimed blocks are the warm-up too, so kernel builds and
    first launches stay out of s_per_traj, and each timed block ends with a
    synchronize inside its timed region. With min_events > 0 the timed
    segment extends by up to max_extra_blocks blocks until the event floor
    is met; a row below it is flagged valid=False. ``on_block(hist)``, if
    given, receives each timed block's TrajMetrics (on the device) after
    its timed region.

    Returns mobility_stats(...) plus acc, plaq, valid and the run's
    parameters.
    """
    if sampler not in ("ft", "plain"):
        raise ValueError(f"unknown sampler {sampler!r}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    run = _runner(params, spec, L=L, beta=beta, mass=mass,
                  n_chains=n_chains, tau=tau, nstep=nstep,
                  cg_maxiter=cg_maxiter, sampler=sampler,
                  generator=generator, device=device)

    z = torch.zeros((n_chains, 2, L, L), dtype=torch.float32, device=device)
    if sampler == "ft":
        z = flow_reverse(params, z, spec)[0]

    block = min(call_block, ntraj)
    n_blocks = -(-ntraj // block)
    ntraj = n_blocks * block

    def advance(z, n_blk, timed):
        """n_blk blocks; timed ones are timed and kept."""
        hs, wall = [], 0.0
        for _ in range(n_blk):
            t0 = time.perf_counter()
            z, h = run(z, block)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if timed:
                wall += time.perf_counter() - t0
                hs.append(h)
                if on_block is not None:
                    on_block(h)
        return z, hs, wall

    z, _, _ = advance(z, max(-(-therm // block), 1), timed=False)
    z, hs, wall = advance(z, n_blocks, timed=True)

    def reduce(hs, wall, n):
        def cat(name):
            return torch.cat([getattr(h, name) for h in hs]).cpu().numpy()
        st = mobility_stats(cat("q"), s_per_traj=wall / n)
        st["acc"] = float(cat("acc").mean())
        st["plaq"] = float(cat("plaq").mean())
        return st

    n_timed = ntraj
    st = reduce(hs, wall, n_timed)
    extra = 0
    while (min_events > 0 and st["n_events"] < min_events
           and extra < max_extra_blocks):
        z, hs2, w2 = advance(z, 1, timed=True)
        hs.extend(hs2)
        wall += w2
        n_timed += block
        extra += 1
        st = reduce(hs, wall, n_timed)
    st["valid"] = bool(min_events <= 0 or st["n_events"] >= min_events)
    st["beta"], st["mass"], st["L"] = float(beta), float(mass), int(L)
    st["tau"], st["nstep"], st["sampler"] = float(tau), int(nstep), sampler
    return st
