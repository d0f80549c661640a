"""Benchmark functions of the port: leapfrog throughput, FT-HMC, the FT
force's two backends, training steps/s and flow-sampling throughput.

Counterpart of ``fthmc_tpu/bench.py``, with its arguments, defaults, metric
names and units; each function takes ``device`` (the card by default) and
returns the JAX function's dict. Times are host clocks around work that ends
in ``torch.cuda.synchronize()`` (on the card). The FT force's backends are
the port's: 'kernel' (K7, K1, K8) and 'autograd' (the JAX package's 'xla').

Reference baselines (BASELINE.md): the reference runs plain HMC at ~9.3
chain-steps/s at 64^2 (volume-scaled from 12^2 on a CPU) and FT-HMC at
~183 ms a leapfrog step at 8^2 with a 16-layer flow; reverse-KL training
at ~0.52 s a step on a Colab GPU.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig, \
    TrainConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import ft_force, run_fthmc, run_hmc
from fthmc_tpu_torch.models.flow import init_flow_params
from fthmc_tpu_torch.ops.coupling_kernels import kernel_fits
from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel
from fthmc_tpu_torch.sampling import make_mcmc_ensemble
from fthmc_tpu_torch.train import init_train_state, train_era

__all__ = ["bench_hmc_leapfrog", "bench_fthmc_leapfrog",
           "bench_fthmc_flagship", "bench_fthmc_force_backends",
           "bench_train", "bench_flow_sampling", "run_benchmarks"]

# reference CPU leapfrog throughput at 64^2 (chain-steps/s)
BASELINE_LEAPFROG_64 = 9.3
# reference CPU FT-HMC leapfrog at 8^2, 16-layer flow (chain-steps/s)
BASELINE_FT_LEAPFROG_8 = 1.0 / 0.183


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def bench_hmc_leapfrog(L: int = 64, chains: int = 1024, beta: float = 6.0,
                       nstep: int = 25, tau: float = 1.0, ntraj: int = 20,
                       repeats: int = 5, device=None) -> dict:
    """Plain-HMC leapfrog chain-steps/s from a cold start (dt = 0.04 keeps
    acceptance high at 64^2, beta=6): a warm-up run, then ``repeats`` runs
    of ``ntraj`` chained trajectories, the median timed."""
    device = resolve_device(device)
    cfg = HMCConfig(beta=beta, L=L, tau=tau, nstep=nstep, ntraj=ntraj,
                    n_chains=chains, randinit=False, seed=0)
    x, hist = run_hmc(cfg, device=device)
    _sync(device)
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        x, hist = run_hmc(cfg, x0=x, generator=_gen(device, 1000 + i),
                          device=device)
        _sync(device)
        times.append(time.perf_counter() - t0)
    val = chains * ntraj * nstep / float(np.median(times))
    return {
        "metric": f"hmc_leapfrog_chain_steps_per_sec_L{L}",
        "value": val,
        "unit": "chain-steps/s/chip",
        "vs_baseline": val / BASELINE_LEAPFROG_64,
        "acc": float(hist.acc.mean()),
    }


def bench_fthmc_leapfrog(L: int = 8, chains: int = 1024, beta: float = 2.0,
                         n_layers: int = 16, nstep: int = 64,
                         ntraj: int = 4, repeats: int = 3,
                         force_backend: str = "autograd",
                         device=None) -> dict:
    """FT-HMC leapfrog chain-steps/s of a fresh 16-layer ncp flow, the force
    by ``force_backend`` ('autograd', the JAX package's default 'xla'
    path, or 'kernel')."""
    device = resolve_device(device)
    spec = FlowSpec(n_layers=n_layers, n_mixture=2, hidden_sizes=(8, 8))
    params = init_flow_params(spec, _gen(device, 0), device=device)
    lf = LeapfrogConfig(tau=1.0, nstep=nstep)
    z0 = lattice.hot_start(_gen(device, 1), chains, L, device=device)
    z, _ = run_fthmc(params, spec, lf, beta=beta, ntraj=ntraj, z0=z0,
                     generator=_gen(device, 2), force_backend=force_backend,
                     device=device)
    _sync(device)
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        z, _ = run_fthmc(params, spec, lf, beta=beta, ntraj=ntraj, z0=z,
                         generator=_gen(device, 3 + i),
                         force_backend=force_backend, device=device)
        _sync(device)
        times.append(time.perf_counter() - t0)
    val = chains * ntraj * nstep / float(np.median(times))
    return {
        "metric": f"fthmc_leapfrog_chain_steps_per_sec_L{L}",
        "value": val,
        "unit": "chain-steps/s/chip",
        "force_backend": force_backend,
        "vs_baseline": val / BASELINE_FT_LEAPFROG_8,
    }


def bench_fthmc_flagship(L: int = 16, chains: int = 64, beta: float = 6.0,
                         nstep: int = 8, tau: float = 0.5, ntraj: int = 4,
                         repeats: int = 3, conv_dtype: str | None = None,
                         force_backend: str = "auto", device=None) -> dict:
    """FT-HMC chain-steps/s of the flagship architecture (24-layer rncp,
    hidden (32, 32), 8 components, s_clip 3, Omelyan) with fresh weights
    (the cost does not depend on their values), from z0 = 0, the force
    through ``force_backend`` ('auto' is the kernels on the card, which
    refuse conv_dtype='bfloat16': the bf16 recipe names 'autograd')."""
    device = resolve_device(device)
    spec = FlowSpec(n_layers=24, n_mixture=8, hidden_sizes=(32, 32),
                    coupling="rncp", s_clip=3.0)
    if conv_dtype is not None:
        spec = dataclasses.replace(spec, conv_dtype=conv_dtype)
    params = init_flow_params(spec, _gen(device, 0), device=device)
    lf = LeapfrogConfig(tau=tau, nstep=nstep)
    z0 = torch.zeros((chains, 2, L, L), device=device)
    z, _ = run_fthmc(params, spec, lf, beta=beta, ntraj=ntraj, z0=z0,
                     generator=_gen(device, 2), integrator="omelyan",
                     force_backend=force_backend, device=device)
    _sync(device)
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        z, _ = run_fthmc(params, spec, lf, beta=beta, ntraj=ntraj, z0=z,
                         generator=_gen(device, 3 + i), integrator="omelyan",
                         force_backend=force_backend, device=device)
        _sync(device)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    return {
        "metric": f"fthmc_flagship_chain_steps_per_sec_L{L}",
        "value": chains * ntraj * nstep / dt,
        "unit": "chain-steps/s/chip",
        "s_per_traj": dt / ntraj,
        "conv_dtype": conv_dtype or "float32",
        "chains": chains,
        "nstep": nstep,
    }


def bench_fthmc_force_backends(L: int = 16, chains: int = 128,
                               beta: float = 2.0, n_layers: int = 16,
                               n_mixture: int = 6, hidden=(8, 8),
                               coupling: str = "rncp", reps: int = 30,
                               device=None) -> dict:
    """The FT-HMC force by force_backend='autograd' against 'kernel' (the
    JAX package's 'xla' against its Pallas kernels), the state chained
    between repeats. 'kernel' is timed only where the kernels take the
    spec and shape (``kernel_fits``)."""
    device = resolve_device(device)
    spec = FlowSpec(n_layers=n_layers, n_mixture=n_mixture,
                    hidden_sizes=tuple(hidden), coupling=coupling,
                    s_clip=3.0)
    params = init_flow_params(spec, _gen(device, 0), device=device)
    z = lattice.hot_start(_gen(device, 1), chains, L, device=device)

    def timed(fn):
        zz = z
        fn(zz)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            zz = zz + 1e-6 * fn(zz)
        _sync(device)
        return (time.perf_counter() - t0) / reps

    ta = timed(lambda zz: ft_force(params, spec, zz, beta, device=device))
    fits = kernel_fits(spec, L, chains)
    tk = timed(lambda zz: ft_force_kernel(params, spec, zz, beta)) \
        if fits else None
    return {
        "metric": f"fthmc_force_ms_L{L}_layers{n_layers}",
        "autograd_ms": ta * 1e3,
        "kernel_ms": tk * 1e3 if fits else None,
        "speedup": ta / tk if fits else None,
        "kernel_gated_off": not fits,
        "config": {"L": L, "chains": chains, "n_layers": n_layers,
                   "hidden": tuple(hidden), "n_mixture": n_mixture,
                   "coupling": coupling},
    }


def bench_train(L: int = 8, batch: int = 64, beta: float = 2.0,
                n_layers: int = 16, steps: int = 100, device=None) -> dict:
    """Reverse-KL training steps/s through ``train_era`` (a warm-up era,
    then one timed era of ``steps`` steps)."""
    device = resolve_device(device)
    spec = FlowSpec(n_layers=n_layers, n_mixture=2, hidden_sizes=(8, 8))
    cfg = TrainConfig(L=L, beta=beta, batch_size=batch, flow=spec, seed=0)
    state = init_train_state(_gen(device, 0), cfg, device=device)
    state, _ = train_era(state, spec, batch, L, beta, 1.0, cfg.base_lr,
                         steps)
    _sync(device)
    t0 = time.perf_counter()
    state, _ = train_era(state, spec, batch, L, beta, 1.0, cfg.base_lr,
                         steps)
    _sync(device)
    sps = steps / (time.perf_counter() - t0)
    return {
        "metric": f"train_steps_per_sec_L{L}_b{batch}",
        "value": sps,
        "unit": "steps/s/chip",
        "vs_baseline": sps / (1.0 / 0.52),
    }


def bench_flow_sampling(L: int = 8, n_chains: int = 64,
                        batch_size: int = 64, beta: float = 2.0,
                        n_layers: int = 16, num_samples: int = 512,
                        repeats: int = 3, device=None) -> dict:
    """Multi-chain independence-Metropolis throughput (chain-samples/s) of
    a fresh 16-layer ncp flow, the proposals through K6 on the card."""
    device = resolve_device(device)
    spec = FlowSpec(n_layers=n_layers, n_mixture=2, hidden_sizes=(8, 8))
    params = init_flow_params(spec, _gen(device, 0), device=device)

    def run(seed):
        return make_mcmc_ensemble(params, spec, beta=beta, L=L,
                                  batch_size=batch_size,
                                  num_samples=num_samples,
                                  generator=_gen(device, seed),
                                  n_chains=n_chains, device=device)

    hist = run(1)
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        hist = run(2 + i)
        times.append(time.perf_counter() - t0)
    val = n_chains * num_samples / float(np.median(times))
    return {
        "metric": f"flow_sampling_samples_per_sec_L{L}_K{n_chains}",
        "value": val,
        "unit": "chain-samples/s/chip",
        "accept_rate": float(np.mean(hist["acc"])),
    }


def run_benchmarks(L: int = 64, chains: int = 1024, beta: float = 6.0,
                   which: str = "hmc", device=None) -> dict:
    """The benchmarks named by ``which`` ('hmc', 'fthmc', 'train', 'sample'
    or 'all'), each printed as it ends."""
    out = {}
    if which in ("hmc", "all"):
        out["hmc"] = bench_hmc_leapfrog(L=L, chains=chains, beta=beta,
                                        device=device)
        print(out["hmc"])
    if which in ("fthmc", "all"):
        out["fthmc"] = bench_fthmc_leapfrog(device=device)
        print(out["fthmc"])
    if which in ("train", "all"):
        out["train"] = bench_train(device=device)
        print(out["train"])
    if which in ("sample", "all"):
        out["sample"] = bench_flow_sampling(device=device)
        print(out["sample"])
    return out
