"""Benchmark functions of the port: leapfrog throughput, FT-HMC, the FT
force's two backends, training steps/s and flow-sampling throughput; and
the one-line benchmark entry, ``python -m fthmc_tpu_torch.bench``.

Counterpart of ``fthmc_tpu/bench.py``, with its arguments, defaults, metric
names and units; each function takes ``device`` (the card by default) and
returns the JAX function's dict. Times are host clocks around work that ends
in a wait for the card (``_sync``: a CUDA event polled from Python, so a
SIGALRM watchdog can interrupt a hang). The FT force's backends are the
port's: 'kernel' (K7, K1, K8) and 'autograd' (the JAX package's 'xla').

The entry (``main``) is the counterpart of the JAX package's root
``bench.py``: one JSON line on stdout, the plain-HMC headline
(``bench_hmc_leapfrog`` at 64^2, 1024 chains, beta=6, 25 steps, 20
trajectories), flushed before anything else runs; then the flagship
FT-HMC extras (16^2 fp32 through the kernels, 64^2 with bf16 convs through
the autograd force, which the kernels refuse) under a watchdog, reported
on stderr and, with ``--extra-json PATH``, in that file. An extra that
fails or times out makes the process exit 1 after the headline is out.

Reference baselines (BASELINE.md): the reference runs plain HMC at ~9.3
chain-steps/s at 64^2 (volume-scaled from 12^2 on a CPU) and FT-HMC at
~183 ms a leapfrog step at 8^2 with a 16-layer flow; reverse-KL training
at ~0.52 s a step on a Colab GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
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
           "bench_train", "bench_flow_sampling", "run_benchmarks",
           "build_parser", "main"]

# reference CPU leapfrog throughput at 64^2 (chain-steps/s)
BASELINE_LEAPFROG_64 = 9.3
# reference CPU FT-HMC leapfrog at 8^2, 16-layer flow (chain-steps/s)
BASELINE_FT_LEAPFROG_8 = 1.0 / 0.183


def _sync(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream: an event
    recorded there and queried until it completes. Python runs signal
    handlers between these queries, so the entry's watchdog can end a hung
    wait, which a blocking ``torch.cuda.synchronize()`` would not let it
    do."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        while not ev.query():
            pass


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


# ---------------------------------------------------------------------------
# the one-line benchmark entry
# ---------------------------------------------------------------------------

HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fthmc_tpu_torch.bench",
        description="Plain-HMC headline as one JSON line on stdout, then "
                    "the flagship FT-HMC extras on stderr.")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    g = ap.add_argument_group("the headline (bench_hmc_leapfrog)")
    g.add_argument("--L", type=int, default=64)
    g.add_argument("--chains", type=int, default=1024)
    g.add_argument("--ntraj", type=int, default=20)
    g.add_argument("--repeats", type=int, default=5)
    g = ap.add_argument_group("the flagship extras (bench_fthmc_flagship)")
    g.add_argument("--ft-L", type=int, default=16)
    g.add_argument("--ft-chains", type=int, default=64)
    g.add_argument("--ft-nstep", type=int, default=8,
                   help="Omelyan steps of both extras")
    g.add_argument("--ft-ntraj", type=int, default=4)
    g.add_argument("--ft-repeats", type=int, default=3,
                   help="timed repeats of both extras")
    g.add_argument("--bf16-L", type=int, default=64)
    g.add_argument("--bf16-chains", type=int, default=32)
    g.add_argument("--bf16-ntraj", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=1200,
                    help="watchdog over the extras, seconds")
    ap.add_argument("--extra-json", default=None, metavar="PATH",
                    help="write the headline's and the extras' dicts here")
    return ap


def _extras(args, device) -> list:
    """(key, label, bench_fthmc_flagship keywords) of the two extras: the
    fp32 recipe through the kernels ('auto') and the bf16 recipe, which
    names the autograd force."""
    common = dict(nstep=args.ft_nstep, repeats=args.ft_repeats,
                  device=device)
    return [(f"fthmc_flagship_L{args.ft_L}",
             f"flagship FT {args.ft_L}^2 fp32",
             dict(L=args.ft_L, chains=args.ft_chains, ntraj=args.ft_ntraj,
                  **common)),
            (f"fthmc_flagship_L{args.bf16_L}_bf16",
             f"flagship FT {args.bf16_L}^2 bf16",
             dict(L=args.bf16_L, chains=args.bf16_chains,
                  ntraj=args.bf16_ntraj, conv_dtype="bfloat16",
                  force_backend="autograd", **common))]


def main(argv=None) -> int:
    """The headline line on stdout, then the extras under the watchdog;
    returns the exit status: 0, or 1 when an extra failed or timed out
    (its error is in the extras record and on stderr)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    r = bench_hmc_leapfrog(L=args.L, chains=args.chains, beta=6.0,
                           nstep=25, ntraj=args.ntraj, repeats=args.repeats,
                           device=device)
    print(json.dumps({k: r[k] for k in HEADLINE_KEYS}), flush=True)
    extra = {"headline": r}
    failed = False

    def _alarm(signum, frame):
        raise TimeoutError(f"flagship bench watchdog ({args.timeout} s)")

    old = signal.signal(signal.SIGALRM, _alarm)
    try:
        signal.alarm(args.timeout)
        for key, label, kw in _extras(args, device):
            f = bench_fthmc_flagship(**kw)
            print(f"{label}: {f['value']:.3g} chain-steps/s "
                  f"({f['s_per_traj'] * 1e3:.1f} ms/traj)", file=sys.stderr)
            extra[key] = f
    except Exception as e:  # the watchdog's TimeoutError included
        failed = True
        extra["fthmc_flagship_error"] = f"{type(e).__name__}: {e}"
        print(f"flagship FT bench failed: {extra['fthmc_flagship_error']}",
              file=sys.stderr)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    if args.extra_json:
        with open(args.extra_json, "w") as fh:
            json.dump(extra, fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
