"""Entry points: one FT-HMC step on a small flow, and a dry run of the
parallel drivers on n ranks.

Counterpart of the JAX package's ``__graft_entry__.py``:

- ``entry(device=None)`` returns ``(fn, args)``: ``fn(*args)`` is one
  batched FT-HMC trajectory (flow forward, the force's leapfrog,
  Metropolis) of a 4-layer ncp flow, hidden (8, 8), on 4 chains of 8^2,
  beta=2, dt=0.1, 4 steps; ``args`` are the flow parameters (seed 0), the
  step's generator (seed 1), z uniform in (-3, 3) (seed 2) and the charge
  q0 = 0. The force is ``force_backend='auto'``: K7, K1 and K8 on the card.
- ``dryrun_multichip(n, device=None)`` runs the sequence of the JAX dry
  run on n ranks with the port's ``parallel`` drivers, each stage with the
  JAX asserts (step counts, shapes, finite dH): the data-parallel training
  step and era, the chain-sharded FT-HMC step and whole runs (plain, FT,
  dynamical plain and FT), and the row-sharded FT step and whole runs
  (plain, FT, dynamical plain and FT, chunked). With ``device="cpu"`` it
  spawns n gloo ranks (``parallel.launch.spawn``); on the card it runs on
  the process group already initialized, or makes a group of one NCCL rank
  when n == 1. JAX moves to virtual CPU devices by itself; here the caller
  asks for the CPU.

    python -m fthmc_tpu_torch.entry                 # the card, one rank
    torchrun --nproc-per-node=N -m fthmc_tpu_torch.entry
    python -m fthmc_tpu_torch.entry --device cpu    # one gloo rank

``dryrun_multichip(n, device="cpu")`` runs n gloo ranks from Python.
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import (FlowSpec, HMCConfig, LeapfrogConfig,
                                    TrainConfig)
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import fthmc_step
from fthmc_tpu_torch.models.flow import init_flow_params

__all__ = ["ENTRY_SPEC", "entry", "dryrun_multichip"]

# the step of entry(): the flow, chains, L, beta, dt, leapfrog steps
ENTRY_SPEC = FlowSpec(n_layers=4, n_mixture=2, hidden_sizes=(8, 8))
ENTRY_CHAINS, ENTRY_L, ENTRY_BETA, ENTRY_DT, ENTRY_NSTEP = 4, 8, 2.0, 0.1, 4


def entry(device=None):
    """(fn, args): fn(params, generator, z, q0) -> (z', y', q', metrics),
    one FT-HMC trajectory on ``device`` (the card by default)."""
    device = resolve_device(device)
    spec = ENTRY_SPEC
    params = init_flow_params(spec, torch.Generator(device).manual_seed(0),
                              device=device)
    generator = torch.Generator(device).manual_seed(1)
    z = torch.empty((ENTRY_CHAINS, 2, ENTRY_L, ENTRY_L), device=device)
    z.uniform_(-3.0, 3.0, generator=torch.Generator(device).manual_seed(2))
    q0 = torch.zeros((ENTRY_CHAINS,), device=device)

    def fn(params, generator, z, q0):
        return fthmc_step(params, spec, generator, z, q0, ENTRY_BETA,
                          ENTRY_DT, ENTRY_NSTEP, device=device)

    return fn, (params, generator, z, q0)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _finite(t) -> bool:
    return bool(torch.isfinite(torch.as_tensor(t)).all())


def _dryrun_impl(n_devices: int, device=None) -> dict:
    """The dry run on this rank of an initialized group of n_devices ranks;
    returns {stage: max |dH| over its trajectories} (training stages: the
    last loss)."""
    from fthmc_tpu_torch.parallel.domain import (make_rows_mesh,
                                                 run_domain_hmc, shard_rows)
    from fthmc_tpu_torch.parallel.domain_fermion import (
        run_domain_fthmc_dyn_chunked, run_domain_hmc_dyn_chunked)
    from fthmc_tpu_torch.parallel.domain_flow import (make_domain_fthmc_step,
                                                      run_domain_fthmc)
    from fthmc_tpu_torch.parallel.mesh import (make_chain_mesh, replicate,
                                               shard_chains,
                                               sharded_fthmc_step,
                                               sharded_run_fthmc,
                                               sharded_run_fthmc_dyn,
                                               sharded_run_hmc,
                                               sharded_run_hmc_dyn,
                                               sharded_train_era,
                                               sharded_train_step)
    from fthmc_tpu_torch.schwinger import SchwingerConfig
    from fthmc_tpu_torch.train import init_train_state

    mesh = make_chain_mesh(n_devices, device=device)
    dev = mesh.device

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    spec = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,))
    batch = 2 * n_devices
    out = {}

    # the training step: the batch sharded over the mesh, the parameters
    # replicated, the gradients averaged in one all-reduce
    cfg = TrainConfig(L=8, beta=2.0, batch_size=batch, flow=spec, seed=0)
    state = replicate(mesh, init_train_state(gen(0), cfg, device=dev))
    tstep = sharded_train_step(mesh, spec, batch=batch, L=cfg.L,
                               beta=cfg.beta, dkl_factor=1.0,
                               base_lr=cfg.base_lr)
    state, metrics = tstep(state)
    _check(int(state.step) == 1, f"train step count {int(state.step)}")
    out["train_step"] = float(metrics["loss_dkl"])

    # an FT-HMC step with the chains sharded
    z_global = lattice.hot_start(gen(1), batch, 8, device=dev)
    z = shard_chains(mesh, z_global)
    q = shard_chains(mesh, torch.zeros((batch,), device=dev))
    fstep = sharded_fthmc_step(mesh, spec, beta=2.0, dt=0.1, nstep=2)
    _, _, _, m = fstep(state.params, gen(2), z, q)
    _check(_finite(m.dh), "sharded FT step dH not finite")
    out["fthmc_step"] = float(m.dh.abs().max())

    # an FT-HMC step with the lattice rows sharded: halo exchanges through
    # the stencils and the flow's convolutions
    L0 = 2 * n_devices
    rows = make_rows_mesh(n_devices, device=device)
    dstep = make_domain_fthmc_step(rows, spec, beta=2.0, dt=0.1, nstep=2,
                                   L0=L0)
    zr_global = lattice.hot_start(gen(3), 2, L0, device=dev)
    zr = shard_rows(rows, zr_global)
    _, _, (dh, _) = dstep(state.params, gen(4), zr,
                          torch.zeros((2,), device=dev))
    _check(_finite(dh), "row-sharded FT step dH not finite")
    out["domain_fthmc_step"] = float(dh.abs().max())

    # the whole-run drivers and a training era, chain-sharded
    hcfg = HMCConfig(beta=2.0, L=8, tau=0.5, nstep=3, ntraj=4,
                     n_chains=batch, randinit=True, seed=0)
    _, hh = sharded_run_hmc(mesh, hcfg)
    _check(tuple(hh.plaq.shape) == (4, batch), f"hmc plaq {hh.plaq.shape}")
    _check(_finite(hh.dh), "sharded hmc dH not finite")
    out["run_hmc"] = float(hh.dh.abs().max())
    lf = LeapfrogConfig(tau=0.5, nstep=2)
    _, hf = sharded_run_fthmc(mesh, state.params, spec, lf, beta=2.0,
                              ntraj=3, z0=z_global, generator=gen(5))
    _check(tuple(hf.acc.shape) == (3, batch), f"fthmc acc {hf.acc.shape}")
    out["run_fthmc"] = float(hf.dh.abs().max())
    st2, ms = sharded_train_era(mesh, state, spec, batch=batch, L=cfg.L,
                                beta=cfg.beta, n_epoch=2)
    _check(int(st2.step) == int(state.step) + 2,
           f"train era step count {int(st2.step)}")
    _check(_finite(ms["loss_dkl"]), "train era loss not finite")
    out["train_era"] = float(ms["loss_dkl"][-1])

    # the whole-run drivers, row-sharded
    dcfg = HMCConfig(beta=2.0, L=L0, tau=0.5, nstep=3, ntraj=4,
                     n_chains=2, randinit=True, seed=1)
    _, hd = run_domain_hmc(rows, dcfg)
    _check(tuple(hd["acc"].shape) == (4, 2), f"domain hmc acc "
           f"{hd['acc'].shape}")
    _check(_finite(hd["dh"]), "domain hmc dH not finite")
    out["domain_hmc"] = float(hd["dh"].abs().max())
    _, hfd = run_domain_fthmc(rows, state.params, spec, lf, beta=2.0,
                              ntraj=3, z0=zr_global, generator=gen(6))
    _check(tuple(hfd["acc"].shape) == (3, 2), f"domain fthmc acc "
           f"{hfd['acc'].shape}")
    _check(_finite(hfd["dh"]), "domain fthmc dH not finite")
    out["domain_fthmc"] = float(hfd["dh"].abs().max())

    # dynamical fermions, chain-sharded: each rank solves its own chains
    scfg = SchwingerConfig(L=8, beta=2.0, mass=0.3, tau=0.5, nstep=2,
                           n_chains=batch, ntraj=2, cg_tol_force=1e-8,
                           cg_tol_mh=1e-10, cg_maxiter=200)
    _, hs = sharded_run_hmc_dyn(mesh, scfg, generator=gen(7))
    _check(tuple(hs.acc.shape) == (2, batch), f"hmc_dyn acc {hs.acc.shape}")
    _check(_finite(hs.dh), "sharded hmc_dyn dH not finite")
    out["run_hmc_dyn"] = float(hs.dh.abs().max())
    _, hfs = sharded_run_fthmc_dyn(mesh, state.params, spec, scfg,
                                   z0=z_global, generator=gen(8))
    _check(_finite(hfs.dh), "sharded fthmc_dyn dH not finite")
    out["run_fthmc_dyn"] = float(hfs.dh.abs().max())

    # dynamical fermions, row-sharded through the Dirac operator and the
    # CG, then through the flow as well
    dfcfg = SchwingerConfig(L=L0, beta=2.0, mass=0.3, tau=0.5, nstep=2,
                            n_chains=2, ntraj=2, cg_tol_force=1e-8,
                            cg_tol_mh=1e-10, cg_maxiter=200)
    _, hdf = run_domain_hmc_dyn_chunked(rows, dfcfg, block=2,
                                        generator=gen(9))
    _check(tuple(hdf["acc"].shape) == (2, 2), f"domain hmc_dyn acc "
           f"{hdf['acc'].shape}")
    _check(_finite(hdf["dh"]), "domain hmc_dyn dH not finite")
    out["domain_hmc_dyn"] = float(hdf["dh"].abs().max())
    _, hft = run_domain_fthmc_dyn_chunked(rows, state.params, spec, dfcfg,
                                          block=2, generator=gen(10))
    _check(_finite(hft["dh"]), "domain fthmc_dyn dH not finite")
    out["domain_fthmc_dyn"] = float(hft["dh"].abs().max())
    return out


def _gloo_rank(rank: int, n_devices: int) -> dict:
    return _dryrun_impl(n_devices, device="cpu")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run on n_devices ranks: gloo ranks spawned on the CPU when
    ``device="cpu"``; else on the card, on the process group already
    initialized (of n_devices ranks) or, for n_devices == 1, on a group of
    one NCCL rank made here and destroyed after. Returns rank 0's
    {stage: max |dH|} (training stages: the last loss)."""
    if device is not None and torch.device(device).type == "cpu":
        from fthmc_tpu_torch.parallel.launch import spawn
        return spawn(_gloo_rank, n_devices, n_devices)[0]
    resolve_device(device)
    if dist.is_initialized():
        return _dryrun_impl(n_devices, device)
    if n_devices != 1:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) on the card needs a process "
            f"group of {n_devices} ranks, one a card "
            f"({torch.cuda.device_count()} here): start it with torchrun "
            f"--nproc-per-node={n_devices} -m fthmc_tpu_torch.entry, or "
            f"pass device='cpu' to run {n_devices} gloo ranks on the CPU")
    from fthmc_tpu_torch.parallel.mesh import initialize_multihost
    initialize_multihost(num_processes=1, process_id=0,
                         store=dist.HashStore())
    try:
        return _dryrun_impl(1, device)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m fthmc_tpu_torch.entry")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        from fthmc_tpu_torch.parallel.mesh import initialize_multihost
        initialize_multihost()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    fn, fargs = entry(args.device)
    _, _, _, m = fn(*fargs)
    _check(_finite(m.dh), "entry dH not finite")
    print("entry OK", flush=True)
    dryrun_multichip(dist.get_world_size() if dist.is_initialized() else 1,
                     args.device)
    print("dryrun_multichip OK", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
