"""Experiment command line of the PyTorch port.

Counterpart of ``fthmc_tpu/cli.py``, with its eight subcommands, flags and
defaults (the reference's fthmc/main.py flow: HMC baseline -> train flow ->
flow-sampling eval -> FT-HMC -> volume transfer to 2L):

    python -m fthmc_tpu_torch.cli hmc      --beta 2.0 --L 8 --ntraj 256
    python -m fthmc_tpu_torch.cli train    --beta 2.0 --L 8 --n-era 2
    python -m fthmc_tpu_torch.cli sample   --beta 2.0 --L 8 --ckpt <dir>
    python -m fthmc_tpu_torch.cli fthmc    --L 16 --beta 6 --ckpt \\
        fthmc_tpu_torch/data/flow8x8_b3_rncp24_ftb6.npz --start cold
    python -m fthmc_tpu_torch.cli schwinger --beta 2 --mass 0.2 [--ckpt ..]
    python -m fthmc_tpu_torch.cli pipeline --json-file configs/example.json
    python -m fthmc_tpu_torch.cli bench    --L 64 --chains 1024
    python -m fthmc_tpu_torch.cli queue    --queue PLAN.json --status

Where it differs from the JAX CLI:
  - ``--device`` (every subcommand but ``queue``): the card by default,
    raising without one; ``--device cpu`` runs on the CPU.
  - ``schwinger --cg-backend`` takes auto|xla|fused|mixed, default 'auto'
    (K11 on the card, the torch CG on the CPU), the port's standing rule.
  - ``fthmc --force-backend`` keeps auto|xla|pallas, read as the port's
    'auto' (the kernels on the card; a spec they do not take raises),
    'autograd' and 'kernel'.
  - ``sample`` runs the proposals through K6 ('auto') unless the spec is a
    spline or has bf16 convs, which go through the torch flow ('torch').
  - ``--ckpt`` takes a checkpoint directory of the port or an exported
    flow ``.npz`` (``weights.save_flow_npz``, e.g. the files in
    ``fthmc_tpu_torch/data/``); an orbax directory raises.
  - ``--devices N`` / ``--shard-rows N`` (N > 1) run on a torch.distributed
    group of N ranks, one a device: the group already initialized, or one
    made from torchrun's environment (``torchrun --nproc-per-node=N -m
    fthmc_tpu_torch.cli ...``). Every rank runs the command; rank 0 writes
    the files.
  - ``train`` skips its final plots, saying so, where matplotlib is not
    installed (``--live-plot`` still needs it).
``main(argv)`` returns the subcommand's dict; ``run()``, the console
script, returns nothing, so a run that ends exits 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.checkpoint import (STATE_FILE, find_and_load_checkpoint,
                                        load_checkpoint_auto,
                                        resolve_checkpoint_dir,
                                        save_checkpoint, save_history)
from fthmc_tpu_torch.config import (FlowSpec, HMCConfig, LeapfrogConfig,
                                    SchedulerConfig, TrainConfig,
                                    load_json_configs)
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import TrajMetrics, run_fthmc_chunked
from fthmc_tpu_torch.models.flow import count_parameters, flow_reverse
from fthmc_tpu_torch.observables import chain_stats
from fthmc_tpu_torch.sampling import generate_ensemble
from fthmc_tpu_torch.train import init_train_state, train
from fthmc_tpu_torch.utils.logger import Logger, MetricsWriter
from fthmc_tpu_torch.utils.tboard import TBWriter
from fthmc_tpu_torch.weights import load_flow_npz

logger = Logger()

# --force-backend (the JAX CLI's names) -> hmc.resolve_force_backend's
FORCE_BACKENDS = {"auto": "auto", "xla": "autograd", "pallas": "kernel"}


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _device(args) -> torch.device:
    return resolve_device(getattr(args, "device", None))


def _sync(x: torch.Tensor) -> None:
    """Wait for the card's work on x before a time is read."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def _summarize_hmc(hist, therm_frac: float = 0.25,
                   plaq_ref: float | None = None) -> dict:
    n = hist.plaq.shape[0]
    t = int(n * therm_frac)
    cs = chain_stats(_host(hist.q)[t:])
    out = {
        "acc": float(_host(hist.acc)[t:].mean()),
        "plaq": float(_host(hist.plaq)[t:].mean()),
        "exp_mdh": float(_host(hist.exp_mdh)[t:].mean()),
        "dh_abs": float(np.abs(_host(hist.dh)[t:]).mean()),
        "chi_q": cs["chi_q"],
        "chi_q_err": cs["chi_q_err"],
        "tau_int_q": cs["tau_int_q"],
        "tau_int_q_err": cs["tau_int_q_err"],
    }
    from fthmc_tpu_torch.diagnostics import sanity_report
    rep = sanity_report(hist, plaq_ref=plaq_ref, therm_frac=therm_frac)
    if not rep["ok"]:
        out["sanity_flags"] = rep["flags"]
        for f in rep["flags"]:
            logger.log(f"SANITY: {f}")
    return out


# ---------------------------------------------------------------------------
# the parallel flags: a torch.distributed group of N ranks, one a device
# ---------------------------------------------------------------------------

def _lead() -> bool:
    """Whether this process writes the files: rank 0, or no group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _group(n: int, flag: str) -> None:
    """The process group of ``--flag n``: the one already initialized, or
    one from torchrun's environment; without either, SystemExit."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            f"{flag} {n} runs one rank a device on a torch.distributed "
            f"group: start it with torchrun --nproc-per-node={n} -m "
            f"fthmc_tpu_torch.cli ...")
    from fthmc_tpu_torch.parallel.mesh import initialize_multihost
    initialize_multihost()


def _mesh_device(args):
    """The device a mesh is made on: the rank's card (cuda:<LOCAL_RANK>)
    unless --device names another."""
    dev = getattr(args, "device", None)
    return None if dev in (None, "cuda") else dev


def _maybe_mesh(args):
    """A chain mesh when --devices > 1 (the sharded production drivers)."""
    n = getattr(args, "devices", 1) or 1
    if n <= 1:
        return None
    _group(n, "--devices")
    from fthmc_tpu_torch.parallel.mesh import make_chain_mesh
    return make_chain_mesh(n, device=_mesh_device(args))


def _maybe_rows(args):
    """A rows mesh when --shard-rows > 1 (domain decomposition)."""
    n = getattr(args, "shard_rows", 1) or 1
    if n <= 1:
        return None
    _group(n, "--shard-rows")
    from fthmc_tpu_torch.parallel.domain import make_rows_mesh
    return make_rows_mesh(n, device=_mesh_device(args))


def _gathered(x: torch.Tensor, mesh, rows) -> torch.Tensor:
    """The global field of a sharded run (a collective on every rank)."""
    if rows is not None:
        from fthmc_tpu_torch.parallel.domain import gather_rows
        return gather_rows(rows, x)
    if mesh is not None:
        from fthmc_tpu_torch.parallel.mesh import gather_chains
        return gather_chains(mesh, x)
    return x


def _metrics(hist_d: dict) -> TrajMetrics:
    return TrajMetrics(**{k: hist_d[k] for k in TrajMetrics._fields})


def _save(args, name: str, hist, **fields) -> None:
    """<outdir>/<name>_history.npz and, given fields, <name>_fields.npz."""
    os.makedirs(args.outdir, exist_ok=True)
    save_history({k: _host(getattr(hist, k)) for k in hist._fields},
                 os.path.join(args.outdir, f"{name}_history.npz"))
    if fields:
        np.savez_compressed(os.path.join(args.outdir, f"{name}_fields.npz"),
                            **{k: _host(v) for k, v in fields.items()})


def _progress(done, block) -> None:
    logger.print_metrics(
        {"acc": _host(block.acc).mean(),
         "plaq": _host(block.plaq)[-64:].mean()},
        pre=[f"traj={done}"])


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_hmc(args) -> dict:
    cfg = HMCConfig(beta=args.beta, L=args.L, tau=args.tau, nstep=args.nstep,
                    ntraj=args.ntraj, n_chains=args.chains, seed=args.seed,
                    nrun=getattr(args, "nrun", 1),
                    randinit=getattr(args, "start", "hot") != "cold")
    integrator = getattr(args, "integrator", "leapfrog")
    rows = _maybe_rows(args)
    mesh = None if rows is not None else _maybe_mesh(args)
    logger.rule(f"HMC {cfg.L}x{cfg.L} beta={cfg.beta}"
                + (f" [{mesh.size} devices]" if mesh else "")
                + (f" [rows/{rows.size}]" if rows else ""))
    t0 = time.time()
    if rows is not None:
        # domain decomposition: the lattice's row axis sharded, halo rows
        # exchanged between ring neighbours (parallel/domain.py)
        from fthmc_tpu_torch.parallel.domain import run_domain_hmc_chunked
        x, hist_d = run_domain_hmc_chunked(rows, cfg,
                                           block=min(cfg.ntraj, 256))
        hist = _metrics(hist_d)
    elif mesh is not None:
        from fthmc_tpu_torch.parallel.mesh import sharded_run_hmc
        x, hist = sharded_run_hmc(mesh, cfg, integrator=integrator)
    elif cfg.nrun > 1:
        from fthmc_tpu_torch.hmc import run_hmc_nrun
        x, runs = run_hmc_nrun(cfg, integrator=integrator,
                               device=_device(args))
        # the independent runs folded into the chain axis for the summary;
        # their scatter is reported as plaq_err
        hist = TrajMetrics(*[torch.cat(list(f), dim=1) for f in runs])
    else:
        from fthmc_tpu_torch.hmc import run_hmc_chunked
        # print cadence: cfg.nprint trajectories (reference run_hmc nprint)
        x, hist = run_hmc_chunked(cfg, block=min(cfg.ntraj, cfg.nprint),
                                  callback=_progress, integrator=integrator,
                                  device=_device(args))
    _sync(x)
    dt = time.time() - t0
    stats = _summarize_hmc(hist, plaq_ref=lattice.PLAQ_EXACT.get(cfg.beta))
    if cfg.nrun > 1 and mesh is None and rows is None:
        t = int(runs.plaq.shape[1] * 0.25)
        per_run = _host(runs.plaq)[:, t:].mean(axis=(1, 2))
        stats["plaq_err"] = float(per_run.std(ddof=1)
                                  / max(1, cfg.nrun - 1) ** 0.5)
    stats["s_per_traj"] = dt / cfg.ntraj
    stats["exact_plaq"] = lattice.PLAQ_EXACT.get(cfg.beta)
    logger.print_metrics(stats, skip=("sanity_flags",))
    if args.outdir:
        # final chain states for a resume (reference hmc.py:172-173)
        x = _gathered(x, mesh, rows)
        if _lead():
            _save(args, "hmc", hist, x=x)
    return stats


_SPEC_ARGS = {  # CLI attr -> FlowSpec field
    "n_layers": "n_layers", "n_mixture": "n_mixture", "hidden": "hidden_sizes",
    "kernel": "kernel_size", "activation": "activation",
    "coupling": "coupling", "n_knots": "n_knots", "s_clip": "s_clip",
    "conv_dtype": "conv_dtype"}


def _cli_spec_overrides(args) -> dict:
    """FlowSpec fields explicitly set on the command line (non-None values;
    restore-mode subcommands default every flow flag to None so checkpoint
    metadata wins unless the user overrides). --s-clip with a negative value
    explicitly disables clipping (-> None)."""
    out = {}
    for attr, field in _SPEC_ARGS.items():
        v = getattr(args, attr, None)
        if v is None:
            continue
        if attr == "hidden":
            v = tuple(v)
        if attr == "s_clip" and v < 0:
            v = None
        out[field] = v
    return out


def _flow_spec(args, base: FlowSpec | None = None) -> FlowSpec:
    """FlowSpec from CLI flags layered over `base` (checkpoint metadata or
    the dataclass defaults)."""
    return dataclasses.replace(base or FlowSpec(), **_cli_spec_overrides(args))


def _restore_flow(path: str, overrides: dict, device):
    """(state, meta, spec) of a self-describing flow at ``path`` on
    ``device``: an exported flow ``.npz`` (its FlowSpec ``.json`` beside
    it), or a checkpoint directory of the port (a parent of ckpt_era*
    directories or one itself); None where no self-describing checkpoint
    is found. An orbax checkpoint of the JAX package raises SystemExit."""
    if path.endswith(".npz"):
        params, spec = load_flow_npz(path, device=device,
                                     spec_overrides=overrides)
        state = init_train_state(None, TrainConfig(flow=spec), params=params,
                                 device=device)
        return state, {"era": None, "npz": path}, spec
    ckpt = resolve_checkpoint_dir(path)
    if ckpt is not None and not os.path.exists(os.path.join(ckpt,
                                                            STATE_FILE)):
        raise SystemExit(
            f"--ckpt {path}: {ckpt} is an orbax checkpoint of the JAX "
            f"package, which the port does not read. Export it once with "
            f"JAX to an .npz (weights.save_flow_npz; the one-off export "
            f"command is in CHANGES.md) and pass the .npz; the trained "
            f"flows are in fthmc_tpu_torch/data/")
    found = load_checkpoint_auto(path, spec_overrides=overrides,
                                 device=device)
    if found is None:
        return None
    state, meta, spec, _ = found
    return state, meta, spec


def _load_flow_state(args):
    """Resolve (state, spec) for sample/fthmc/schwinger: a self-describing
    --ckpt restores its own architecture (flags override); legacy
    checkpoints fall back to the template built from flags."""
    device = _device(args)
    if args.ckpt:
        found = _restore_flow(args.ckpt, _cli_spec_overrides(args), device)
        if found is not None:
            state, meta, spec = found
            logger.log(f"restored self-describing flow "
                       f"({spec.coupling}, {spec.n_layers} layers, "
                       f"era={meta.get('era')})")
            return state, spec
    spec = _flow_spec(args)
    cfg = TrainConfig(L=args.L, beta=args.beta, flow=spec)
    state = init_train_state(_generator(device, 0), cfg, device=device)
    found = find_and_load_checkpoint(
        args.ckpt or os.path.join(cfg.logdir(), "checkpoints"), state)
    if found is None:
        raise SystemExit("no checkpoint found; pass --ckpt")
    return found[0], spec


def cmd_train(args) -> dict:
    spec = _flow_spec(args)
    cfg = TrainConfig(L=args.L, beta=args.beta, n_era=args.n_era,
                      n_epoch=args.n_epoch, batch_size=args.batch_size,
                      base_lr=args.lr, flow=spec, seed=args.seed,
                      with_force=args.with_force,
                      beta_init=getattr(args, "beta_init", None),
                      beta_anneal_frac=getattr(args, "anneal_frac", 0.7),
                      grad_clip=getattr(args, "grad_clip", None),
                      force_weight=getattr(args, "force_weight", 0.0))
    outdir = args.outdir or cfg.logdir()
    ckptdir = os.path.join(outdir, "checkpoints")
    mesh = _maybe_mesh(args)
    device = mesh.device if mesh is not None else _device(args)
    lead = _lead()
    logger.rule(f"train flow {cfg.L}x{cfg.L} beta={cfg.beta} "
                f"({spec.n_layers} layers, {spec.coupling})")

    state = init_train_state(None, cfg, device=device)
    logger.log(f"flow parameters: {count_parameters(state.params)}")
    start_era = 0
    if cfg.restore or args.restore:
        found = find_and_load_checkpoint(ckptdir, state)
        if found is not None:
            state, meta = found
            start_era = int(meta.get("era", -1)) + 1
            logger.log(f"restored checkpoint era={meta.get('era')}; "
                       f"continuing from era {start_era}")

    writer = (MetricsWriter(os.path.join(outdir, "train_metrics.jsonl"))
              if lead else None)
    sched = (SchedulerConfig(factor=args.sched_factor,
                             patience=args.sched_patience,
                             cooldown=getattr(args, "sched_cooldown", 0))
             if args.scheduler else None)

    live = None
    if getattr(args, "live_plot", False):
        from fthmc_tpu_torch.utils.plotting import LiveJointPlot
        live = LiveJointPlot(outdir=outdir,
                             title=f"{cfg.L}x{cfg.L} beta={cfg.beta}")
    live_hist = {"loss_dkl": [], "ess": []}

    def cb(step, metrics):
        if writer is not None and step % cfg.log_freq == 0:
            writer.write(step, metrics, prefix="training")
        if step % cfg.print_freq == 0:
            logger.print_metrics(
                {k: metrics[k] for k in
                 ("loss_dkl", "ess", "plaq", "dq", "dq_mean", "lr_scale")
                 if k in metrics},
                pre=[f"step={step}"])
        if live is not None:
            live_hist["loss_dkl"].append(float(metrics["loss_dkl"]))
            live_hist["ess"].append(float(metrics["ess"]))
            if step % max(cfg.plot_freq, 1) == 0:
                live.update(live_hist["loss_dkl"], live_hist["ess"])

    def scalars(history):
        return {k: np.asarray(v, dtype=np.float64)
                for k, v in history.items() if np.ndim(v[0]) == 0}

    def ckpt(era, st, history):
        if lead:
            save_checkpoint(ckptdir, st, era=era, epoch=cfg.n_epoch,
                            train_cfg=cfg, history=scalars(history))

    t0 = time.time()
    state, history = train(cfg, state, scheduler=sched, callback=cb,
                           checkpoint_fn=ckpt, start_era=start_era,
                           mesh=mesh, device=device)
    wall = time.time() - t0
    if live is not None:
        if live_hist["loss_dkl"]:
            live.update(live_hist["loss_dkl"], live_hist["ess"])
        live.close()
    if lead:
        save_history(scalars(history),
                     os.path.join(outdir, "train_history.npz"))
        writer.close()
        if cfg.plot_freq > 0 and history.get("loss_dkl"):
            if importlib.util.find_spec("matplotlib") is None:
                logger.log("plots skipped: matplotlib is not installed")
            else:
                from fthmc_tpu_torch.utils.plotting import plot_history
                plot_history(scalars(history),
                             outdir=os.path.join(outdir, "plots"))
    final = {"wall_s": wall,
             "ess": float(np.mean(history["ess"][-10:])),
             "loss_dkl": float(np.mean(history["loss_dkl"][-10:])),
             "outdir": outdir}
    logger.print_metrics({k: v for k, v in final.items() if k != "outdir"})
    return {"state": state, "cfg": cfg, "outdir": outdir, **final}


def sample_route(spec: FlowSpec) -> str:
    """The sampler's flow_backend for ``spec``: the torch flow for a spline
    or a bf16 flow, which K6 does not take; 'auto' (K6 on the card)
    otherwise."""
    if spec.coupling == "spline" or spec.conv_dtype != "float32":
        return "torch"
    return "auto"


def cmd_sample(args, state=None, spec=None) -> dict:
    if state is None:
        state, spec = _load_flow_state(args)
    elif spec is None:
        spec = _flow_spec(args)
    device = state.params[0][0]["w"].device
    route = sample_route(spec)
    logger.rule(f"flow sampling {args.L}x{args.L} beta={args.beta} "
                f"[flow_backend={route}]")
    out = generate_ensemble(
        state.params, spec, beta=args.beta, L=args.L,
        ensemble_size=args.ensemble_size, batch_size=args.batch_size,
        n_chains=getattr(args, "sample_chains", 1),
        generator=_generator(device, args.seed), flow_backend=route,
        device=device)
    logger.print_metrics({k: out[k] for k in
                          ("accept_rate", "suscept_mean", "suscept_err",
                           "tau_int_q", "tau_int_q_err") if k in out})
    return out


def _cold_latents(state, spec, n: int, L: int, device) -> torch.Tensor:
    """z0 = f^-1(0), the ordered start in latent space (bisection inverse):
    at beta >= ~5 a hot start takes ~tau_int trajectories to reach the
    ordered phase."""
    z0, _ = flow_reverse(state.params, torch.zeros(
        (n, 2, L, L), dtype=state.params[0][0]["w"].dtype, device=device),
        spec)
    return z0


def cmd_fthmc(args, state=None, spec=None) -> dict:
    rows = _maybe_rows(args)
    mesh = None if rows is not None else _maybe_mesh(args)
    par = rows or mesh
    if state is None:
        state, spec = _load_flow_state(args)
    elif spec is None:
        spec = _flow_spec(args)
    device = par.device if par is not None else _device(args)
    lf = LeapfrogConfig(tau=args.tau, nstep=args.nstep)
    integrator = getattr(args, "integrator", "leapfrog")
    force_backend = FORCE_BACKENDS[getattr(args, "force_backend", "auto")]
    logger.rule(f"FT-HMC {args.L}x{args.L} beta={args.beta} "
                f"tau={lf.tau} nstep={lf.nstep}"
                + (f" [{mesh.size} devices]" if mesh else "")
                + (f" [rows/{rows.size}]" if rows else ""))
    gen = _generator(device, args.seed)
    if getattr(args, "start", "hot") == "cold":
        z0 = _cold_latents(state, spec, args.chains, args.L, device)
    else:
        z0 = lattice.hot_start(gen, args.chains, args.L, device=device)
    tb = TBWriter(os.path.join(args.outdir, "summaries")) if (
        args.outdir and getattr(args, "tensorboard", False)
        and _lead()) else None

    def cb(done, block):
        _progress(done, block)
        if tb is not None:
            tb.write({k: getattr(block, k) for k in block._fields},
                     step=done, prefix="ftHMC")

    t0 = time.time()
    if rows is not None:
        # domain-decomposed FT-HMC (leapfrog; parallel/domain_flow.py)
        from fthmc_tpu_torch.parallel.domain_flow import (
            run_domain_fthmc_chunked)
        z, hist_d = run_domain_fthmc_chunked(
            rows, state.params, spec, lf, beta=args.beta, ntraj=args.ntraj,
            z0=z0, generator=gen, block=min(args.ntraj, 256),
            callback=lambda done, h: cb(done, _metrics(h)))
        hist = _metrics(hist_d)
    elif mesh is not None:
        from fthmc_tpu_torch.parallel.mesh import sharded_run_fthmc_chunked
        z, hist = sharded_run_fthmc_chunked(
            mesh, state.params, spec, lf, beta=args.beta, ntraj=args.ntraj,
            z0=z0, generator=gen, block=min(args.ntraj, 1024), callback=cb,
            integrator=integrator, force_backend=force_backend)
    else:
        z, hist = run_fthmc_chunked(
            state.params, spec, lf, beta=args.beta, ntraj=args.ntraj, z0=z0,
            generator=gen, block=min(args.ntraj, 1024), callback=cb,
            integrator=integrator, force_backend=force_backend,
            device=device)
    _sync(z)
    dt = time.time() - t0
    if tb is not None:
        tb.close()
    stats = _summarize_hmc(hist, plaq_ref=lattice.PLAQ_EXACT.get(args.beta))
    stats["s_per_traj"] = dt / args.ntraj
    logger.print_metrics(stats, skip=("sanity_flags",))
    if args.outdir:
        z = _gathered(z, mesh, rows)
        if _lead():
            _save(args, "fthmc", hist, z=z)
    return stats


def _run_dyn_resilient(run, z0, cfg, generator, args):
    """A dynamical run through the resilient block + persist + resume
    runner (fthmc_tpu_torch/runner.py): ``run(generator, z, cfg_n)`` with
    cfg_n of n trajectories runs one block; --state names the persistence
    file, and a crash loses at most one block."""
    from fthmc_tpu_torch.runner import run_resilient
    z, hist_d, info = run_resilient(
        lambda g, z, n: run(g, z, dataclasses.replace(cfg, ntraj=n)), z0,
        generator=generator, ntraj=cfg.ntraj,
        block=min(cfg.ntraj, args.block), state_path=args.state,
        hist_fields=TrajMetrics._fields)
    logger.log(f"resilient run: {info['done']} done, "
               f"{info['retries']} retries, {info['wall_s']:.1f} s")
    return z, TrajMetrics(**hist_d)


def cmd_schwinger(args) -> dict:
    """Dynamical-fermion (two-flavor Schwinger model) sampler: plain HMC,
    or FT-HMC when --ckpt points at a flow (partial trivialization with a
    pure-gauge-trained flow; fthmc_tpu_torch/schwinger.py)."""
    from fthmc_tpu_torch import fermion
    from fthmc_tpu_torch.schwinger import (SchwingerConfig, run_fthmc_dyn,
                                           run_fthmc_dyn_chunked,
                                           run_hmc_dyn, run_hmc_dyn_chunked)
    cfg = SchwingerConfig(
        L=args.L, beta=args.beta, mass=args.mass, tau=args.tau,
        nstep=args.nstep, n_chains=args.chains, ntraj=args.ntraj,
        integrator=args.integrator, warm_start=not args.no_warm_start,
        eo_precond=not args.no_eo, n_inner=args.n_inner,
        hasenbusch_dm=args.hasenbusch_dm, n_mid=args.n_mid)
    n_rows = getattr(args, "shard_rows", 1) or 1
    n_dev = getattr(args, "devices", 1) or 1
    resilient = getattr(args, "state", None)
    if cfg.hasenbusch_dm > 0 and args.ckpt:
        raise SystemExit("--hasenbusch-dm is implemented for plain "
                         "dynamical HMC (omit --ckpt)")
    if resilient and n_dev > 1:
        raise SystemExit("--state (resilient resume) and --devices "
                         "(sharded driver) are separate paths; pick one")
    if n_rows > 1 and (n_dev > 1 or resilient):
        raise SystemExit("--shard-rows is its own parallel path; "
                         "drop --devices/--state")
    if n_rows > 1 and args.cg_backend != "xla":
        logger.log("note: --shard-rows uses the sharded torch CG (a host "
                   "loop over the row-sharded operator; the CG kernels are "
                   f"single-device); --cg-backend {args.cg_backend} applies "
                   "only to non-sharded stages")
    rows = _maybe_rows(args)
    mesh = _maybe_mesh(args)
    par = rows or mesh
    ft = bool(args.ckpt)
    prev_backend = fermion._CG_BACKEND
    fermion.set_cg_backend(args.cg_backend)
    try:
        if ft:
            state, spec = _load_flow_state(args)
        device = par.device if par is not None else _device(args)
        logger.rule(f"{'FT-' if ft else ''}HMC Schwinger {cfg.L}x{cfg.L} "
                    f"beta={cfg.beta} m={cfg.mass} tau={cfg.tau} "
                    f"nstep={cfg.nstep}"
                    + (f" [{mesh.size} devices]" if mesh else "")
                    + (f" [rows/{rows.size}]" if rows else ""))
        gen = _generator(device, args.seed)
        block = min(cfg.ntraj, args.block)
        cold = getattr(args, "start", "hot") == "cold"
        t0 = time.time()
        if ft:
            params = state.params
            z0 = (_cold_latents(state, spec, cfg.n_chains, cfg.L, device)
                  if cold else lattice.hot_start(gen, cfg.n_chains, cfg.L,
                                                 device=device))
            if rows is not None:
                # rows sharded through the flow (domain_flow) and the
                # Dirac operator and CG (domain_fermion)
                from fthmc_tpu_torch.parallel.domain_fermion import (
                    run_domain_fthmc_dyn_chunked)
                x, hist_d = run_domain_fthmc_dyn_chunked(
                    rows, params, spec, cfg, block=block, z0=z0,
                    generator=gen)
                hist = _metrics(hist_d)
            elif resilient:
                x, hist = _run_dyn_resilient(
                    lambda g, z, c: run_fthmc_dyn(params, spec, c, z0=z,
                                                  generator=g, device=device),
                    z0, cfg, gen, args)
            elif mesh is not None:
                from fthmc_tpu_torch.parallel.mesh import (
                    sharded_run_fthmc_dyn_chunked)
                x, hist = sharded_run_fthmc_dyn_chunked(
                    mesh, params, spec, cfg, block=block, z0=z0,
                    generator=gen)
            else:
                x, hist = run_fthmc_dyn_chunked(
                    params, spec, cfg, block=block, z0=z0, generator=gen,
                    device=device)
        else:
            x0 = (torch.zeros((cfg.n_chains, 2, cfg.L, cfg.L), device=device)
                  if cold else None)
            if rows is not None:
                # the lattice's rows sharded through the Dirac operator and
                # the CG (parallel/domain_fermion.py)
                from fthmc_tpu_torch.parallel.domain_fermion import (
                    run_domain_hmc_dyn_chunked)
                x, hist_d = run_domain_hmc_dyn_chunked(
                    rows, cfg, block=block, x0=x0, generator=gen)
                hist = _metrics(hist_d)
            elif resilient:
                if x0 is None:
                    x0 = lattice.hot_start(gen, cfg.n_chains, cfg.L,
                                           device=device)
                x, hist = _run_dyn_resilient(
                    lambda g, z, c: run_hmc_dyn(c, x0=z, generator=g,
                                                device=device),
                    x0, cfg, gen, args)
            elif mesh is not None:
                from fthmc_tpu_torch.parallel.mesh import (
                    sharded_run_hmc_dyn_chunked)
                x, hist = sharded_run_hmc_dyn_chunked(
                    mesh, cfg, block=block, x0=x0, generator=gen)
            else:
                x, hist = run_hmc_dyn_chunked(cfg, block=block, x0=x0,
                                              generator=gen, device=device)
        _sync(x)
        dt = time.time() - t0
        stats = _summarize_hmc(hist)
        stats["s_per_traj"] = dt / cfg.ntraj
        if args.condensate:
            y = _gathered(x, mesh, rows)
            if ft:
                from fthmc_tpu_torch.models.flow import flow_forward
                with torch.no_grad():
                    y, _ = flow_forward(params, y, spec)
            cc = _host(fermion.chiral_condensate(gen, y, cfg.mass,
                                                 n_noise=8))
            stats["psibar_psi"] = float(cc.mean())
            stats["psibar_psi_err"] = float(cc.std(ddof=1)
                                            / len(cc) ** 0.5)
    finally:
        fermion.set_cg_backend(prev_backend)
    logger.print_metrics(stats, skip=("sanity_flags",))
    if args.outdir and _lead():
        _save(args, "schwinger", hist)
    return stats


def _spec_to_args(spec: FlowSpec) -> dict:
    """FlowSpec -> the CLI attr dict cmd_train expects (inverse of
    _flow_spec), so pipeline stages carry the FULL architecture - coupling
    family, s_clip, conv_dtype included."""
    return {"n_layers": spec.n_layers, "n_mixture": spec.n_mixture,
            "hidden": list(spec.hidden_sizes), "kernel": spec.kernel_size,
            "activation": spec.activation, "coupling": spec.coupling,
            "n_knots": spec.n_knots, "s_clip": spec.s_clip,
            "conv_dtype": spec.conv_dtype}


def _write_results(args, results: dict) -> None:
    if args.outdir and _lead():
        os.makedirs(args.outdir, exist_ok=True)
        with open(os.path.join(args.outdir, "pipeline_results.json"),
                  "w") as f:
            json.dump(results, f, indent=2, default=float)


def cmd_pipeline(args) -> dict:
    """Full reference pipeline (main.py:268-304): HMC baseline -> train ->
    flow eval -> FT-HMC -> transfer to 2L (re-apply + fine-tune) -> repeat
    eval at 2L. --mode highbeta instead runs the partial-trivialization
    workflow (cmd_pipeline_highbeta)."""
    if getattr(args, "mode", "reference") == "highbeta":
        return cmd_pipeline_highbeta(args)
    if args.json_file:
        hmc_cfg, train_cfg, lf, sched = load_json_configs(args.json_file)
    else:
        hmc_cfg = HMCConfig(beta=args.beta, L=args.L, ntraj=args.ntraj,
                            n_chains=args.chains)
        train_cfg = TrainConfig(
            L=args.L, beta=args.beta, n_era=args.n_era,
            n_epoch=args.n_epoch, flow=_flow_spec(args),
            beta_init=getattr(args, "beta_init", None),
            grad_clip=getattr(args, "grad_clip", None))
        lf, sched = LeapfrogConfig(tau=args.tau, nstep=args.nstep), None
    device = getattr(args, "device", None)

    results: dict = {}

    # 1. HMC baseline
    ns = argparse.Namespace(beta=hmc_cfg.beta, L=hmc_cfg.L, tau=hmc_cfg.tau,
                            nstep=hmc_cfg.nstep, ntraj=hmc_cfg.ntraj,
                            chains=hmc_cfg.n_chains, seed=hmc_cfg.seed,
                            outdir=None, device=device)
    results["hmc"] = cmd_hmc(ns)

    # 2. Train flow
    spec = train_cfg.flow
    tns = argparse.Namespace(
        L=train_cfg.L, beta=train_cfg.beta, n_era=train_cfg.n_era,
        n_epoch=train_cfg.n_epoch, batch_size=train_cfg.batch_size,
        lr=train_cfg.base_lr, seed=train_cfg.seed, outdir=args.outdir,
        with_force=train_cfg.with_force, restore=False,
        scheduler=sched is not None,
        sched_factor=getattr(sched, "factor", 0.5),
        sched_patience=getattr(sched, "patience", 10),
        beta_init=train_cfg.beta_init,
        anneal_frac=train_cfg.beta_anneal_frac,
        grad_clip=train_cfg.grad_clip, device=device,
        **_spec_to_args(spec))
    tr = cmd_train(tns)
    state = tr["state"]

    # 3. Flow-sampling eval
    sns = argparse.Namespace(L=train_cfg.L, beta=train_cfg.beta,
                             ensemble_size=args.ensemble_size,
                             batch_size=train_cfg.batch_size, seed=1,
                             ckpt=None, device=device)
    ens = cmd_sample(sns, state=state, spec=spec)
    results["sample"] = {k: ens[k] for k in
                         ("accept_rate", "suscept_mean", "suscept_err")}

    # 4. FT-HMC
    fns = argparse.Namespace(L=train_cfg.L, beta=train_cfg.beta, tau=lf.tau,
                             nstep=lf.nstep, ntraj=args.ntraj,
                             chains=hmc_cfg.n_chains, seed=2, ckpt=None,
                             outdir=None, device=device)
    results["fthmc"] = cmd_fthmc(fns, state=state, spec=spec)

    # 5. Volume transfer: SAME params at 2L. Reference semantics
    # (main.py:198-216): HMC baseline at 2L, fine-tune, then the full
    # train_and_evaluate eval pair (flow sampling + FT-HMC) at 2L.
    L2 = 2 * train_cfg.L
    logger.rule(f"volume transfer -> {L2}x{L2}")
    ns2 = argparse.Namespace(**{**vars(ns), "L": L2})
    results["hmc_2L"] = cmd_hmc(ns2)
    if args.transfer_epochs > 0:
        cfg2 = dataclasses.replace(train_cfg, L=L2, n_era=1,
                                   n_epoch=args.transfer_epochs,
                                   base_lr=train_cfg.base_lr / 10)
        # the fine-tune continues from the transferred params (the masks
        # follow the lattice shape)
        state, _ = train(cfg2, state)
    sns2 = argparse.Namespace(**{**vars(sns), "L": L2})
    ens2 = cmd_sample(sns2, state=state, spec=spec)
    results["sample_2L"] = {k: ens2[k] for k in
                            ("accept_rate", "suscept_mean", "suscept_err")}
    fns2 = argparse.Namespace(**{**vars(fns), "L": L2})
    results["fthmc_transfer"] = cmd_fthmc(fns2, state=state, spec=spec)
    _write_results(args, results)
    return results


def cmd_pipeline_highbeta(args) -> dict:
    """Partial-trivialization pipeline: train the SMOOTH rncp flow at a
    small lattice with beta annealed 2 -> flow_beta (~3), then run FT-HMC
    at the TARGET (L, beta) with the flow UNCHANGED - a partial
    trivializing map only needs to flatten the measure, Metropolis corrects
    the rest (cf. Luscher arXiv:0907.5491). Finishes with a tau_int(Q)
    head-to-head against plain HMC, chain-bootstrap errors included.

        python -m fthmc_tpu_torch.cli pipeline --mode highbeta --L 16 \\
            --beta 6 [--ckpt fthmc_tpu_torch/data/flow8x8_b3_rncp24.npz]
    """
    results: dict = {"mode": "highbeta", "L": args.L, "beta": args.beta}
    device = getattr(args, "device", None)
    logger.rule(f"partial-trivialization pipeline -> {args.L}x{args.L} "
                f"beta={args.beta}")

    # 1. the smooth flow: restore a self-describing checkpoint or exported
    #    flow, or train the flagship recipe from scratch at the small lattice
    if args.ckpt:
        found = _restore_flow(args.ckpt, _cli_spec_overrides(args),
                              _device(args))
        if found is None:
            raise SystemExit(f"--ckpt {args.ckpt}: no self-describing "
                             "checkpoint found (train one with this "
                             "pipeline, or pass architecture flags to "
                             "`fthmc` directly)")
        state, meta, spec = found
        logger.log(f"flow restored: {spec.coupling} x{spec.n_layers}, "
                   f"era={meta.get('era')}")
    else:
        base = FlowSpec(n_layers=24, coupling="rncp", n_mixture=8,
                        hidden_sizes=(32, 32), s_clip=3.0)
        spec = _flow_spec(args, base)
        n_epoch = min(500, args.train_steps)
        tns = argparse.Namespace(
            L=args.flow_L, beta=args.flow_beta,
            n_era=max(1, args.train_steps // n_epoch), n_epoch=n_epoch,
            batch_size=args.flow_batch, lr=1e-3, seed=args.seed,
            outdir=os.path.join(args.outdir, "flow") if args.outdir else None,
            with_force=False, restore=False, scheduler=True,
            sched_factor=0.5, sched_patience=30, sched_cooldown=30,
            beta_init=(2.0 if args.beta_init is None else args.beta_init),
            anneal_frac=0.5,
            grad_clip=(1.0 if args.grad_clip is None else args.grad_clip),
            devices=getattr(args, "devices", 1), device=device,
            **_spec_to_args(spec))
        tr = cmd_train(tns)
        state = tr["state"]
        results["train"] = {k: tr[k] for k in ("ess", "loss_dkl", "wall_s")}

    # 2. FT-HMC at the target (L, beta) with the flow unchanged (volume
    #    transfer is free: params are L-independent). Omelyan + cold start
    #    by default - the production recipe at beta >= 5.
    cold = args.beta >= 5.0 if args.start == "auto" else args.start == "cold"
    fns = argparse.Namespace(
        L=args.L, beta=args.beta, tau=args.tau, nstep=args.ft_nstep,
        ntraj=args.ntraj, chains=args.ft_chains, seed=args.seed + 1,
        ckpt=None, outdir=(os.path.join(args.outdir, "fthmc")
                           if args.outdir else None),
        integrator=args.ft_integrator, start="cold" if cold else "hot",
        devices=getattr(args, "devices", 1), device=device)
    results["fthmc"] = cmd_fthmc(fns, state=state, spec=spec)

    # 3. plain-HMC baseline at the same (L, beta) - long chains (tau_int
    #    grows ~x4.5 per unit beta)
    ns = argparse.Namespace(
        beta=args.beta, L=args.L, tau=args.tau, nstep=args.plain_nstep,
        ntraj=args.plain_ntraj, chains=args.plain_chains,
        seed=args.seed + 2, start="cold" if cold else "hot",
        outdir=(os.path.join(args.outdir, "hmc") if args.outdir else None),
        devices=getattr(args, "devices", 1), device=device)
    results["hmc"] = cmd_hmc(ns)

    ft, pl = results["fthmc"], results["hmc"]
    if ft["tau_int_q"] > 0:
        s = pl["tau_int_q"] / ft["tau_int_q"]
        err = s * np.hypot(pl["tau_int_q_err"] / max(pl["tau_int_q"], 1e-12),
                           ft["tau_int_q_err"] / max(ft["tau_int_q"], 1e-12))
        results["tau_int_speedup"] = s
        results["tau_int_speedup_err"] = float(err)
    logger.rule("head-to-head")
    logger.print_metrics({
        "tau_int_plain": pl["tau_int_q"], "tau_int_ft": ft["tau_int_q"],
        "speedup": results.get("tau_int_speedup"),
        "chi_q_plain": pl["chi_q"], "chi_q_ft": ft["chi_q"],
        "exact_plaq": lattice.PLAQ_EXACT.get(args.beta)})
    _write_results(args, results)
    return results


def cmd_bench(args) -> dict:
    from fthmc_tpu_torch.bench import run_benchmarks
    return run_benchmarks(L=args.L, chains=args.chains, beta=args.beta,
                          which=args.which, device=_device(args))


def cmd_queue(args) -> dict:
    from fthmc_tpu_torch.runner import queue_status, run_queue
    res = (queue_status(args.queue) if args.status
           else run_queue(args.queue, only=args.only,
                          retry_failed=args.retry_failed))
    print(json.dumps(res, indent=1))
    return res


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fthmc_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--beta", type=float, default=2.0)
        sp.add_argument("--L", type=int, default=8)
        sp.add_argument("--seed", type=int, default=1331)
        sp.add_argument("--outdir", type=str, default=None)
        sp.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card, which "
                             "must be present; 'cpu' runs on the CPU)")
        sp.add_argument("--devices", type=int, default=1,
                        help="shard chains/batch over this many ranks, one "
                             "a device (torch.distributed; start under "
                             "torchrun --nproc-per-node=N)")
        sp.add_argument("--shard-rows", type=int, default=1,
                        dest="shard_rows",
                        help="domain decomposition: shard the lattice ROW "
                             "axis over this many ranks (halo rows "
                             "exchanged over torch.distributed; hmc/fthmc "
                             "leapfrog + schwinger plain/FT). For L beyond "
                             "one card's memory; L %% shard_rows == 0")

    def flow_args(sp, restore: bool = False):
        """Flow-architecture flags. restore=True (sample/fthmc) defaults
        everything to None so a self-describing --ckpt's stored FlowSpec
        wins; explicit flags override the metadata."""
        d = (lambda v: None) if restore else (lambda v: v)
        sp.add_argument("--n-layers", type=int, default=d(24))
        sp.add_argument("--n-mixture", type=int, default=d(2))
        sp.add_argument("--hidden", type=int, nargs="+", default=d([8, 8]))
        sp.add_argument("--kernel", type=int, default=d(3))
        sp.add_argument("--activation", type=str, default=d("silu"))
        sp.add_argument("--coupling", choices=["ncp", "rncp", "spline"],
                        default=d("ncp"))
        sp.add_argument("--n-knots", type=int, default=d(8))
        sp.add_argument("--s-clip", type=float, default=None,
                        help="smooth cap on the NCP log-slope; negative "
                             "explicitly disables clipping on restore")
        sp.add_argument("--conv-dtype", choices=["float32", "bfloat16"],
                        default=d("float32"))

    sp = sub.add_parser("hmc")
    common(sp)
    sp.add_argument("--tau", type=float, default=2.0)
    sp.add_argument("--nstep", type=int, default=10)
    sp.add_argument("--ntraj", type=int, default=256)
    sp.add_argument("--chains", type=int, default=16)
    sp.add_argument("--nrun", type=int, default=1,
                    help="independent fresh-init runs (reference nrun)")
    sp.add_argument("--integrator", choices=["leapfrog", "omelyan"],
                    default="leapfrog")
    sp.add_argument("--start", choices=["hot", "cold"], default="hot",
                    help="cold = ordered (zeros) start; use at beta >= ~5")
    sp.set_defaults(fn=cmd_hmc)

    sp = sub.add_parser("train")
    common(sp)
    flow_args(sp)
    sp.add_argument("--n-era", type=int, default=10)
    sp.add_argument("--n-epoch", type=int, default=100)
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--with-force", action="store_true")
    sp.add_argument("--force-weight", type=float, default=0.0,
                    dest="force_weight",
                    help="smoothness-regularized joint objective: loss = "
                         "D_KL + w * mean(F_eff^2) on the training batch "
                         "(0 = off). Steers KL training toward "
                         "leapfrog-integrable flows.")
    sp.add_argument("--beta-init", type=float, default=None,
                    help="beta-annealed training: ramp beta from this value")
    sp.add_argument("--grad-clip", type=float, default=None)
    sp.add_argument("--anneal-frac", type=float, default=0.7)
    sp.add_argument("--restore", action="store_true")
    sp.add_argument("--scheduler", action="store_true")
    sp.add_argument("--sched-factor", type=float, default=0.5)
    sp.add_argument("--sched-patience", type=int, default=10)
    sp.add_argument("--sched-cooldown", type=int, default=0)
    sp.add_argument("--live-plot", action="store_true",
                    help="live twin-axis loss/ESS monitor (display-handle "
                         "updates in notebooks, throttled PNG headless; "
                         "needs matplotlib)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("sample")
    common(sp)
    flow_args(sp, restore=True)
    sp.add_argument("--ckpt", type=str, default=None,
                    help="a checkpoint directory of the port or an "
                         "exported flow .npz")
    sp.add_argument("--ensemble-size", type=int, default=8192)
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--sample-chains", type=int, default=1,
                    help=">1 runs that many independent on-device chains "
                         "and reports cross-chain chi_Q errors + tau_int")
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("fthmc")
    common(sp)
    flow_args(sp, restore=True)
    sp.add_argument("--ckpt", type=str, default=None,
                    help="a checkpoint directory of the port or an "
                         "exported flow .npz")
    sp.add_argument("--tau", type=float, default=1.0)
    sp.add_argument("--nstep", type=int, default=64)
    sp.add_argument("--ntraj", type=int, default=1024)
    sp.add_argument("--chains", type=int, default=16)
    sp.add_argument("--tensorboard", action="store_true")
    sp.add_argument("--integrator", choices=["leapfrog", "omelyan"],
                    default="leapfrog")
    sp.add_argument("--force-backend", choices=["auto", "xla", "pallas"],
                    default="auto", dest="force_backend",
                    help="FT-HMC force: auto (the CUDA kernels on the card, "
                         "autograd on the CPU), xla (torch.autograd "
                         "through the flow) or pallas (the CUDA VJP "
                         "kernels K7/K1/K8 by name)")
    sp.add_argument("--start", choices=["hot", "cold"], default="hot",
                    help="cold = chain starts at z0 = f^{-1}(0) (bisection "
                         "inverse); the production recipe at beta >= ~5")
    sp.set_defaults(fn=cmd_fthmc)

    sp = sub.add_parser(
        "schwinger",
        help="dynamical-fermion (two-flavor Schwinger) HMC; add --ckpt "
             "for FT-HMC with a (pure-gauge-trained) flow")
    common(sp)
    flow_args(sp, restore=True)
    sp.add_argument("--ckpt", type=str, default=None,
                    help="flow checkpoint or exported .npz -> FT-HMC; omit "
                         "for plain HMC")
    sp.add_argument("--mass", type=float, default=0.1,
                    help="Wilson fermion mass m0")
    sp.add_argument("--tau", type=float, default=0.5)
    sp.add_argument("--nstep", type=int, default=16)
    sp.add_argument("--ntraj", type=int, default=256)
    sp.add_argument("--chains", type=int, default=64)
    sp.add_argument("--block", type=int, default=128)
    sp.add_argument("--integrator", choices=["leapfrog", "omelyan"],
                    default="omelyan")
    sp.add_argument("--n-inner", type=int, default=0,
                    help="multi-timescale (Sexton-Weingarten): nstep "
                         "counts OUTER fermion kicks, each drifting "
                         "through N inner gauge(-flow)-only Omelyan "
                         "steps; 0 = single-scale")
    sp.add_argument("--hasenbusch-dm", type=float, default=0.0,
                    help="Hasenbusch mass preconditioning (plain HMC): "
                         "split det at m1 = mass + dm; 3-level nested "
                         "Omelyan (nstep=ratio kicks, --n-mid heavy "
                         "steps/segment, --n-inner gauge steps/segment)")
    sp.add_argument("--n-mid", type=int, default=1,
                    help="heavy-term steps per outer drift segment "
                         "(Hasenbusch only)")
    sp.add_argument("--no-warm-start", action="store_true",
                    help="cold-start every force CG solve (exact "
                         "reversibility; ~2x more CG iterations)")
    sp.add_argument("--no-eo", action="store_true",
                    help="disable even-odd (Schur) preconditioning "
                         "(measured 2.5x fewer CG iterations when on)")
    sp.add_argument("--condensate", action="store_true",
                    help="stochastic <psibar psi> on the final configs")
    sp.add_argument("--start", choices=["hot", "cold"], default="hot")
    sp.add_argument("--state", type=str, default=None,
                    help="persistence file (npz) for the resilient "
                         "block+resume+watchdog runner: re-running the "
                         "same command resumes at the last completed "
                         "block (crashes lose at most --block "
                         "trajectories); single-device path only")
    sp.add_argument("--cg-backend", choices=["auto", "xla", "fused", "mixed"],
                    default="auto",
                    help="fermion solver backend: auto = fused on the card "
                         "(K11, the whole CG in one launch a solve), xla "
                         "on the CPU; xla = the torch CG; fused = K11 by "
                         "name; mixed = bf16 inner CG (K11_bf16) + fp32 "
                         "refinement")
    sp.set_defaults(fn=cmd_schwinger)

    sp = sub.add_parser("pipeline")
    common(sp)
    flow_args(sp, restore=True)  # None defaults: json/mode recipes win,
    #                              explicit flags override
    sp.add_argument("--mode", choices=["reference", "highbeta"],
                    default="reference",
                    help="reference = the full reference pipeline (hmc -> "
                         "train -> eval -> fthmc -> 2L transfer); highbeta "
                         "= the partial-trivialization workflow (train "
                         "smooth rncp flow at 8^2 beta~3, FT-HMC at the "
                         "target beta with it unchanged)")
    sp.add_argument("--json-file", type=str, default=None)
    sp.add_argument("--tau", type=float, default=1.0)
    sp.add_argument("--nstep", type=int, default=64)
    sp.add_argument("--ntraj", type=int, default=2048)
    sp.add_argument("--chains", type=int, default=16)
    sp.add_argument("--n-era", type=int, default=10)
    sp.add_argument("--n-epoch", type=int, default=100)
    sp.add_argument("--ensemble-size", type=int, default=8192)
    sp.add_argument("--transfer-epochs", type=int, default=100)
    sp.add_argument("--beta-init", type=float, default=None,
                    help="beta-annealed training start (highbeta: 2.0)")
    sp.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clip (highbeta: 1.0)")
    # --mode highbeta knobs (the flagship recipe's defaults)
    sp.add_argument("--ckpt", type=str, default=None,
                    help="highbeta: reuse this self-describing flow "
                         "checkpoint or exported .npz instead of training")
    sp.add_argument("--flow-L", type=int, default=8, dest="flow_L",
                    help="highbeta: train the flow at this small lattice")
    sp.add_argument("--flow-beta", type=float, default=3.0,
                    help="highbeta: anneal the flow to this beta (NOT the "
                         "target beta - smooth flows transfer, sharp ones "
                         "don't)")
    sp.add_argument("--flow-batch", type=int, default=512)
    sp.add_argument("--train-steps", type=int, default=15000)
    sp.add_argument("--ft-nstep", type=int, default=128)
    sp.add_argument("--ft-chains", type=int, default=64)
    sp.add_argument("--ft-integrator", choices=["leapfrog", "omelyan"],
                    default="omelyan")
    sp.add_argument("--plain-nstep", type=int, default=32)
    sp.add_argument("--plain-ntraj", type=int, default=32768)
    sp.add_argument("--plain-chains", type=int, default=128)
    sp.add_argument("--start", choices=["auto", "hot", "cold"],
                    default="auto",
                    help="highbeta chain starts (auto: cold at beta >= 5)")
    sp.set_defaults(fn=cmd_pipeline)

    sp = sub.add_parser("bench")
    common(sp)
    sp.add_argument("--chains", type=int, default=1024)
    sp.add_argument("--which", type=str, default="hmc",
                    choices=["hmc", "fthmc", "train", "sample", "all"])
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser(
        "queue", help="run/inspect a declarative experiment stage queue "
                      "(fthmc_tpu_torch.runner.run_queue: durable markers, "
                      "resumable after a machine recycle)")
    sp.add_argument("--queue", required=True, help="queue JSON file")
    sp.add_argument("--status", action="store_true")
    sp.add_argument("--only", default=None)
    sp.add_argument("--retry-failed", action="store_true",
                    help="re-attempt stages with .failed/.moot markers")
    sp.set_defaults(fn=cmd_queue)
    return p


def main(argv=None):
    """Run one subcommand; returns its result dict."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


def run() -> None:
    """Console-script entry: ``main`` without its return value, so that a
    finished run exits with status 0."""
    main()


if __name__ == "__main__":
    run()
