"""Chain-axis sharding over torch.distributed: one rank a device, each
running the single-device drivers on its slice of the chains.

Counterpart of ``fthmc_tpu/parallel/mesh.py``. A JAX ``Mesh`` becomes
``Mesh``, a frozen record of a process group (None: the default group),
its axis name, this rank, the group's size and this rank's device; the
group's backend must serve the device (NCCL for CUDA, gloo for the CPU),
and a mismatch raises. ``mesh.size`` stands where JAX reads
``mesh.devices.size``.

Tensors are this rank's shards, never global arrays: ``shard_chains``
takes a rank's slice of a global batch, ``gather_chains`` assembles one,
``replicate`` broadcasts rank 0's tensors (and generator states). The
whole-run drivers take global starts, return this rank's final chains and
the history gathered into global (ntraj, n_chains) ``TrajMetrics``, as
JAX returns them; the gather is their one collective.

Random draws: ``rank_generator(generator, rank)`` is the counterpart of
``fold_in(key, axis_index)``, a generator seeded from a hash of the
caller's generator state and the rank, which it does not advance. The
whole-run drivers run each rank's shard on its rank generator, so a rank's
chains are those of the single-device driver run on that shard with that
generator, bit for bit. The step-level functions draw the global batch's
momenta and accept uniforms from the caller's generator (seeded alike on
every rank) and keep their slice, as the JAX steps' draws are partitioned:
each equals its single-device step on the whole batch.

Data-parallel training (``sharded_train_era``): each rank draws batch /
size latents from its rank generator, the loss and gradients are averaged
over ranks in one all-reduce, the exact global ESS takes a max and a sum,
and the update runs alike on every rank. On the card the era follows
``train.MESH_ERA_GRAPHED``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any

import torch
import torch.distributed as dist

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import (TrajMetrics, _flow_and_force, _generator,
                                 _kinetic_delta, _metrics, _on_device,
                                 _start, _trajectory, leapfrog,
                                 resolve_force_backend, resolve_remat,
                                 run_blocks, run_fthmc, run_hmc)
from fthmc_tpu_torch.models.priors import uniform_link_prior
from fthmc_tpu_torch.schwinger import (SchwingerConfig, _accept, _setup,
                                       run_fthmc_dyn, run_hmc_dyn)

__all__ = ["Mesh", "make_chain_mesh", "make_mesh", "shard_chains",
           "gather_chains", "gather_metrics", "replicate", "rank_generator",
           "sharded_hmc_step", "sharded_fthmc_step", "sharded_train_step",
           "sharded_run_hmc", "sharded_run_fthmc",
           "sharded_run_fthmc_chunked", "sharded_train_era",
           "sharded_run_hmc_dyn", "sharded_run_fthmc_dyn",
           "sharded_run_hmc_dyn_chunked", "sharded_run_fthmc_dyn_chunked",
           "initialize_multihost", "COLLECTIVES", "reset_collectives"]

# the backend that serves a device type
_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}

# Collectives this process has issued through the parallel package, by kind
# (the domain drivers' halo exchanges are all-gathers, their sums
# all-reduces); reset_collectives() sets them to 0. A Python count: under a
# graphed era (train.MESH_ERA_GRAPHED) it counts the collectives of the
# capture only, not those of each replay.
COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "broadcast": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``size`` ranks of ``group`` (None: the default
    group) along ``axis``, this process being ``rank`` on ``device``."""
    group: Any
    axis: str
    rank: int
    size: int
    device: torch.device


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         store=None) -> None:
    """``torch.distributed.init_process_group`` on NCCL (the cards): from
    the ``torchrun`` environment (MASTER_ADDR, RANK, WORLD_SIZE) when no
    address or store is given, else at ``tcp://coordinator_address`` or on
    ``store`` with ``num_processes`` ranks, this one ``process_id``. The
    CPU's gloo ranks come from ``parallel.launch.spawn``."""
    if not torch.cuda.is_available():
        raise RuntimeError("NCCL needs a CUDA card and none is available; "
                           "run gloo ranks on the CPU with "
                           "parallel.launch.spawn")
    if coordinator_address is None and store is None:
        dist.init_process_group("nccl")
        return
    kw = {"store": store} if store is not None else {
        "init_method": f"tcp://{coordinator_address}"}
    dist.init_process_group("nccl", world_size=num_processes,
                            rank=process_id, **kw)


def _local_device(device) -> torch.device:
    """``None``: the card of this rank, cuda:<LOCAL_RANK> (raises without
    a card)."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(axis: str, n_devices: int | None = None, group=None,
              device=None) -> Mesh:
    """A 1-D mesh over ``group`` (the default group when None) along
    ``axis`` on this rank's ``device`` (the card, cuda:<LOCAL_RANK>, by
    default). ``n_devices``, when given, must be the group's size (a
    sub-mesh is a group of its own, ``torch.distributed.new_group``)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "initialize_multihost() or init_process_group()")
    device = _local_device(device)
    backend = str(dist.get_backend(group))
    served = {part.split(":")[-1] for part in backend.split(",")}
    want = _BACKEND_OF.get(device.type)
    if want not in served:
        raise ValueError(f"the group's backend {backend!r} does not serve "
                         f"{device}; it needs {want!r}")
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the group has {size} "
                         f"ranks; make a group of {n_devices} instead")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, axis, dist.get_rank(group), size, device)


def make_chain_mesh(n_devices: int | None = None, group=None,
                    axis: str = "chains", device=None) -> Mesh:
    """A 1-D mesh over the chain/batch axis."""
    return make_mesh(axis, n_devices, group, device)


def _local_count(mesh: Mesh, n: int, what: str = "chains") -> int:
    if n % mesh.size:
        raise ValueError(f"{n} {what} do not split over {mesh.size} ranks")
    return n // mesh.size


def _shard(mesh: Mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block of x along ``dim``, on the mesh's device."""
    n = _local_count(mesh, x.shape[dim], f"entries along dim {dim}")
    return x.narrow(dim, mesh.rank * n, n).to(mesh.device)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (the same shape on each), in rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    return out


def _gather(mesh: Mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(_all_gather(mesh, t), dim=dim)


def _all_reduce(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM):
    """A reduced copy of ``t`` (outside autograd)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    COLLECTIVES["all_reduce"] += 1
    return out


def shard_chains(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a global (B, ...) batch, on its device."""
    return _shard(mesh, x, 0)


def gather_chains(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global batch assembled from every rank's chains along ``dim``
    (a collective: every rank calls it)."""
    return _gather(mesh, x, dim)


def gather_metrics(mesh: Mesh, hist: TrajMetrics) -> TrajMetrics:
    """A history of (ntraj, B_local) fields as global (ntraj, B) fields, in
    one all-gather."""
    dt = hist.dh.dtype
    parts = _all_gather(mesh, torch.stack([f.to(dt) for f in hist]))
    cat = torch.cat(parts, dim=-1)
    return TrajMetrics(*[c.to(f.dtype) for c, f in zip(cat, hist)])


def _src(mesh: Mesh) -> int:
    """The global rank of the group's rank 0."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def _leaves(tree, out: list):
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


def _rebuild(tree, it):
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(v, it) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return tree


def replicate(mesh: Mesh, tree):
    """``tree`` (tensors and generators in lists, tuples, dicts and named
    tuples) with every tensor and generator state rank 0's, on the mesh's
    device: one broadcast a dtype. Generators are new ones on their own
    device holding rank 0's state."""
    leaves = _leaves(tree, [])
    flat = [g.get_state() if isinstance(g, torch.Generator) else g
            for g in leaves]
    got: list = [None] * len(flat)
    for dt in dict.fromkeys(t.dtype for t in flat):
        idx = [i for i, t in enumerate(flat) if t.dtype == dt]
        buf = torch.cat([flat[i].detach().reshape(-1).to(mesh.device)
                         for i in idx])
        dist.broadcast(buf, src=_src(mesh), group=mesh.group)
        COLLECTIVES["broadcast"] += 1
        for i, part in zip(idx, buf.split([flat[i].numel() for i in idx])):
            got[i] = part.reshape(flat[i].shape)
    out = []
    for leaf, t in zip(leaves, got):
        if isinstance(leaf, torch.Generator):
            g = torch.Generator(leaf.device)
            g.set_state(t.cpu())
            out.append(g)
        else:
            out.append(t.clone())
    return _rebuild(tree, iter(out))


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """The counterpart of ``fold_in(key, rank)``: a new generator on
    ``generator``'s device, seeded from a hash of its state and ``rank``.
    ``generator`` is not advanced, so equal states give equal streams."""
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(rank).to_bytes(8, "little"),
                             digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
    return torch.Generator(generator.device).manual_seed(seed)


def _global_draw(mesh: Mesh, generator: torch.Generator, shape, dtype,
                 normal: bool) -> torch.Tensor:
    """This rank's slice of a (size * shape[0], ...) draw from
    ``generator``."""
    full = (shape[0] * mesh.size,) + tuple(shape[1:])
    draw = torch.randn if normal else torch.rand
    return _shard(mesh, draw(full, generator=generator, dtype=dtype,
                             device=generator.device), 0)


# ---------------------------------------------------------------------------
# step-level functions
# ---------------------------------------------------------------------------

def sharded_hmc_step(mesh: Mesh, *, beta: float, dt: float, nstep: int):
    """hmc_step with the chain axis sharded over ``mesh``: step(generator,
    x, q_old) -> (x', q', metrics) on this rank's chains. The backend is
    pinned to 'xla' (the leapfrog loop with K1 as the force on the card),
    as the JAX step pins it; no collective. The momenta and accept
    uniforms are the whole batch's draws from ``generator`` (seeded alike
    on every rank), this rank's slice kept."""
    @torch.no_grad()
    def step(generator, x, q_old):
        x, q_old = x.to(mesh.device), q_old.to(mesh.device)
        v0 = _global_draw(mesh, generator, x.shape, x.dtype, True)
        x1, v1 = _trajectory(x, v0, beta, dt, nstep, "xla", "leapfrog")
        x1 = lattice.wrap(x1)
        dh = lattice.delta_action(x1, x, beta) + _kinetic_delta(v1, v0)
        u = _global_draw(mesh, generator, dh.shape, dh.dtype, False)
        exp_mdh, acc, (x_new,) = _accept(dh, u, (x1,), (x,))
        m = _metrics(dh, exp_mdh, acc, x_new, q_old)
        return x_new, m.q, m

    return step


def sharded_fthmc_step(mesh: Mesh, spec: FlowSpec, *, beta: float,
                       dt: float, nstep: int):
    """fthmc_step with the chains sharded and the flow parameters held
    alike on every rank: step(params, generator, z, q_old) -> (z', y', q',
    metrics) on this rank's chains, the whole batch's draws from
    ``generator`` sliced (see ``sharded_hmc_step``); no collective."""
    @torch.no_grad()
    def step(params, generator, z, q_old):
        z = _on_device(mesh.device, z, params)
        rm = resolve_remat("auto", z.shape)
        backend = resolve_force_backend("auto", spec, z.shape, z.dtype,
                                        mesh.device)
        flow, force_fn = _flow_and_force(params, spec, beta, rm, backend)
        v0 = _global_draw(mesh, generator, z.shape, z.dtype, True)
        y0, logdet0 = flow(z)
        z1, v1 = leapfrog(z, v0, dt, nstep, force_fn)
        z1 = lattice.wrap(z1)
        y1, logdet1 = flow(z1)
        dh = (lattice.delta_action(y1, y0, beta) - (logdet1 - logdet0)
              + _kinetic_delta(v1, v0))
        u = _global_draw(mesh, generator, dh.shape, dh.dtype, False)
        exp_mdh, acc, (z_new, y_new) = _accept(dh, u, (z1, y1), (z, y0))
        m = _metrics(dh, exp_mdh, acc, y_new, q_old.to(mesh.device))
        return z_new, y_new, m.q, m

    return step


def _dp_loss_and_grads(mesh: Mesh, params, spec: FlowSpec, z: torch.Tensor,
                       beta, dkl_factor: float = 1.0,
                       force_weight: float = 0.0):
    """The data-parallel step's deterministic core at this rank's latents
    z: the loss, the scalars (dkl, mean logp, mean logq, mean |dQ|) and the
    parameter gradients, each averaged over the ranks in one all-reduce
    (the ranks' batches are equal, so this is the loss and gradient of the
    whole batch), and this rank's (logp, logq)."""
    from fthmc_tpu_torch.train import loss_and_grads
    loss, aux, grads = loss_and_grads(params, spec, z, beta, dkl_factor,
                                      force_weight)
    logp, logq = aux["logp"], aux["logq"]
    dq = torch.mean(torch.abs(lattice.batch_charges(aux["x"])
                              - lattice.batch_charges(z)))
    scal = torch.stack([loss, aux["dkl"], logp.mean(), logq.mean(), dq])
    flat = torch.cat([scal.to(grads[0].dtype)]
                     + [g.reshape(-1) for g in grads])
    flat = _all_reduce(mesh, flat) / mesh.size
    grads = [part.reshape(g.shape) for part, g in zip(
        flat[5:].split([g.numel() for g in grads]), grads)]
    return flat[0], flat[1:5], grads, (logp, logq)


def _dp_step(mesh: Mesh, state, spec: FlowSpec, z: torch.Tensor, beta,
             batch: int, dkl_factor: float, base_lr: float, grad_clip,
             force_weight: float, sched=None):
    """One data-parallel reverse-KL step at this rank's latents z (batch /
    size of them): ``_dp_loss_and_grads``, the exact global ESS (a max,
    then a sum), the update and the plateau rule alike on every rank.
    Returns (state, scalar metrics), those of
    ``fthmc_tpu.parallel.mesh.sharded_train_era``."""
    from fthmc_tpu_torch.train import _apply, _plateau_update_device
    L = z.shape[-1]
    loss, (dkl, logp_m, logq_m, dq), grads, (logp, logq) = \
        _dp_loss_and_grads(mesh, state.params, spec, z, beta, dkl_factor,
                           force_weight)
    state = _apply(state, grads, base_lr, grad_clip)
    logw = logp - logq
    m = _all_reduce(mesh, logw.max(), dist.ReduceOp.MAX)
    w = torch.exp(logw - m)
    s1, s2 = _all_reduce(mesh, torch.stack([w.sum(), (w * w).sum()]))
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=z.device)
    metrics = {"loss_dkl": loss, "dkl": dkl, "ess": s1 * s1 / (batch * s2),
               "logp": logp_m, "logq": logq_m, "dq_mean": dq,
               "plaq": logp_m / (beta_t * L * L), "beta": beta_t}
    state = state._replace(step=state.step + 1)
    if sched is not None:
        state = _plateau_update_device(state, loss, sched, base_lr)
    metrics["lr_scale"] = state.lr_scale
    return state, metrics


def sharded_train_step(mesh: Mesh, spec: FlowSpec, *, batch: int, L: int,
                       beta: float, dkl_factor: float, base_lr: float):
    """The reverse-KL train step data-parallel over the mesh: step(state)
    -> (state, metrics). The whole batch is drawn from the state's
    generator (alike on every rank) and each rank keeps its slice; the
    gradients are averaged over ranks (``_dp_step``)."""
    def step(state):
        prior = uniform_link_prior(L, state.params[0][0]["w"].dtype,
                                   device=mesh.device)
        z = _shard(mesh, prior.sample_n(state.generator, batch), 0)
        return _dp_step(mesh, state, spec, z, beta, batch, dkl_factor,
                        base_lr, None, 0.0)

    return step


class _RankDraws:
    """An era's latent batches: this rank's batch / size prior draws an
    epoch from its rank generator (the counterpart of fold_in(kstep,
    axis_index))."""

    def __init__(self, state, mesh: Mesh, L: int, local_batch: int):
        w = state.params[0][0]["w"]
        self.prior = uniform_link_prior(L, w.dtype, device=w.device)
        self.generator = rank_generator(state.generator, mesh.rank)
        self.batch = local_batch
        self.shapes = [(local_batch, 2, L, L)]

    def __call__(self):
        return [self.prior.sample_n(self.generator, self.batch)]


def sharded_train_era(mesh: Mesh, state, spec: FlowSpec, *, batch: int,
                      L: int, beta: float, dkl_factor: float = 1.0,
                      base_lr: float = 1e-3, n_epoch: int = 100,
                      sched=None, betas: torch.Tensor | None = None,
                      grad_clip: float | None = None,
                      force_weight: float = 0.0):
    """One training era (n_epoch reverse-KL steps) data-parallel over the
    mesh: the state is replicated from rank 0, each rank draws batch /
    size latents an epoch from its rank generator, and every step averages
    the loss and gradients over ranks (``_dp_step``), so the parameters
    and Adam's state stay alike on every rank. The state's generator
    advances by one draw an era (every rank alike). On the card the era is
    a CUDA-graph replay or eager as ``train.MESH_ERA_GRAPHED`` says; on the
    CPU eager. Returns (state, {metric: numpy (n_epoch,)}) as
    ``train_era``."""
    from fthmc_tpu_torch.train import MESH_ERA_GRAPHED, _run_era
    local = _local_count(mesh, batch, "samples")
    state = replicate(mesh, state)
    dev = state.lr_scale.device
    if betas is None:
        betas = torch.full((n_epoch,), beta, dtype=torch.float32, device=dev)
    draw = _RankDraws(state, mesh, L, local)
    torch.rand((1,), generator=state.generator, device=state.generator.device)

    def step(st, zs, beta_e):
        return _dp_step(mesh, st, spec, zs[0], beta_e, batch, dkl_factor,
                        base_lr, grad_clip, force_weight, sched)

    return _run_era(step, state, draw, betas,
                    dev.type == "cuda" and MESH_ERA_GRAPHED)


# ---------------------------------------------------------------------------
# whole-run drivers: each rank runs the single-device driver on its shard
# ---------------------------------------------------------------------------

def _chains_setup(mesh: Mesh, x0, generator):
    """(this rank's x0 shard, its rank generator)."""
    return shard_chains(mesh, x0), rank_generator(generator, mesh.rank)


def sharded_run_hmc(mesh: Mesh, cfg: HMCConfig, *, x0=None, generator=None,
                    backend: str = "auto", integrator: str = "leapfrog",
                    dtype=torch.float32):
    """run_hmc with cfg.n_chains sharded over ``mesh``: each rank runs
    ``hmc.run_hmc`` on its chains with its rank generator (the trajectory
    kernels dispatch as on one device). x0 is the global start (by default
    the configuration's, drawn from ``generator``, which defaults to one
    seeded with cfg.seed on every rank). Returns (this rank's final
    chains, TrajMetrics of global (ntraj, n_chains) tensors)."""
    generator = _generator(cfg, generator, mesh.device)
    x0 = _start(cfg, x0, generator, dtype, mesh.device)
    x, rg = _chains_setup(mesh, x0, generator)
    x, hist = run_hmc(dataclasses.replace(cfg, n_chains=x.shape[0]), x0=x,
                      generator=rg, dtype=dtype, backend=backend,
                      integrator=integrator, device=mesh.device)
    return x, gather_metrics(mesh, hist)


def sharded_run_fthmc(mesh: Mesh, params, spec: FlowSpec, lf: LeapfrogConfig,
                      *, beta: float, ntraj: int, z0: torch.Tensor,
                      generator: torch.Generator, remat="auto",
                      integrator: str = "leapfrog",
                      force_backend: str = "auto"):
    """run_fthmc with the chains of the global z0 sharded over ``mesh`` and
    the flow parameters held alike on every rank (``replicate`` makes them
    so): each rank runs ``hmc.run_fthmc`` on its chains with its rank
    generator (K6-K8 and K1 on the card). Returns (this rank's final
    latents, TrajMetrics of global (ntraj, B) tensors)."""
    z, rg = _chains_setup(mesh, z0, generator)
    z, hist = run_fthmc(params, spec, lf, beta=beta, ntraj=ntraj, z0=z,
                        generator=rg, remat=remat, integrator=integrator,
                        force_backend=force_backend, device=mesh.device)
    return z, gather_metrics(mesh, hist)


def _blocks(mesh: Mesh, run_local, ntraj: int, block: int, state, callback):
    """``hmc.run_blocks`` over ``run_local(n, state)``, each block's
    history gathered to global chains before it moves to the host."""
    def run(n, s):
        s, hist = run_local(n, s)
        return s, gather_metrics(mesh, hist)

    return run_blocks(run, ntraj, block, state, callback)


def sharded_run_fthmc_chunked(mesh: Mesh, params, spec: FlowSpec,
                              lf: LeapfrogConfig, *, beta: float, ntraj: int,
                              z0: torch.Tensor, generator: torch.Generator,
                              block: int = 1024, callback=None,
                              remat="auto", integrator: str = "leapfrog",
                              force_backend: str = "auto"):
    """sharded_run_fthmc in blocks of ``block`` trajectories, one rank
    generator throughout; ``callback(done, block_history)`` with each
    block's global history on the host. Returns (this rank's latents,
    TrajMetrics of CPU tensors (ntraj, B))."""
    z, rg = _chains_setup(mesh, z0, generator)

    def run(n, zz):
        return run_fthmc(params, spec, lf, beta=beta, ntraj=n, z0=zz,
                         generator=rg, remat=remat, integrator=integrator,
                         force_backend=force_backend, device=mesh.device)

    return _blocks(mesh, run, ntraj, block, z, callback)


def _dyn_setup(mesh: Mesh, cfg: SchwingerConfig, x0, generator):
    """(this rank's start, its rank generator, the rank's configuration) of
    a dynamical run: x0 global, by default run_hmc_dyn's start (a hot start
    from ``generator``, one seeded with 0 on every rank when None)."""
    _, generator, x0 = _setup(cfg, x0, generator, mesh.device)
    x, rg = _chains_setup(mesh, x0, generator)
    return x, rg, dataclasses.replace(cfg, n_chains=x.shape[0])


def sharded_run_hmc_dyn(mesh: Mesh, cfg: SchwingerConfig, *, x0=None,
                        generator=None):
    """schwinger.run_hmc_dyn with cfg.n_chains sharded over ``mesh``: each
    rank solves its own chains (K11 on the card), its CG trip counts its
    own. Returns (this rank's chains, TrajMetrics with global (ntraj,
    n_chains) tensors)."""
    x, rg, lcfg = _dyn_setup(mesh, cfg, x0, generator)
    x, hist = run_hmc_dyn(lcfg, x0=x, generator=rg, device=mesh.device)
    return x, gather_metrics(mesh, hist)


def sharded_run_fthmc_dyn(mesh: Mesh, params, spec: FlowSpec,
                          cfg: SchwingerConfig, *, z0, generator,
                          remat="auto", force_backend: str = "auto"):
    """Dynamical FT-HMC with the chains of the global z0 sharded and the
    flow parameters alike on every rank. Returns (this rank's latents,
    TrajMetrics with global (ntraj, B) tensors)."""
    z, rg, lcfg = _dyn_setup(mesh, cfg, z0, generator)
    z, hist = run_fthmc_dyn(params, spec, lcfg, z0=z, generator=rg,
                            remat=remat, force_backend=force_backend,
                            device=mesh.device)
    return z, gather_metrics(mesh, hist)


def sharded_run_hmc_dyn_chunked(mesh: Mesh, cfg: SchwingerConfig, *,
                                block: int = 256, x0=None, generator=None,
                                callback=None):
    """sharded_run_hmc_dyn in blocks of ``block`` trajectories, one rank
    generator throughout, each block's global history on the host and
    passed to ``callback(done, block_history)``. Returns (this rank's
    chains, TrajMetrics of CPU tensors)."""
    x, rg, lcfg = _dyn_setup(mesh, cfg, x0, generator)

    def run(n, xx):
        return run_hmc_dyn(dataclasses.replace(lcfg, ntraj=n), x0=xx,
                           generator=rg, device=mesh.device)

    return _blocks(mesh, run, cfg.ntraj, block, x, callback)


def sharded_run_fthmc_dyn_chunked(mesh: Mesh, params, spec: FlowSpec,
                                  cfg: SchwingerConfig, *, block: int = 128,
                                  z0=None, generator=None, callback=None,
                                  remat="auto",
                                  force_backend: str = "auto"):
    """Blocked dynamical FT-HMC over the mesh (see
    sharded_run_hmc_dyn_chunked). Returns (this rank's latents,
    TrajMetrics of CPU tensors)."""
    z, rg, lcfg = _dyn_setup(mesh, cfg, z0, generator)

    def run(n, zz):
        return run_fthmc_dyn(params, spec, dataclasses.replace(lcfg, ntraj=n),
                             z0=zz, generator=rg, remat=remat,
                             force_backend=force_backend,
                             device=mesh.device)

    return _blocks(mesh, run, cfg.ntraj, block, z, callback)
