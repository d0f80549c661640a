"""Spatial domain decomposition: the lattice's row axis sharded over the
ranks of a mesh, halo rows exchanged between ring neighbours.

Counterpart of ``fthmc_tpu/parallel/domain.py``. A rank holds the rows
[rank * L0 / size, (rank + 1) * L0 / size) of every chain: links (B, 2,
L0 / size, L1). The plaquette and force stencils need one row from each
neighbour. The exchange is one ``torch.autograd.Function`` (``_RingFetch``)
on an all-gather of the edge rows, which runs at world size 1 on NCCL too
(no shortcut around it there): its forward hands each rank the rows of
the neighbour it names, and its backward returns each cotangent row to the
rank that owns it, where autograd adds it (the transpose of JAX's
ppermute). Sums over the lattice are all-reduced (``_psum``, outside
autograd): a force is the gradient of a rank's local contribution, never
of the reduced sum, which would count each term size times.

Draws: the momenta come from the rank's generator (``rank_generator``,
JAX's fold_in of the shard index), the accept uniforms from the shared
generator, seeded alike on every rank, so every rank takes the same accept
decision and the field does not tear. Each step has a deterministic core
``*_from`` that takes the draws. These drivers launch no kernel, as the
JAX ones run XLA code.
"""
from __future__ import annotations

from functools import partial

import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import HMCConfig
from fthmc_tpu_torch.hmc import (TrajMetrics, _generator, _stack, _start,
                                 leapfrog, run_blocks)
from fthmc_tpu_torch.parallel.mesh import (Mesh, _all_gather, _all_reduce,
                                           _gather, _local_count, _shard,
                                           make_mesh, rank_generator)
from fthmc_tpu_torch.schwinger import _accept

__all__ = ["plaq_phase_sharded", "action_sharded", "force_sharded",
           "topo_charge_sharded", "delta_action_sharded",
           "plaq_mean_sharded", "make_rows_mesh", "shard_rows",
           "gather_rows", "make_domain_hmc_step", "run_domain_hmc",
           "run_domain_hmc_chunked"]


def make_rows_mesh(n_devices: int | None = None, group=None,
                   axis: str = "rows", device=None) -> Mesh:
    """A 1-D mesh over the lattice ROW axis (domain decomposition)."""
    return make_mesh(axis, n_devices, group, device)


def shard_rows(mesh: Mesh, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """This rank's block of rows of a global field (rows along ``dim``:
    -2 for links (B, 2, L0, L1), -3 for spinors (B, L0, L1, 2))."""
    return _shard(mesh, x, dim)


def gather_rows(mesh: Mesh, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """The global field assembled from every rank's rows (a collective)."""
    return _gather(mesh, x, dim)


def _exchange(mesh: Mesh, parts) -> list:
    """Every rank's ``parts`` (real tensors of one dtype), in one
    all-gather: a list over ranks of lists of tensors."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    sizes = [p.numel() for p in parts]
    return [[c.reshape(p.shape) for c, p in zip(buf.split(sizes), parts)]
            for buf in _all_gather(mesh, flat)]


class _RingFetch(torch.autograd.Function):
    """out_i = parts_i of rank (rank + offsets_i) mod size. Forward: one
    all-gather of the parts. Backward: one all-gather of the cotangents;
    this rank's part i gets the cotangent of the rank that fetched it,
    rank - offsets_i."""

    @staticmethod
    def forward(ctx, mesh, offsets, *parts):
        ctx.mesh, ctx.offsets = mesh, offsets
        got = _exchange(mesh, parts)
        return tuple(got[(mesh.rank + o) % mesh.size][i].clone()
                     for i, o in enumerate(offsets))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        got = _exchange(mesh, [g.contiguous() for g in grads])
        return (None, None, *(got[(mesh.rank - o) % mesh.size][i]
                              for i, o in enumerate(ctx.offsets)))


def _fetch(mesh: Mesh, *pairs):
    """For each (tensor, offset): that tensor of rank (rank + offset) mod
    size, in one exchange, differentiable."""
    return _RingFetch.apply(mesh, tuple(o for _, o in pairs),
                            *(t.contiguous() for t, _ in pairs))


def _roll_m1_rows(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """roll(a, -1, dim=-2) across the sharded row axis."""
    (from_next,) = _fetch(mesh, (a[..., :1, :], 1))
    return torch.cat([a[..., 1:, :], from_next], dim=-2)


def _roll_p1_rows(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """roll(a, +1, dim=-2) across the sharded row axis."""
    (from_prev,) = _fetch(mesh, (a[..., -1:, :], -1))
    return torch.cat([from_prev, a[..., :-1, :]], dim=-2)


def _psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (outside autograd)."""
    return _all_reduce(mesh, t)


def plaq_phase_sharded(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Plaquette phase with the row axis sharded, x: (B, 2, L0loc, L1) ->
    (B, L0loc, L1); lattice.plaq_phase's convention, only the row roll
    crossing ranks."""
    x0, x1 = x[:, 0], x[:, 1]
    return (x0 + _roll_m1_rows(x1, mesh) - torch.roll(x0, -1, dims=-1)
            - x1)


def action_sharded(x: torch.Tensor, beta: float, mesh: Mesh) -> torch.Tensor:
    """Wilson action per chain, all-reduced over the ranks: (B,)."""
    local = torch.cos(plaq_phase_sharded(x, mesh)).sum(dim=(1, 2))
    return -beta * _psum(mesh, local)


def topo_charge_sharded(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Topological charge per chain, all-reduced: (B,)."""
    p = lattice.wrap(plaq_phase_sharded(x, mesh))
    return _psum(mesh, p.sum(dim=(1, 2))) / lattice.TWO_PI


def force_sharded(x: torch.Tensor, beta: float, mesh: Mesh) -> torch.Tensor:
    """The analytic force with halo exchange (lattice.force's stencil):
    F0 = beta (sin P - roll(sin P, +1, col)), F1 = beta (roll(sin P, +1,
    row) - sin P)."""
    sp = torch.sin(plaq_phase_sharded(x, mesh))
    f0 = sp - torch.roll(sp, 1, dims=-1)
    f1 = _roll_p1_rows(sp, mesh) - sp
    return beta * torch.stack((f0, f1), dim=1)


def delta_action_sharded(x1, x0, beta: float, mesh: Mesh) -> torch.Tensor:
    """S(x1) - S(x0) per chain across the ranks, as per-site cos
    differences (well conditioned in fp32)."""
    d = (torch.cos(plaq_phase_sharded(x1, mesh))
         - torch.cos(plaq_phase_sharded(x0, mesh)))
    return -beta * _psum(mesh, d.sum(dim=(1, 2)))


def plaq_mean_sharded(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean plaquette per chain across the ranks: (B,)."""
    local = torch.cos(plaq_phase_sharded(x, mesh)).sum(dim=(1, 2))
    n = x.shape[-2] * x.shape[-1] * mesh.size
    return _psum(mesh, local) / n


def _kinetic_delta_sharded(v1, v0, mesh: Mesh) -> torch.Tensor:
    """0.5 (sum v1^2 - sum v0^2) per chain across the ranks, delta form."""
    d = (v1 - v0) * (v1 + v0)
    return 0.5 * _psum(mesh, d.reshape(d.shape[0], -1).sum(dim=-1))


def _accept_metrics(dh, u, new, old, y_new_of, q_old, mesh: Mesh):
    """The accept (every rank holds dh and u alike, so every rank decides
    alike), the chosen fields, and the TrajMetrics of global (B,) tensors
    measured on the physical field ``y_new_of(chosen)``."""
    exp_mdh, acc, chosen = _accept(dh, u, new, old)
    y = y_new_of(chosen)
    q = topo_charge_sharded(y, mesh)
    m = TrajMetrics(dh=dh, exp_mdh=exp_mdh, acc=acc.to(dh.dtype),
                    plaq=plaq_mean_sharded(y, mesh), q=q,
                    dq=torch.abs(q - q_old))
    return chosen, q, m


@torch.no_grad()
def _domain_hmc_step_from(x, q_old, v0, u, *, beta: float, dt: float,
                          nstep: int, mesh: Mesh):
    """One leapfrog HMC trajectory of the row-sharded field on the given
    draws: this rank's momenta v0 (x's shape) and the accept uniforms u
    (B,), alike on every rank. Returns (x', q', TrajMetrics of global (B,)
    tensors, alike on every rank)."""
    x1, v = leapfrog(x, v0, dt, nstep,
                     lambda xx: force_sharded(xx, beta, mesh))
    x1 = lattice.wrap(x1)
    dh = (delta_action_sharded(x1, x, beta, mesh)
          + _kinetic_delta_sharded(v, v0, mesh))
    (x_new,), q, m = _accept_metrics(dh, u, (x1,), (x,), lambda c: c[0],
                                     q_old, mesh)
    return x_new, q, m


def _step_draws(generator: torch.Generator, mesh: Mesh, x: torch.Tensor):
    """(this rank's momenta from its rank generator, the accept uniforms
    from ``generator``), in that order; ``generator`` advances by the
    uniforms only, so the next step's rank generator differs."""
    rg = rank_generator(generator, mesh.rank)
    v0 = torch.randn(x.shape, generator=rg, dtype=x.dtype,
                     device=rg.device).to(x.device)
    u = torch.rand((x.shape[0],), generator=generator, dtype=x.dtype,
                   device=generator.device).to(x.device)
    return v0, u


def make_domain_hmc_step(mesh: Mesh, *, beta: float, dt: float,
                         nstep: int):
    """A full HMC step with the lattice rows sharded over ``mesh``:
    step(generator, x, q_old) -> (x', q', (dh, acc)), x this rank's rows,
    ``generator`` the shared one (seeded alike on every rank)."""
    def step(generator, x, q_old):
        v0, u = _step_draws(generator, mesh, x)
        x, q, m = _domain_hmc_step_from(x, q_old, v0, u, beta=beta, dt=dt,
                                        nstep=nstep, mesh=mesh)
        return x, q, (m.dh, m.acc)

    return step


def _domain_run(step_from, x, q, generator, mesh: Mesh, ntraj: int):
    """ntraj steps of ``step_from(x, q, v0, u)`` on the shared
    generator's draws: (x, q, TrajMetrics of (ntraj, B) tensors)."""
    history = []
    for _ in range(ntraj):
        v0, u = _step_draws(generator, mesh, x)
        x, q, m = step_from(x, q, v0, u)
        history.append(m)
    return x, q, _stack(history)


def _run_blocks(run, ntraj: int, block: int, state, callback):
    """``hmc.run_blocks`` over ``run(n, state) -> (state, TrajMetrics)``,
    the histories handed to ``callback(done, block)`` and returned as
    dicts of CPU (ntraj, B) tensors, as the JAX domain drivers give them."""
    cb = None if callback is None else (
        lambda done, hist: callback(done, hist._asdict()))
    state, hist = run_blocks(run, ntraj, block, state, cb)
    return state, hist._asdict()


def _hmc_core(cfg: HMCConfig, mesh: Mesh):
    """step_from(x, q, v0, u) of cfg's trajectory."""
    return partial(_domain_hmc_step_from, beta=cfg.beta, dt=cfg.dt,
                   nstep=cfg.nstep, mesh=mesh)


def _rows_setup(mesh: Mesh, cfg: HMCConfig, x0, generator, dtype):
    """(this rank's rows of the start, its charge, the shared generator)."""
    _local_count(mesh, cfg.L, "rows")
    generator = _generator(cfg, generator, mesh.device)
    x = shard_rows(mesh, _start(cfg, x0, generator, dtype, mesh.device))
    return x, topo_charge_sharded(x, mesh), generator


def run_domain_hmc(mesh: Mesh, cfg: HMCConfig, *, x0=None, generator=None,
                   dtype=torch.float32):
    """Row-sharded (domain-decomposed) HMC: cfg.ntraj trajectories with the
    lattice rows sharded over ``mesh``. x0 is the global start (by default
    the configuration's, from ``generator``, one seeded with cfg.seed on
    every rank when None). Returns (this rank's rows of the final field,
    history dict of (ntraj, B) tensors, the TrajMetrics fields, alike on
    every rank)."""
    x, q, generator = _rows_setup(mesh, cfg, x0, generator, dtype)
    x, _, hist = _domain_run(_hmc_core(cfg, mesh), x, q, generator, mesh,
                             cfg.ntraj)
    return x, hist._asdict()


def run_domain_hmc_chunked(mesh: Mesh, cfg: HMCConfig, *, block: int = 256,
                           x0=None, generator=None, callback=None,
                           dtype=torch.float32):
    """run_domain_hmc in blocks of ``block`` trajectories, histories on the
    host, ``callback(done, block_history)`` after each. Returns (this
    rank's rows, dict of CPU (ntraj, B) tensors)."""
    x, q, generator = _rows_setup(mesh, cfg, x0, generator, dtype)
    step_from = _hmc_core(cfg, mesh)

    def run(n, s):
        x, q, hist = _domain_run(step_from, *s, generator, mesh, n)
        return (x, q), hist

    (x, _), hist = _run_blocks(run, cfg.ntraj, block, (x, q), callback)
    return x, hist
