"""HMC samplers: plain HMC and flowed (field-transformation) HMC.

Counterpart of ``fthmc_tpu/hmc.py``. Chains are batched, (B, 2, L, L);
every trajectory ends in a per-chain Metropolis accept through
``torch.where``; energy differences are delta-form reductions (per-site
cos differences and (v1 - v0)(v1 + v0)), which keep fp32 acceptance
statistics those of fp64. Every random draw comes from the caller's
``torch.Generator``.

FT-HMC runs in the latent field z, with S_eff(z) = S(f(z)) - log|det df/dz|.
Its force is one of two backends:
  - 'kernel': the hand-written CUDA kernels (ops/coupling_vjp_kernels.py:
    K7 forward with residuals, K1 at the flow output, K8 backward) and K6
    for the two energy flows. On the CPU the same chain runs on their plain
    twins. 'auto' resolves to it on the card.
  - 'autograd': torch.autograd through the differentiable flow, the
    counterpart of the JAX package's 'xla' backend.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.models.flow import flow_forward
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_kernels import (kernel_fits,
                                                  kernel_flow_forward)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel

__all__ = ["TrajMetrics", "leapfrog", "omelyan", "hmc_step", "ft_action",
           "ft_force", "resolve_remat", "resolve_force_backend",
           "fthmc_step", "run_fthmc", "run_fthmc_chunked"]


class TrajMetrics(NamedTuple):
    """Per-trajectory, per-chain metrics (each (B,), or (ntraj, B) for a
    run's history)."""
    dh: torch.Tensor
    exp_mdh: torch.Tensor
    acc: torch.Tensor
    plaq: torch.Tensor
    q: torch.Tensor
    dq: torch.Tensor


def leapfrog(x: torch.Tensor, v: torch.Tensor, dt: float, nstep: int,
             force_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Position-Verlet leapfrog: half drift, nstep kicks with unit drifts
    between, then the half drift undone."""
    x = x + 0.5 * dt * v
    for _ in range(nstep):
        v = v - dt * force_fn(x)
        x = x + dt * v
    x = x - 0.5 * dt * v
    return x, v


# Omelyan-Mryglod-Folk 2nd-order minimum-norm coefficient (2MN).
OMELYAN_LAMBDA = 0.1931833275037836


def omelyan(x: torch.Tensor, v: torch.Tensor, dt: float, nstep: int,
            force_fn: Callable[[torch.Tensor], torch.Tensor]):
    """2MN integrator: per step kick(l dt) drift(dt/2) kick((1-2l) dt)
    drift(dt/2) kick(l dt), adjacent l-kicks merged across steps, so a
    trajectory makes 2 * nstep + 1 force evaluations."""
    lam = OMELYAN_LAMBDA
    v = v - (lam * dt) * force_fn(x)
    for i in range(nstep):
        x = x + (0.5 * dt) * v
        v = v - ((1.0 - 2.0 * lam) * dt) * force_fn(x)
        x = x + (0.5 * dt) * v
        w = lam * dt if i == nstep - 1 else 2.0 * lam * dt
        v = v - w * force_fn(x)
    return x, v


def _kinetic_delta(v1: torch.Tensor, v0: torch.Tensor) -> torch.Tensor:
    """0.5 (sum v1^2 - sum v0^2) per chain, as an elementwise difference."""
    d = (v1 - v0) * (v1 + v0)
    return 0.5 * d.reshape(d.shape[0], -1).sum(dim=-1)


def _normal(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def _uniform(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape, generator=generator, dtype=like.dtype,
                      device=generator.device).to(like.device)


def _metropolis(generator, dh, new, old):
    """Per-chain accept of ``new`` over ``old`` (tuples of (B, ...))."""
    exp_mdh = torch.exp(-dh)
    acc = _uniform(generator, dh) < exp_mdh
    accb = acc[:, None, None, None]
    return exp_mdh, acc, [torch.where(accb, n, o) for n, o in zip(new, old)]


def _metrics(dh, exp_mdh, acc, y, q_old):
    q = lattice.topo_charge(y)
    return TrajMetrics(dh=dh, exp_mdh=exp_mdh, acc=acc.to(dh.dtype),
                       plaq=lattice.plaq_mean(y), q=q, dq=(q - q_old).abs())


@torch.no_grad()
def hmc_step(generator: torch.Generator, x: torch.Tensor,
             q_old: torch.Tensor, beta: float, dt: float, nstep: int,
             integrator: str = "leapfrog"):
    """One batched plain-HMC trajectory with the analytic force (K1 on the
    card). Returns (x', q', metrics)."""
    v0 = _normal(generator, x)
    integ = omelyan if integrator == "omelyan" else leapfrog
    x1, v1 = integ(x, v0, dt, nstep,
                   lambda xx: lattice.batch_force(xx, beta))
    x1 = lattice.wrap(x1)
    dh = lattice.delta_action(x1, x, beta) + _kinetic_delta(v1, v0)
    exp_mdh, acc, (x_new,) = _metropolis(generator, dh, (x1,), (x,))
    m = _metrics(dh, exp_mdh, acc, x_new, q_old)
    return x_new, m.q, m


def resolve_remat(remat, shape) -> bool:
    """'auto' -> checkpoint each coupling layer only when the activation
    footprint is large (B * L^2 above 2^20 sites)."""
    if remat == "auto":
        B, _, L, _ = shape
        return B * L * L > (1 << 20)
    return bool(remat)


def ft_action(params, spec: FlowSpec, z: torch.Tensor, beta: float,
              remat="auto") -> torch.Tensor:
    """Effective action in latent space, per chain (B,)."""
    y, logdet = flow_forward(params, z, spec,
                             remat=resolve_remat(remat, z.shape))
    return lattice.batch_action(y, beta) - logdet


def _autograd_force(params, spec, z, beta, remat):
    with torch.enable_grad(), full_fp32():
        zz = z.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            ft_action(params, spec, zz, beta, remat=remat).sum(), zz)
    return g


def _on_device(device: torch.device, z: torch.Tensor, params) -> torch.Tensor:
    """``z`` moved to ``device``; the parameters must already be there."""
    w = params[0][0]["w"]
    if w.device.type != device.type or (device.index is not None
                                        and w.device.index != device.index):
        raise ValueError(f"flow parameters are on {w.device}, the run on "
                         f"{device}")
    return z.to(device)


def ft_force(params, spec: FlowSpec, z: torch.Tensor, beta: float,
             remat="auto", device=None) -> torch.Tensor:
    """dS_eff/dz by autograd through the whole flow (the 'autograd'
    backend), on ``device`` (the card by default)."""
    z = _on_device(resolve_device(device), z, params)
    return _autograd_force(params, spec, z, beta, remat)


def resolve_force_backend(force_backend: str, spec: FlowSpec, z_shape,
                          dtype, device) -> str:
    """'auto' -> 'kernel' on the card, 'autograd' on the CPU. 'kernel'
    outside the kernels' envelope (spline, bf16 convs, a shape they do not
    take, non-fp32 fields on the card) is refused loudly, so on the card a
    run the kernels do not take raises under 'auto' too and the autograd
    force runs only when asked for by name. On the CPU the kernel chain runs
    its plain twins, which take fp64 fields too."""
    B, _, L, _ = z_shape
    on_card = torch.device(device).type == "cuda"
    if force_backend == "auto":
        force_backend = "kernel" if on_card else "autograd"
    if force_backend == "kernel":
        if spec.coupling not in ("ncp", "rncp"):
            raise ValueError(f"force_backend='kernel' supports coupling "
                             f"'ncp'/'rncp', not {spec.coupling!r}")
        if spec.conv_dtype != "float32" or (on_card
                                            and dtype != torch.float32):
            raise ValueError("force_backend='kernel' requires "
                             "conv_dtype='float32' and, on the card, fp32 "
                             "fields")
        if not kernel_fits(spec, L, B):
            raise ValueError(f"force_backend='kernel' unsupported at L={L}, "
                             f"B={B} for this spec (ops/coupling_kernels."
                             f"kernel_fits); use 'autograd'")
        return "kernel"
    if force_backend == "autograd":
        return "autograd"
    raise ValueError(f"unknown force_backend {force_backend!r}")


def _flow_and_force(params, spec, beta, remat, backend):
    """(energy flow, force) of a backend."""
    if backend == "kernel":
        return (lambda zz: kernel_flow_forward(params, zz, spec),
                lambda zz: ft_force_kernel(params, spec, zz, beta))
    return (lambda zz: flow_forward(params, zz, spec, remat=remat),
            lambda zz: _autograd_force(params, spec, zz, beta, remat))


@torch.no_grad()
def _fthmc_step(generator, z, q_old, beta, dt, nstep, integrator, flow,
                force_fn):
    v0 = _normal(generator, z)
    y0, logdet0 = flow(z)
    integ = omelyan if integrator == "omelyan" else leapfrog
    z1, v1 = integ(z, v0, dt, nstep, force_fn)
    z1 = lattice.wrap(z1)
    y1, logdet1 = flow(z1)
    # dH = [S(y1) - logdet1] - [S(y0) - logdet0] + dK, delta-form Wilson term
    dh = (lattice.delta_action(y1, y0, beta) - (logdet1 - logdet0)
          + _kinetic_delta(v1, v0))
    exp_mdh, acc, (z_new, y_new) = _metropolis(generator, dh, (z1, y1),
                                               (z, y0))
    m = _metrics(dh, exp_mdh, acc, y_new, q_old)
    return z_new, y_new, m.q, m


def fthmc_step(params, spec: FlowSpec, generator: torch.Generator,
               z: torch.Tensor, q_old: torch.Tensor, beta: float, dt: float,
               nstep: int, remat="auto", integrator: str = "leapfrog",
               force_backend: str = "auto", device=None):
    """One batched FT-HMC trajectory in latent space z: (B, 2, L, L).
    Returns (z', y', q', metrics); observables are measured on y = f(z)."""
    device = resolve_device(device)
    z = _on_device(device, z, params)
    remat = resolve_remat(remat, z.shape)
    backend = resolve_force_backend(force_backend, spec, z.shape, z.dtype,
                                    device)
    flow, force_fn = _flow_and_force(params, spec, beta, remat, backend)
    return _fthmc_step(generator, z, q_old.to(device), beta, dt, nstep,
                       integrator, flow, force_fn)


def run_fthmc(params, spec: FlowSpec, lf: LeapfrogConfig, *, beta: float,
              ntraj: int, z0: torch.Tensor, generator: torch.Generator,
              remat="auto", integrator: str = "leapfrog",
              force_backend: str = "auto", device=None):
    """Run ntraj batched FT-HMC trajectories from latent z0.
    Returns (z_final, TrajMetrics history of (ntraj, B) tensors)."""
    device = resolve_device(device)
    z = _on_device(device, z0, params)
    remat = resolve_remat(remat, z.shape)
    backend = resolve_force_backend(force_backend, spec, z.shape, z.dtype,
                                    device)
    flow, force_fn = _flow_and_force(params, spec, beta, remat, backend)
    with torch.no_grad():
        q = lattice.topo_charge(flow(z)[0])
    history = []
    for _ in range(ntraj):
        z, _, q, m = _fthmc_step(generator, z, q, beta, lf.dt, lf.nstep,
                                 integrator, flow, force_fn)
        history.append(m)
    return z, TrajMetrics(*[torch.stack(f) for f in zip(*history)])


def run_fthmc_chunked(params, spec: FlowSpec, lf: LeapfrogConfig, *,
                      beta: float, ntraj: int, z0: torch.Tensor,
                      generator: torch.Generator, block: int = 1024,
                      callback=None, remat="auto",
                      integrator: str = "leapfrog",
                      force_backend: str = "auto", device=None):
    """run_fthmc in blocks of ``block`` trajectories, with the history moved
    to the host and ``callback(done, block_history)`` after each block.
    Returns (z_final, TrajMetrics of CPU tensors (ntraj, B))."""
    blocks = []
    z, done = z0, 0
    while done < ntraj:
        n = min(block, ntraj - done)
        z, hist = run_fthmc(params, spec, lf, beta=beta, ntraj=n, z0=z,
                            generator=generator, remat=remat,
                            integrator=integrator,
                            force_backend=force_backend, device=device)
        hist = TrajMetrics(*[t.cpu() for t in hist])
        blocks.append(hist)
        done += n
        if callback is not None:
            callback(done, hist)
    return z, TrajMetrics(*[torch.cat(f) for f in zip(*blocks)])
