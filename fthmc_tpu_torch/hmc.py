"""HMC samplers: plain HMC and flowed (field-transformation) HMC.

Counterpart of ``fthmc_tpu/hmc.py``. Chains are batched, (B, 2, L, L);
every trajectory ends in a per-chain Metropolis accept through
``torch.where``; energy differences are delta-form reductions (per-site
cos differences and (v1 - v0)(v1 + v0)), which keep fp32 acceptance
statistics those of fp64. Every random draw comes from the caller's
``torch.Generator``. A run is a Python loop over trajectories, not one
compiled program as in the JAX package.

Plain HMC has the JAX package's backends, mapped onto the port's kernels
(ops/lattice_kernels.py; on the CPU each runs its plain twin):
  - 'xla': the torch loop of ``leapfrog`` / ``omelyan`` with K1 as the
    force, the counterpart of the JAX package's XLA scan;
  - 'pallas': K2, the whole trajectory in one launch, chains-first;
  - 'pallas_cl': K3, the same chains-last;
  - 'fused': K4, refresh + trajectory + energy + Metropolis in one launch,
    drawing from its in-kernel Philox stream (seeded from the generator);
  - 'fused_hostrng': K5, the same with the momenta and accept draws taken
    from the generator as 'xla' takes them, so its chains follow 'xla' up
    to roundoff (the port's name for the JAX package's
    ``pallas_hmc_traj_hostrng`` path);
  - 'auto': 'xla' on the CPU; on the card the port's own rule,
    ``_select_leapfrog``. fp64 fields on the card raise.
The trajectory kernels integrate leapfrog only: 'omelyan' with any of them
raises (the JAX package runs leapfrog there unasked); 'omelyan' under
'auto' runs the 'xla' loop, K1 on the card.

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

import dataclasses
from typing import Callable, NamedTuple

import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.models.flow import flow_forward
from fthmc_tpu_torch.ops import lattice_kernels as lk
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_kernels import (kernel_fits,
                                                  kernel_flow_forward)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel
from fthmc_tpu_torch.utils.profiling import span

__all__ = ["TrajMetrics", "leapfrog", "omelyan", "BACKENDS",
           "resolve_backend", "run_leapfrog", "hmc_step", "run_hmc",
           "run_hmc_thinned", "run_hmc_nrun", "run_hmc_chunked", "run_blocks",
           "ft_action", "ft_force", "resolve_remat", "resolve_force_backend",
           "fthmc_step", "run_fthmc", "run_fthmc_thinned",
           "run_fthmc_chunked"]


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


# ---------------------------------------------------------------------------
# Plain HMC
# ---------------------------------------------------------------------------

BACKENDS = ("auto", "xla", "pallas", "pallas_cl", "fused", "fused_hostrng")
_KERNEL_BACKENDS = ("pallas", "pallas_cl", "fused", "fused_hostrng")


# 'auto' runs leapfrog through K3 up to this L, through K2 above
AUTO_K3_MAX_L = 16


def _select_leapfrog(integrator: str, dtype, device: torch.device,
                     shape=None) -> str:
    """What 'auto' means: 'xla' on the CPU; on the card 'xla' (K1) for
    omelyan, and for leapfrog of (B, 2, L, L) fields ``shape`` K3
    ('pallas_cl') up to L = AUTO_K3_MAX_L and K2 ('pallas') above (and
    where the shape is not given). As the card's time on an NVIDIA H100
    80GB HBM3 at 700 W, a 25-step trajectory of 1024 chains took K3 0.011
    and 0.020 ms against K2's 0.025 and 0.027 at 8^2 and 16^2 (128 chains:
    0.010 / 0.020 and 0.014 / 0.045), and K2 led from 32^2 up (0.061
    against 0.063; 1.9x at 48^2 and 64^2) (PERF.md section 6, the 'auto'
    rule). fp64 on the card raises: no kernel takes it."""
    if device.type != "cuda":
        return "xla"
    if dtype != torch.float32:
        raise ValueError(f"backend='auto' on the card takes fp32 fields, got "
                         f"{dtype}; the kernels have no fp64 path")
    if integrator == "omelyan":
        return "xla"
    if shape is not None and shape[-1] <= AUTO_K3_MAX_L:
        return "pallas_cl"
    return "pallas"


def resolve_backend(backend: str, integrator: str, dtype, device,
                    shape=None) -> str:
    """The backend a plain-HMC trajectory of (B, 2, L, L) fields ``shape``
    runs on (see the module docstring). Refuses unknown names and
    'omelyan' with a trajectory kernel; the kernels' wrappers refuse, at
    launch, shapes and types they do not take."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if integrator not in ("leapfrog", "omelyan"):
        raise ValueError(f"unknown integrator {integrator!r}")
    if integrator == "omelyan" and backend in _KERNEL_BACKENDS:
        raise ValueError(f"backend={backend!r} integrates leapfrog only; "
                         f"omelyan runs on 'xla' or 'auto'")
    if backend == "auto":
        return _select_leapfrog(integrator, dtype, torch.device(device),
                                shape)
    return backend


def _trajectory(x, v, beta, dt, nstep, backend, integrator):
    """(x1, v1) of a resolved trajectory backend."""
    if backend == "pallas":
        return lk.leapfrog(x, v, beta, dt, nstep)
    if backend == "pallas_cl":
        return lk.leapfrog_cl(x, v, beta, dt, nstep)
    integ = omelyan if integrator == "omelyan" else leapfrog
    return integ(x, v, dt, nstep, lambda xx: lattice.batch_force(xx, beta))


@torch.no_grad()
def run_leapfrog(x: torch.Tensor, v: torch.Tensor, beta: float, dt: float,
                 nstep: int, backend: str = "auto",
                 integrator: str = "leapfrog", device=None):
    """One trajectory of (x, v) on ``device`` (the card by default) through
    'xla', 'pallas', 'pallas_cl' or 'auto'. Returns (x1, v1), unwrapped."""
    device = resolve_device(device)
    x, v = x.to(device), v.to(device)
    backend = resolve_backend(backend, integrator, x.dtype, device, x.shape)
    if backend in ("fused", "fused_hostrng"):
        raise ValueError(f"backend={backend!r} is a whole HMC step "
                         f"(hmc_step), not a trajectory")
    return _trajectory(x, v, beta, dt, nstep, backend, integrator)


def _hmc_step(generator, x, q_old, beta, dt, nstep, backend, integrator):
    """hmc_step on a resolved backend, with x and q_old on the run's
    device. The trajectory is the span ``fthmc.step``, its phases the
    spans ``fthmc.step.{momenta,integrate,energy,accept,observe}`` (see
    ``_fthmc_step``); a fused kernel is ``integrate``, the draws it takes
    ``momenta``, and its dH needs no ``energy``. After a trajectory of K2,
    K3 or the K1 loop the accept uniforms are drawn (``accept``; the
    generator gives the momenta, then the uniforms) and the rest of the
    step is one epilogue, ``lk.hmc_epilogue`` (``energy``): K12 on the
    card, on the CPU its twin, the torch ops of wrap, dH, accept and
    ``_metrics``."""
    with span("fthmc.step"):
        if backend == "fused":
            with span("fthmc.step.momenta"):
                seed = torch.randint(0, 2 ** 31 - 1, (1,),
                                     generator=generator, dtype=torch.int32,
                                     device=generator.device)
            with span("fthmc.step.integrate"):
                x_new, dh, acc = lk.hmc_traj(x, seed.to(x.device), beta, dt,
                                             nstep)
            with span("fthmc.step.accept"):
                exp_mdh = torch.exp(-dh)
        elif backend == "fused_hostrng":
            with span("fthmc.step.momenta"):
                v0 = _normal(generator, x)
                u = _uniform(generator, x[:, 0, 0, 0])
            with span("fthmc.step.integrate"):
                x_new, dh, acc = lk.hmc_traj_hostrng(x, v0, u, beta, dt,
                                                     nstep)
            with span("fthmc.step.accept"):
                exp_mdh = torch.exp(-dh)
        else:
            with span("fthmc.step.momenta"):
                v0 = _normal(generator, x)
            with span("fthmc.step.integrate"):
                x1, v1 = _trajectory(x, v0, beta, dt, nstep, backend,
                                     integrator)
            with span("fthmc.step.accept"):
                u = _uniform(generator, x[:, 0, 0, 0])
            with span("fthmc.step.energy"):
                x_new, rows = lk.hmc_epilogue(x, x1, v1, v0, u, q_old, beta)
            with span("fthmc.step.observe"):
                m = TrajMetrics(*rows)
            return x_new, m.q, m
        with span("fthmc.step.observe"):
            m = _metrics(dh, exp_mdh, acc, x_new, q_old)
    return x_new, m.q, m


@torch.no_grad()
def hmc_step(generator: torch.Generator, x: torch.Tensor,
             q_old: torch.Tensor, beta: float, dt: float, nstep: int,
             backend: str = "auto", integrator: str = "leapfrog",
             device=None):
    """One batched plain-HMC trajectory of x: (B, 2, L, L) on ``device``
    (the card by default). Returns (x', q', metrics)."""
    device = resolve_device(device)
    x, q_old = x.to(device), q_old.to(device)
    backend = resolve_backend(backend, integrator, x.dtype, device, x.shape)
    return _hmc_step(generator, x, q_old, beta, dt, nstep, backend,
                     integrator)


def _start(cfg: HMCConfig, x0, generator, dtype, device) -> torch.Tensor:
    """x0 on the run's device, or the configuration's start: a hot start
    from the generator (cfg.randinit) or the cold (zero-link) one."""
    if x0 is not None:
        return x0.to(device)
    if cfg.randinit:
        return lattice.hot_start(generator, cfg.n_chains, cfg.L,
                                 device=device, dtype=dtype)
    return torch.zeros((cfg.n_chains, 2, cfg.L, cfg.L), dtype=dtype,
                       device=device)


def _generator(cfg: HMCConfig, generator, device) -> torch.Generator:
    """The caller's generator, or one on the device seeded with cfg.seed."""
    if generator is None:
        return torch.Generator(device).manual_seed(cfg.seed)
    return generator


def _run_setup(cfg, x0, generator, dtype, backend, integrator, device):
    """(generator, x0, resolved backend, device) of a run."""
    device = resolve_device(device)
    generator = _generator(cfg, generator, device)
    x = _start(cfg, x0, generator, dtype, device)
    return (generator, x,
            resolve_backend(backend, integrator, x.dtype, device, x.shape),
            device)


def _stack(history: list[TrajMetrics]) -> TrajMetrics:
    return TrajMetrics(*[torch.stack(f) for f in zip(*history)])


@torch.no_grad()
def run_hmc(cfg: HMCConfig, x0: torch.Tensor | None = None,
            generator: torch.Generator | None = None,
            dtype=torch.float32, backend: str = "auto",
            integrator: str = "leapfrog", device=None):
    """cfg.ntraj batched trajectories of cfg.n_chains chains on ``device``
    (the card by default), from x0 or the configuration's start. The
    generator defaults to one on the device seeded with cfg.seed.
    Returns (x_final, TrajMetrics history of (ntraj, n_chains) tensors)."""
    generator, x, backend, _ = _run_setup(cfg, x0, generator, dtype,
                                          backend, integrator, device)
    q = lattice.topo_charge(x)
    history = []
    for _ in range(cfg.ntraj):
        x, q, m = _hmc_step(generator, x, q, cfg.beta, cfg.dt, cfg.nstep,
                            backend, integrator)
        history.append(m)
    return x, _stack(history)


@torch.no_grad()
def run_hmc_thinned(cfg: HMCConfig, *, thin: int,
                    x0: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    dtype=torch.float32, backend: str = "auto",
                    integrator: str = "leapfrog", device=None):
    """run_hmc for long runs: the history keeps the last trajectory of every
    ``thin`` ((ntraj // thin, B) tensors), and a summary dict holds exact
    running means over ALL trajectories (acc, plaq, exp_mdh, abs_dh, each a
    0-d tensor). cfg.ntraj must be a multiple of thin."""
    if thin < 1 or cfg.ntraj % thin:
        raise ValueError(f"ntraj={cfg.ntraj} is not a multiple of "
                         f"thin={thin}")
    generator, x, backend, device = _run_setup(cfg, x0, generator, dtype,
                                               backend, integrator, device)
    q = lattice.topo_charge(x)
    sums = dict.fromkeys(("acc", "plaq", "exp_mdh", "abs_dh"),
                         torch.zeros((), dtype=x.dtype, device=device))
    history = []
    for i in range(cfg.ntraj):
        x, q, m = _hmc_step(generator, x, q, cfg.beta, cfg.dt, cfg.nstep,
                            backend, integrator)
        for k, t in (("acc", m.acc), ("plaq", m.plaq),
                     ("exp_mdh", m.exp_mdh), ("abs_dh", m.dh.abs())):
            sums[k] = sums[k] + t.mean()
        if (i + 1) % thin == 0:
            history.append(m)
    return x, _stack(history), {k: v / cfg.ntraj for k, v in sums.items()}


def run_hmc_nrun(cfg: HMCConfig, generator: torch.Generator | None = None,
                 dtype=torch.float32, backend: str = "auto",
                 integrator: str = "leapfrog", device=None):
    """cfg.nrun independent runs, each from a fresh start (the
    configuration's), drawing on in turn from one generator. Returns
    (x_final of the last run, TrajMetrics of (nrun, ntraj, n_chains))."""
    device = resolve_device(device)
    generator = _generator(cfg, generator, device)
    runs, x = [], None
    for _ in range(cfg.nrun):
        x, hist = run_hmc(cfg, generator=generator, dtype=dtype,
                          backend=backend, integrator=integrator,
                          device=device)
        runs.append(hist)
    return x, _stack(runs)


def run_blocks(run, ntraj: int, block: int, state, callback):
    """Blocks of ``block`` trajectories through ``run(n, state) -> (state,
    history)``, each block's history moved to the host and passed to
    ``callback(done, block_history)``. Returns (state, TrajMetrics of CPU
    tensors (ntraj, B))."""
    blocks, done = [], 0
    while done < ntraj:
        n = min(block, ntraj - done)
        state, hist = run(n, state)
        hist = TrajMetrics(*[t.cpu() for t in hist])
        blocks.append(hist)
        done += n
        if callback is not None:
            callback(done, hist)
    return state, TrajMetrics(*[torch.cat(f) for f in zip(*blocks)])


def run_hmc_chunked(cfg: HMCConfig, *, block: int = 1024,
                    x0: torch.Tensor | None = None,
                    generator: torch.Generator | None = None,
                    callback=None, dtype=torch.float32,
                    backend: str = "auto", integrator: str = "leapfrog",
                    device=None):
    """run_hmc in blocks of ``block`` trajectories, with the history moved
    to the host and ``callback(done, block_history)`` after each block.
    Returns (x_final, TrajMetrics of CPU tensors (ntraj, n_chains))."""
    device = resolve_device(device)
    generator = _generator(cfg, generator, device)

    def run(n, x):
        return run_hmc(dataclasses.replace(cfg, ntraj=n), x0=x,
                       generator=generator, dtype=dtype, backend=backend,
                       integrator=integrator, device=device)

    return run_blocks(run, cfg.ntraj, block, x0, callback)


# ---------------------------------------------------------------------------
# Flowed HMC
# ---------------------------------------------------------------------------

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
    """One trajectory, the span ``fthmc.step``. Its phases are the spans
    ``fthmc.step.momenta`` (the draw), ``.energy`` (the flow of z, and
    after the trajectory the flow of z1 with dH), ``.integrate`` (every
    force), ``.accept`` (Metropolis) and ``.observe`` (charge and
    plaquette): a profiler's trace holds them on the clock of the card's
    kernels (``utils.profiling.span``); without a profiler each costs one
    check."""
    with span("fthmc.step"):
        with span("fthmc.step.momenta"):
            v0 = _normal(generator, z)
        with span("fthmc.step.energy"):
            y0, logdet0 = flow(z)
        with span("fthmc.step.integrate"):
            integ = omelyan if integrator == "omelyan" else leapfrog
            z1, v1 = integ(z, v0, dt, nstep, force_fn)
        with span("fthmc.step.energy"):
            z1 = lattice.wrap(z1)
            y1, logdet1 = flow(z1)
            # dH = [S(y1) - logdet1] - [S(y0) - logdet0] + dK, delta-form
            # Wilson term
            dh = (lattice.delta_action(y1, y0, beta) - (logdet1 - logdet0)
                  + _kinetic_delta(v1, v0))
        with span("fthmc.step.accept"):
            exp_mdh, acc, (z_new, y_new) = _metropolis(generator, dh,
                                                       (z1, y1), (z, y0))
        with span("fthmc.step.observe"):
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


def _fthmc_setup(params, spec, beta, z0, remat, force_backend, device):
    """(z0 on the run's device, its charge, energy flow, force) of a run."""
    device = resolve_device(device)
    z = _on_device(device, z0, params)
    remat = resolve_remat(remat, z.shape)
    backend = resolve_force_backend(force_backend, spec, z.shape, z.dtype,
                                    device)
    flow, force_fn = _flow_and_force(params, spec, beta, remat, backend)
    with torch.no_grad():
        q = lattice.topo_charge(flow(z)[0])
    return z, q, flow, force_fn


def run_fthmc(params, spec: FlowSpec, lf: LeapfrogConfig, *, beta: float,
              ntraj: int, z0: torch.Tensor, generator: torch.Generator,
              remat="auto", integrator: str = "leapfrog",
              force_backend: str = "auto", device=None):
    """Run ntraj batched FT-HMC trajectories from latent z0.
    Returns (z_final, TrajMetrics history of (ntraj, B) tensors)."""
    z, q, flow, force_fn = _fthmc_setup(params, spec, beta, z0, remat,
                                        force_backend, device)
    history = []
    for _ in range(ntraj):
        z, _, q, m = _fthmc_step(generator, z, q, beta, lf.dt, lf.nstep,
                                 integrator, flow, force_fn)
        history.append(m)
    return z, TrajMetrics(*[torch.stack(f) for f in zip(*history)])


def run_fthmc_thinned(params, spec: FlowSpec, lf: LeapfrogConfig, *,
                      beta: float, ntraj: int, thin: int, z0: torch.Tensor,
                      generator: torch.Generator, remat="auto",
                      integrator: str = "leapfrog",
                      force_backend: str = "auto", device=None):
    """run_fthmc for long runs: the history keeps the last trajectory of
    every ``thin`` ((ntraj // thin, B) tensors), and a summary dict holds
    exact running means over ALL trajectories (acc, plaq, exp_mdh, abs_dh,
    each a 0-d tensor). ntraj must be a multiple of thin."""
    if thin < 1 or ntraj % thin:
        raise ValueError(f"ntraj={ntraj} is not a multiple of thin={thin}")
    z, q, flow, force_fn = _fthmc_setup(params, spec, beta, z0, remat,
                                        force_backend, device)
    sums = dict.fromkeys(("acc", "plaq", "exp_mdh", "abs_dh"),
                         torch.zeros((), dtype=z.dtype, device=z.device))
    history = []
    for i in range(ntraj):
        z, _, q, m = _fthmc_step(generator, z, q, beta, lf.dt, lf.nstep,
                                 integrator, flow, force_fn)
        for k, t in (("acc", m.acc), ("plaq", m.plaq),
                     ("exp_mdh", m.exp_mdh), ("abs_dh", m.dh.abs())):
            sums[k] = sums[k] + t.mean()
        if (i + 1) % thin == 0:
            history.append(m)
    return z, _stack(history), {k: v / ntraj for k, v in sums.items()}


def run_fthmc_chunked(params, spec: FlowSpec, lf: LeapfrogConfig, *,
                      beta: float, ntraj: int, z0: torch.Tensor,
                      generator: torch.Generator, block: int = 1024,
                      callback=None, remat="auto",
                      integrator: str = "leapfrog",
                      force_backend: str = "auto", device=None):
    """run_fthmc in blocks of ``block`` trajectories, with the history moved
    to the host and ``callback(done, block_history)`` after each block.
    Returns (z_final, TrajMetrics of CPU tensors (ntraj, B))."""
    def run(n, z):
        return run_fthmc(params, spec, lf, beta=beta, ntraj=n, z0=z,
                         generator=generator, remat=remat,
                         integrator=integrator, force_backend=force_backend,
                         device=device)

    return run_blocks(run, ntraj, block, z0, callback)
