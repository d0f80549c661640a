"""Two-flavour Schwinger model samplers with dynamical Wilson fermions:
plain HMC and FT-HMC, single scale or nested, and plain HMC with
Hasenbusch mass preconditioning. Counterpart of ``fthmc_tpu/schwinger.py``.

A trajectory: momenta v0 ~ N(0, 1); pseudofermion heatbath phi = D^dag chi
(eo: Dhat^dag chi on even sites), whose start action chi^dag chi needs no
solve; integrate with the force dS/dx = gauge sin stencil (K1 on the card)
+ fermion force (torch.autograd of ``fermion.pf_action_lin`` around a CG
solve at ``cg_tol_force``, warm-started from the last solve when
``warm_start``); Metropolis with dH = dS_gauge (delta form) + S_pf(x1) -
chi^dag chi + dK, the end S_pf from a solve at ``cg_tol_mh`` (also
warm-started when ``warm_start``). Every draw comes from the caller's
``torch.Generator``, in the order v0, Re chi, Im chi, u (the accept
uniforms). FT-HMC runs the same dynamics in the latent field z with
S_eff(z) = S(f(z)) - log|det df/dz|; the CG solve runs on the detached
physical field and its force is pulled back through the flow (on the card:
K7 over every layer, K1 plus the fermion force at y, K8 back).

Multi-timescale (Sexton-Weingarten) integration, ``n_inner > 0``: the
outer scale kicks with the fermion force alone (one solve each), and each
outer drift is a gauge-only Omelyan integration (``gauge_drift``: K1 on
the card, no solve; FT: the flow's pull-back of the gauge action and the
log-det, ``ft_gauge_force``, against ``ft_fermion_force``, whose log-det
cotangent is 0). Hasenbusch (``hasenbusch_dm > 0``, plain HMC only):
det(D^dag D) split at m1 = mass + dm into a ratio term (light solves, the
outer kicks), a heavy term (the middle scale) and the gauge force (the
inner scale) of ``nested_omelyan_3level``. ``force_evaluations`` counts
every scale's forces a trajectory by running the integrator itself.

The CG is ``fermion.cg_solve`` on the process default backend
(``fermion.set_cg_backend``; 'auto' unless set: K11, one launch a solve,
on the card, the torch CG on the CPU; 'mixed' the mixed-precision CG) with
the configuration's ``cg_layout`` (the packed planes chains-first 'cf' or
chains-last 'cl', 'auto' by fermion_kernels.resolve_layout).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from fthmc_tpu_torch import fermion, lattice
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import (OMELYAN_LAMBDA, _autograd_force,
                                 _flow_and_force, _kinetic_delta, _metrics,
                                 _normal, _on_device, _stack, _uniform,
                                 run_blocks, resolve_force_backend,
                                 resolve_remat)
from fthmc_tpu_torch.models.flow import flow_forward
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (flow_vjp_kernel,
                                                      ft_force_kernel)
from fthmc_tpu_torch.utils.profiling import span

__all__ = ["SchwingerConfig", "dyn_force", "leapfrog_aux", "omelyan_aux",
           "hmc_step_dyn", "run_hmc_dyn", "run_hmc_dyn_chunked",
           "ft_dyn_force", "fthmc_step_dyn", "run_fthmc_dyn",
           "run_fthmc_dyn_chunked", "gauge_drift", "nested_leapfrog_aux",
           "nested_omelyan_aux", "nested_omelyan_3level", "force_evaluations",
           "hb_step_dyn", "ft_gauge_force", "ft_fermion_force"]


@dataclasses.dataclass(frozen=True)
class SchwingerConfig:
    """Dynamical-fermion run parameters: the JAX package's fields and
    defaults, plus the CG's layout. With n_inner > 0, nstep counts outer
    steps (fermion kicks) and each outer drift integrates the gauge force
    alone in Omelyan sub-steps; with hasenbusch_dm > 0 (plain HMC only),
    nstep outer ratio kicks, n_mid heavy steps an outer drift segment and
    n_inner (at least 1) gauge steps a heavy drift segment."""
    L: int = 16
    beta: float = 4.0
    mass: float = 0.1
    tau: float = 1.0
    nstep: int = 20
    n_chains: int = 64
    ntraj: int = 256
    integrator: str = "omelyan"
    cg_tol_force: float = 1e-9   # on |r|^2 / |b|^2
    cg_tol_mh: float = 1e-12     # the Metropolis solve
    cg_maxiter: int = 1000
    warm_start: bool = True      # chronological inverter
    eo_precond: bool = True      # even-odd Schur solves
    n_inner: int = 0             # gauge sub-steps (multi-timescale)
    hasenbusch_dm: float = 0.0   # m1 = mass + dm (Hasenbusch)
    n_mid: int = 1               # heavy steps (Hasenbusch)
    cg_layout: str = "auto"      # 'cf', 'cl' (chains-last); 'auto': 'cl'
    #                              at 8^2, 'cf' above (resolve_layout)

    @property
    def dt(self) -> float:
        return self.tau / self.nstep


def _check(cfg: SchwingerConfig) -> None:
    if cfg.integrator not in ("leapfrog", "omelyan"):
        raise ValueError(f"unknown integrator {cfg.integrator!r}")


def _solve_kw(cfg: SchwingerConfig) -> dict:
    return dict(maxiter=cfg.cg_maxiter, eo=cfg.eo_precond,
                layout=cfg.cg_layout)


# ---------------------------------------------------------------- plain HMC

def dyn_force(x, phi, beta: float, mass: float, x_guess, tol: float,
              maxiter: int, eo: bool = False, backend: str | None = None,
              layout: str = "auto"):
    """Total force dS/dx = gauge sin stencil (K1 on the card) + fermion
    force. Returns (force, CGResult); JAX's returns the solution alone."""
    res = fermion.cg_solve(x, phi, mass, x_guess, tol=tol, maxiter=maxiter,
                           eo=eo, backend=backend, layout=layout)
    ff = fermion.pf_force_at(x, phi, res.x, mass, eo)
    return lattice.batch_force(x, beta) + ff, res


def leapfrog_aux(x, v, dt: float, nstep: int, force_fn, aux):
    """Position-Verlet leapfrog, one force a step; force_fn(x, aux) ->
    (force, aux)."""
    for _ in range(nstep):
        x_half = x + 0.5 * dt * v
        f, aux = force_fn(x_half, aux)
        v = v - dt * f
        x = x_half + 0.5 * dt * v
    return x, v, aux


def omelyan_aux(x, v, dt: float, nstep: int, force_fn, aux):
    """2MN Omelyan, position first, two forces a step (the kicks of
    adjacent steps are not merged); force_fn(x, aux) -> (force, aux)."""
    lam = OMELYAN_LAMBDA
    for _ in range(nstep):
        x = x + lam * dt * v
        f, aux = force_fn(x, aux)
        v = v - 0.5 * dt * f
        x = x + (1.0 - 2.0 * lam) * dt * v
        f, aux = force_fn(x, aux)
        v = v - 0.5 * dt * f
        x = x + lam * dt * v
    return x, v, aux


def gauge_drift(x, v, span: float, n_in: int, force_g):
    """Integrate the gauge(-flow)-only dynamics for time ``span`` in n_in
    Omelyan 2MN steps (force_g(x) -> f, no auxiliary state, no solve): a
    symplectic, time-reversible drift for a Sexton-Weingarten nesting."""
    lam = OMELYAN_LAMBDA
    dt = span / n_in
    for _ in range(n_in):
        x = x + lam * dt * v
        v = v - 0.5 * dt * force_g(x)
        x = x + (1.0 - 2.0 * lam) * dt * v
        v = v - 0.5 * dt * force_g(x)
        x = x + lam * dt * v
    return x, v


def nested_leapfrog_aux(x, v, dt: float, nstep: int, n_in: int, force_f,
                        force_g, aux):
    """Multi-timescale leapfrog: outer kicks of the fermion force
    (force_f(x, aux) -> (f, aux), adjacent half-kicks fused: nstep + 1
    evaluations) around gauge-only drifts of n_in Omelyan steps."""
    f, aux = force_f(x, aux)
    v = v - 0.5 * dt * f
    for _ in range(nstep - 1):
        x, v = gauge_drift(x, v, dt, n_in, force_g)
        f, aux = force_f(x, aux)
        v = v - dt * f
    x, v = gauge_drift(x, v, dt, n_in, force_g)
    f, aux = force_f(x, aux)
    return x, v - 0.5 * dt * f, aux


def nested_omelyan_aux(x, v, dt: float, nstep: int, n_in: int, force_f,
                       force_g, aux):
    """Multi-timescale Omelyan 2MN, Omelyan at the outer (fermion) scale
    too (two solves an outer step), each outer drift segment integrated by
    gauge-only Omelyan sub-steps in proportion to its span (about 2 n_in
    in all: n_edge for the lam dt segments, n_mid for the (1 - 2 lam) dt
    one, rounded as the JAX package rounds, Python's round)."""
    lam = OMELYAN_LAMBDA
    n_edge = max(1, round(n_in * lam * 2.0))      # lam * dt segment
    n_mid = max(1, 2 * n_in - 2 * n_edge)          # (1 - 2 lam) * dt
    for _ in range(nstep):
        x, v = gauge_drift(x, v, lam * dt, n_edge, force_g)
        f, aux = force_f(x, aux)
        v = v - 0.5 * dt * f
        x, v = gauge_drift(x, v, (1.0 - 2.0 * lam) * dt, n_mid, force_g)
        f, aux = force_f(x, aux)
        v = v - 0.5 * dt * f
        x, v = gauge_drift(x, v, lam * dt, n_edge, force_g)
    return x, v, aux


def nested_omelyan_3level(x, v, dt: float, nstep: int, n_mid: int,
                          n_in: int, force_outer, force_mid, force_g, aux):
    """Three-timescale nested Omelyan: outer kicks of force_outer (the
    ratio term), each outer drift segment n_mid Omelyan steps of force_mid
    (the heavy term), each of their drift segments n_in gauge-only Omelyan
    steps. force_outer / force_mid: (x, aux) -> (f, aux), aux shared (each
    force reads and writes its own warm-start slot)."""
    lam = OMELYAN_LAMBDA

    def mid_drift(x, v, span, aux):
        mdt = span / n_mid
        for _ in range(n_mid):
            x, v = gauge_drift(x, v, lam * mdt, n_in, force_g)
            f, aux = force_mid(x, aux)
            v = v - 0.5 * mdt * f
            x, v = gauge_drift(x, v, (1.0 - 2.0 * lam) * mdt, n_in, force_g)
            f, aux = force_mid(x, aux)
            v = v - 0.5 * mdt * f
            x, v = gauge_drift(x, v, lam * mdt, n_in, force_g)
        return x, v, aux

    for _ in range(nstep):
        x, v, aux = mid_drift(x, v, lam * dt, aux)
        f, aux = force_outer(x, aux)
        v = v - 0.5 * dt * f
        x, v, aux = mid_drift(x, v, (1.0 - 2.0 * lam) * dt, aux)
        f, aux = force_outer(x, aux)
        v = v - 0.5 * dt * f
        x, v, aux = mid_drift(x, v, lam * dt, aux)
    return x, v, aux


def _integrate(cfg: SchwingerConfig, x, v, aux, dyn=None, fermion=None,
               gauge=None, heavy=None, ratio=None):
    """(x, v, aux) after cfg's integrator: single scale on ``dyn`` (x, aux)
    -> (f, aux); nested (n_inner > 0) on ``fermion`` (x, aux) -> (f, aux)
    around ``gauge`` (x) -> f; Hasenbusch on ``ratio``, ``heavy`` and
    ``gauge``."""
    if cfg.hasenbusch_dm > 0:
        return nested_omelyan_3level(x, v, cfg.dt, cfg.nstep, cfg.n_mid,
                                     max(cfg.n_inner, 1), ratio, heavy,
                                     gauge, aux)
    omelyan = cfg.integrator == "omelyan"
    if cfg.n_inner > 0:
        nested = nested_omelyan_aux if omelyan else nested_leapfrog_aux
        return nested(x, v, cfg.dt, cfg.nstep, cfg.n_inner, fermion, gauge,
                      aux)
    integ = omelyan_aux if omelyan else leapfrog_aux
    return integ(x, v, cfg.dt, cfg.nstep, dyn, aux)


def force_evaluations(cfg: SchwingerConfig) -> dict:
    """Force evaluations of one trajectory of cfg's integrator, by kind
    ('dyn' single scale; 'fermion' and 'gauge' nested; 'ratio', 'heavy'
    and 'gauge' Hasenbusch): the integrator itself run on scalar zeros with
    counting forces, so the count is the integrator's own."""
    counts: dict = {}
    zero = torch.zeros(())

    def counter(kind):
        def force(x, aux=None):
            counts[kind] = counts.get(kind, 0) + 1
            return zero if kind == "gauge" else (zero, aux)
        return force

    _integrate(cfg, zero, zero, None, **{k: counter(k) for k in (
        "dyn", "fermion", "gauge", "heavy", "ratio")})
    return counts


def _draws(generator: torch.Generator, x: torch.Tensor, n_chi: int = 1):
    """(v0, chi..., u) of one trajectory of x (B, 2, L0, L1) from the
    generator, in that order: v0 ~ N(0, 1) in x's dtype, ``n_chi`` fields
    chi ~ CN(0, 1) complex64 (each its real parts, then its imaginary: one
    for the standard pseudofermion, chi1 and chi2 for Hasenbusch, JAX's
    order), u ~ U(0, 1) (B,)."""
    v0 = _normal(generator, x)
    like = x.new_empty((x.shape[0],) + tuple(x.shape[2:]) + (2,),
                       dtype=torch.float32)
    chis = []
    for _ in range(n_chi):
        re, im = _normal(generator, like), _normal(generator, like)
        chis.append(torch.complex(re, im) * math.sqrt(0.5))
    u = _uniform(generator, x[:, 0, 0, 0])
    return (v0, *chis, u)


def _accept(dh, u, new, old):
    exp_mdh = torch.exp(-dh)
    acc = u < exp_mdh
    accb = acc[:, None, None, None]
    return exp_mdh, acc, [torch.where(accb, n, o) for n, o in zip(new, old)]


def _log(cg_log, kind, res):
    if cg_log is not None:
        cg_log.add(kind, res)


@torch.no_grad()
def _hmc_step_dyn(x, q_old, cfg: SchwingerConfig, draws, cg_log=None):
    """hmc_step_dyn on the caller's draws (v0, chi, u): single scale, or
    nested with n_inner > 0 (the fermion force a solve and
    ``fermion.pf_force_at``, no gauge term; the gauge force K1 alone)."""
    v0, chi, u = draws
    phi, s_pf0 = fermion.pf_refresh_from(chi, x, cfg.mass, cfg.eo_precond)
    kw = _solve_kw(cfg)

    def guess_of(x_guess):
        return x_guess if cfg.warm_start else torch.zeros_like(phi)

    def force_fn(xx, x_guess):
        f, res = dyn_force(xx, phi, cfg.beta, cfg.mass, guess_of(x_guess),
                           cfg.cg_tol_force, **kw)
        _log(cg_log, "force", res)
        return f, res.x

    def fermion_fn(xx, x_guess):
        res = fermion.cg_solve(xx, phi, cfg.mass, guess_of(x_guess),
                               tol=cfg.cg_tol_force, **kw)
        _log(cg_log, "force", res)
        return fermion.pf_force_at(xx, phi, res.x, cfg.mass,
                                   cfg.eo_precond), res.x

    # as in the JAX package, this step does not read hasenbusch_dm
    x1, v1, x_sol = _integrate(
        dataclasses.replace(cfg, hasenbusch_dm=0.0), x, v0,
        torch.zeros_like(phi), dyn=force_fn, fermion=fermion_fn,
        gauge=lambda xx: lattice.batch_force(xx, cfg.beta))
    x1 = lattice.wrap(x1)
    s_pf1, res = fermion.pf_action_exact(
        x1, phi, cfg.mass, tol=cfg.cg_tol_mh,
        x0=x_sol if cfg.warm_start else None, **kw)
    _log(cg_log, "mh", res)
    dh = (lattice.delta_action(x1, x, cfg.beta) + (s_pf1 - s_pf0)
          + _kinetic_delta(v1, v0))
    exp_mdh, acc, (x_new,) = _accept(dh, u, (x1,), (x,))
    m = _metrics(dh, exp_mdh, acc, x_new, q_old)
    return x_new, m.q, m


@torch.no_grad()
def _hb_step_dyn(x, q_old, cfg: SchwingerConfig, draws, cg_log=None):
    """hb_step_dyn on the caller's draws (v0, chi1, chi2, u): the Hasenbusch
    heatbath at m1 = mass + hasenbusch_dm (one heavy solve), the 3-level
    nested Omelyan (ratio kicks: a light solve of W^dag phi2 and the
    autograd ratio force; heavy kicks: a heavy solve and pf_force_at at
    m1; gauge: K1), each force warm-started from its own slot of (x1g,
    yg), the end solves seeded from them."""
    v0, chi1, chi2, u = draws
    m1 = cfg.mass + cfg.hasenbusch_dm
    kw = _solve_kw(cfg)
    eo = cfg.eo_precond
    phi1, phi2, s_f0, res = fermion.hasenbusch_refresh_from(
        chi1, chi2, x, cfg.mass, m1, tol=cfg.cg_tol_mh, **kw)
    _log(cg_log, "refresh", res)

    def heavy_force(xx, aux):
        x1g, yg = aux
        guess = x1g if cfg.warm_start else torch.zeros_like(phi1)
        res = fermion.cg_solve(xx, phi1, m1, guess, tol=cfg.cg_tol_force,
                               **kw)
        _log(cg_log, "heavy", res)
        return fermion.pf_force_at(xx, phi1, res.x, m1, eo), (res.x, yg)

    def ratio_force(xx, aux):
        x1g, yg = aux
        guess = yg if cfg.warm_start else torch.zeros_like(phi2)
        b = (fermion.dirac_hat_dag if eo else fermion.dirac_dag)(xx, phi2,
                                                                 m1)
        res = fermion.cg_solve(xx, b, cfg.mass, guess, tol=cfg.cg_tol_force,
                               **kw)
        _log(cg_log, "ratio", res)
        return (fermion.ratio_force_at(xx, phi2, res.x, cfg.mass, m1, eo),
                (x1g, res.x))

    zero = (torch.zeros_like(phi1), torch.zeros_like(phi2))
    x1, v1, (x1g, yg) = _integrate(
        cfg, x, v0, zero, gauge=lambda xx: lattice.batch_force(xx, cfg.beta),
        heavy=heavy_force, ratio=ratio_force)
    x1 = lattice.wrap(x1)
    s1_end, res = fermion.pf_action_exact(
        x1, phi1, m1, tol=cfg.cg_tol_mh, x0=x1g if cfg.warm_start else None,
        **kw)
    _log(cg_log, "mh", res)
    s2_end, res = fermion.ratio_action_exact(
        x1, phi2, cfg.mass, m1, tol=cfg.cg_tol_mh,
        x0=yg if cfg.warm_start else None, **kw)
    _log(cg_log, "mh", res)
    dh = (lattice.delta_action(x1, x, cfg.beta) + (s1_end + s2_end - s_f0)
          + _kinetic_delta(v1, v0))
    exp_mdh, acc, (x_new,) = _accept(dh, u, (x1,), (x,))
    m = _metrics(dh, exp_mdh, acc, x_new, q_old)
    return x_new, m.q, m


def _plain_step(cfg: SchwingerConfig):
    """(step core, chi fields a trajectory draws) of cfg's plain sampler:
    Hasenbusch with hasenbusch_dm > 0, else the standard one."""
    _check(cfg)
    if cfg.hasenbusch_dm > 0:
        return _hb_step_dyn, 2
    return _hmc_step_dyn, 1


def hmc_step_dyn(generator: torch.Generator, x: torch.Tensor,
                 q_old: torch.Tensor, cfg: SchwingerConfig, device=None,
                 cg_log: fermion.CGLog | None = None):
    """One batched dynamical-fermion HMC trajectory of x (B, 2, L, L) on
    ``device`` (the card by default): single scale or nested (n_inner >
    0). Returns (x', q', metrics). As in the JAX package this step does
    not read hasenbusch_dm: ``hb_step_dyn`` is Hasenbusch's step, and
    ``run_hmc_dyn`` picks between them."""
    _check(cfg)
    device = resolve_device(device)
    x, q_old = x.to(device), q_old.to(device)
    return _hmc_step_dyn(x, q_old, cfg, _draws(generator, x), cg_log)


def hb_step_dyn(generator: torch.Generator, x: torch.Tensor,
                q_old: torch.Tensor, cfg: SchwingerConfig, device=None,
                cg_log: fermion.CGLog | None = None):
    """One batched Hasenbusch-preconditioned dynamical HMC trajectory of x
    (B, 2, L, L) on ``device`` (the card by default), the split at m1 =
    mass + cfg.hasenbusch_dm. Returns (x', q', metrics)."""
    _check(cfg)
    device = resolve_device(device)
    x, q_old = x.to(device), q_old.to(device)
    return _hb_step_dyn(x, q_old, cfg, _draws(generator, x, 2), cg_log)


def _setup(cfg, x0, generator, device):
    """(device, generator, start) of a run: the caller's generator or one
    on the device seeded with 0; x0, or a hot start from the generator."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    if x0 is None:
        x0 = lattice.hot_start(generator, cfg.n_chains, cfg.L, device=device)
    return device, generator, x0.to(device)


def run_hmc_dyn(cfg: SchwingerConfig, x0: torch.Tensor | None = None,
                generator: torch.Generator | None = None, *, device=None,
                cg_log: fermion.CGLog | None = None):
    """cfg.ntraj trajectories of dynamical HMC on ``device`` (the card by
    default), Hasenbusch's when cfg.hasenbusch_dm > 0. Returns (x,
    TrajMetrics of (ntraj, B) tensors)."""
    step, n_chi = _plain_step(cfg)
    device, generator, x = _setup(cfg, x0, generator, device)
    q = lattice.topo_charge(x)
    history = []
    for _ in range(cfg.ntraj):
        x, q, m = step(x, q, cfg, _draws(generator, x, n_chi), cg_log)
        history.append(m)
    return x, _stack(history)


def run_hmc_dyn_chunked(cfg: SchwingerConfig, *, block: int = 256,
                        x0: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        callback=None, device=None,
                        cg_log: fermion.CGLog | None = None):
    """run_hmc_dyn in blocks of ``block`` trajectories, one generator
    throughout, histories on the host, ``callback(done, block_history)``
    after each block. Returns (x, TrajMetrics of CPU tensors)."""
    device, generator, x = _setup(cfg, x0, generator, device)

    def run(n, x):
        return run_hmc_dyn(dataclasses.replace(cfg, ntraj=n), x0=x,
                           generator=generator, device=device, cg_log=cg_log)

    return run_blocks(run, cfg.ntraj, block, x, callback)


# ------------------------------------------------------------------ FT-HMC

def ft_dyn_force(params, spec: FlowSpec, z, cfg: SchwingerConfig, phi,
                 x_guess, remat: bool = False, backend: str = "kernel"):
    """dS_eff/dz of the dynamical theory: one pull-back through the flow
    carries the gauge and the fermion force; the CG runs on the detached
    physical field. backend 'kernel': K7, then K1 + the fermion force at y,
    then K8 with gl = -1 (their twins on the CPU); 'autograd': autograd
    through the flow. Returns (force_z, CGResult)."""
    kw = _solve_kw(cfg)
    if backend == "kernel":
        solved = []

        def cotangent(y):
            res = fermion.cg_solve(y, phi, cfg.mass, x_guess,
                                   tol=cfg.cg_tol_force, **kw)
            solved.append(res)
            return (lattice.batch_force(y, cfg.beta)
                    + fermion.pf_force_at(y, phi, res.x, cfg.mass,
                                          cfg.eo_precond))

        return flow_vjp_kernel(params, spec, z, cotangent), solved[0]
    with torch.enable_grad(), full_fp32():
        zz = z.detach().requires_grad_(True)
        y, logj = flow_forward(params, zz, spec, remat=remat)
        res = fermion.cg_solve(y.detach(), phi, cfg.mass, x_guess,
                               tol=cfg.cg_tol_force, **kw)
        s = (lattice.batch_action(y, cfg.beta)
             + fermion.pf_action_lin(y, phi, res.x, cfg.mass, cfg.eo_precond)
             - logj)
        (g,) = torch.autograd.grad(s.sum(), zz)
    return g, res


def ft_gauge_force(params, spec: FlowSpec, z, beta: float,
                   remat: bool = False, backend: str = "kernel"):
    """Latent force of the gauge part of S_eff alone, d/dz [S_gauge(f(z)) -
    log|det df/dz|]: one pull-back, no solve (the fine scale of the nested
    FT integrator). backend 'kernel': K7, K1 at y, K8 with gl = -1 (the
    quenched ``ft_force_kernel``; twins on the CPU); 'autograd': autograd
    through the flow."""
    if backend == "kernel":
        return ft_force_kernel(params, spec, z, beta)
    return _autograd_force(params, spec, z, beta, remat)


def ft_fermion_force(params, spec: FlowSpec, z, cfg: SchwingerConfig, phi,
                     x_guess, remat: bool = False, backend: str = "kernel"):
    """Latent force of the pseudofermion part of S_eff alone: the solve on
    the detached physical field, its force pulled back through the flow
    with a log-det cotangent of 0 (the log-det lives on the fine scale with
    the gauge part). backend 'kernel': K7, then the fermion force at y,
    then K8 with gl = 0; 'autograd': autograd through the flow. Returns
    (force_z, CGResult)."""
    kw = _solve_kw(cfg)
    if backend == "kernel":
        solved = []

        def cotangent(y):
            res = fermion.cg_solve(y, phi, cfg.mass, x_guess,
                                   tol=cfg.cg_tol_force, **kw)
            solved.append(res)
            return fermion.pf_force_at(y, phi, res.x, cfg.mass,
                                       cfg.eo_precond)

        return flow_vjp_kernel(params, spec, z, cotangent,
                               logdet_cotangent=0.0), solved[0]
    with torch.enable_grad(), full_fp32():
        zz = z.detach().requires_grad_(True)
        y, _ = flow_forward(params, zz, spec, remat=remat)
        res = fermion.cg_solve(y.detach(), phi, cfg.mass, x_guess,
                               tol=cfg.cg_tol_force, **kw)
        s = fermion.pf_action_lin(y, phi, res.x, cfg.mass, cfg.eo_precond)
        (g,) = torch.autograd.grad(s.sum(), zz)
    return g, res


@torch.no_grad()
def _fthmc_step_dyn(params, spec, z, q_old, cfg, draws, remat, backend,
                    flow, cg_log=None):
    """fthmc_step_dyn on a resolved force backend and the caller's draws:
    single scale, or nested with n_inner > 0 (``ft_fermion_force`` outside
    and ``ft_gauge_force`` inside). Its phases are the spans of
    ``hmc._fthmc_step`` after the draw: ``fthmc.step.energy`` (the flow of
    z and the heatbath on it; after the trajectory the flow of z1, the
    Metropolis solve and dH), ``.integrate``, ``.accept`` and
    ``.observe``."""
    v0, chi, u = draws
    with span("fthmc.step.energy"):
        y0, logdet0 = flow(z)
        phi, s_pf0 = fermion.pf_refresh_from(chi, y0, cfg.mass,
                                             cfg.eo_precond)

    def guess_of(x_guess):
        return x_guess if cfg.warm_start else torch.zeros_like(phi)

    def force_fn(zz, x_guess):
        f, res = ft_dyn_force(params, spec, zz, cfg, phi, guess_of(x_guess),
                              remat, backend)
        _log(cg_log, "force", res)
        return f, res.x

    def fermion_fn(zz, x_guess):
        f, res = ft_fermion_force(params, spec, zz, cfg, phi,
                                  guess_of(x_guess), remat, backend)
        _log(cg_log, "force", res)
        return f, res.x

    with span("fthmc.step.integrate"):
        z1, v1, x_sol = _integrate(
            cfg, z, v0, torch.zeros_like(phi), dyn=force_fn,
            fermion=fermion_fn,
            gauge=lambda zz: ft_gauge_force(params, spec, zz, cfg.beta,
                                            remat, backend))
    with span("fthmc.step.energy"):
        z1 = lattice.wrap(z1)
        y1, logdet1 = flow(z1)
        s_pf1, res = fermion.pf_action_exact(
            y1, phi, cfg.mass, tol=cfg.cg_tol_mh,
            x0=x_sol if cfg.warm_start else None, **_solve_kw(cfg))
        _log(cg_log, "mh", res)
        dh = (lattice.delta_action(y1, y0, cfg.beta) + (s_pf1 - s_pf0)
              - (logdet1 - logdet0) + _kinetic_delta(v1, v0))
    with span("fthmc.step.accept"):
        exp_mdh, acc, (z_new, y_new) = _accept(dh, u, (z1, y1), (z, y0))
    with span("fthmc.step.observe"):
        m = _metrics(dh, exp_mdh, acc, y_new, q_old)
    return z_new, y_new, m.q, m


def _fthmc_traj_dyn(params, spec, generator, z, q_old, cfg, remat, backend,
                    flow, cg_log=None):
    """One trajectory of ``_fthmc_step_dyn`` on draws from ``generator``:
    the span ``fthmc.step``, its first phase ``fthmc.step.momenta`` (v0,
    chi and u drawn)."""
    with span("fthmc.step"):
        with span("fthmc.step.momenta"):
            draws = _draws(generator, z)
        return _fthmc_step_dyn(params, spec, z, q_old, cfg, draws, remat,
                               backend, flow, cg_log)


def _ft_setup(params, spec, cfg, z, remat, force_backend, device):
    """(z on the device, remat, force backend, energy flow) of an FT run;
    refuses what JAX refuses and what is not ported."""
    if cfg.hasenbusch_dm > 0:
        raise ValueError("hasenbusch_dm is implemented for plain dynamical "
                         "HMC only (hb_step_dyn); unset it for FT-HMC")
    _check(cfg)
    z = _on_device(device, z, params)
    remat = resolve_remat(remat, z.shape)
    backend = resolve_force_backend(force_backend, spec, z.shape, z.dtype,
                                    device)
    flow, _ = _flow_and_force(params, spec, cfg.beta, remat, backend)
    return z, remat, backend, flow


def fthmc_step_dyn(params, spec: FlowSpec, generator: torch.Generator,
                   z: torch.Tensor, q_old: torch.Tensor,
                   cfg: SchwingerConfig, remat="auto",
                   force_backend: str = "auto", device=None,
                   cg_log: fermion.CGLog | None = None):
    """One batched dynamical FT-HMC trajectory in latent space z (B, 2, L,
    L) on ``device`` (the card by default); the heatbath is on the physical
    field y = f(z). Returns (z', y', q', metrics)."""
    device = resolve_device(device)
    z, remat, backend, flow = _ft_setup(params, spec, cfg, z, remat,
                                        force_backend, device)
    return _fthmc_traj_dyn(params, spec, generator, z, q_old.to(device),
                           cfg, remat, backend, flow, cg_log)


def run_fthmc_dyn(params, spec: FlowSpec, cfg: SchwingerConfig, *,
                  z0: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, remat="auto",
                  force_backend: str = "auto", device=None,
                  cg_log: fermion.CGLog | None = None):
    """cfg.ntraj dynamical FT-HMC trajectories from latent z0 (a hot start
    from the generator if None) on ``device`` (the card by default).
    Returns (z, TrajMetrics of (ntraj, B) tensors)."""
    device, generator, z = _setup(cfg, z0, generator, device)
    z, remat, backend, flow = _ft_setup(params, spec, cfg, z, remat,
                                        force_backend, device)
    with torch.no_grad():
        q = lattice.topo_charge(flow(z)[0])
    history = []
    for _ in range(cfg.ntraj):
        z, _, q, m = _fthmc_traj_dyn(params, spec, generator, z, q, cfg,
                                     remat, backend, flow, cg_log)
        history.append(m)
    return z, _stack(history)


def run_fthmc_dyn_chunked(params, spec: FlowSpec, cfg: SchwingerConfig, *,
                          block: int = 128, z0: torch.Tensor | None = None,
                          generator: torch.Generator | None = None,
                          callback=None, remat="auto",
                          force_backend: str = "auto", device=None,
                          cg_log: fermion.CGLog | None = None):
    """run_fthmc_dyn in blocks of ``block`` trajectories (see
    run_hmc_dyn_chunked). Returns (z, TrajMetrics of CPU tensors)."""
    device, generator, z = _setup(cfg, z0, generator, device)

    def run(n, z):
        return run_fthmc_dyn(params, spec, dataclasses.replace(cfg, ntraj=n),
                             z0=z, generator=generator, remat=remat,
                             force_backend=force_backend, device=device,
                             cg_log=cg_log)

    return run_blocks(run, cfg.ntraj, block, z, callback)
