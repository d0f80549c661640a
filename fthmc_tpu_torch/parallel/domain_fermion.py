"""Domain-decomposed dynamical Wilson fermions: the row-sharded Dirac
operator, conjugate-gradient solver and the two-flavour Schwinger-model
HMC and FT-HMC steps.

Counterpart of ``fthmc_tpu/parallel/domain_fermion.py``. Fields are
row-sharded: gauge theta (B, 2, L0 / size, L1), spinors psi (B, L0 / size,
L1, 2) complex64.

- The Wilson hop is nearest-neighbour: one exchange a hop
  (``domain._RingFetch``) carries both of its halo rows, complex planes as
  (re, im) pairs (``torch.view_as_real``).
- The antiperiodic time boundary and the even-odd parity masks are global:
  both are rebuilt on each rank from its row offset.
- The CG (``cg_solve_sharded``) is a host loop: every dot product is
  all-reduced, and its stop test reads the all-reduced |r|^2, so every
  rank makes the same number of iterations (a rank-local test would
  deadlock the next collective). That is one host read an iteration,
  counted in ``CGResult.reads``.
- The fermion force is torch.autograd of the rank's LOCAL contribution to
  the variational action (``fermion.pf_action_lin``), as in domain_flow:
  the exchanges' backward carries the cross-rank terms.
- The solver is the torch stencil, not the fused CG kernel (K11), as the
  JAX module runs the XLA stencil and not its fused kernels.
- Draws: momenta and pseudofermion noise from the rank generator, the
  accept uniforms from the shared generator.

Multi-timescale (n_inner) and Hasenbusch are not sharded (the JAX module's
refusal, ``_check_cfg``), nor is eo with an odd number of rows a rank.
"""
from __future__ import annotations

import math

import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.fermion import CGResult, _cdot, _cg_loop, _g5
from fthmc_tpu_torch.hmc import _stack
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.parallel.domain import (_accept_metrics, _fetch,
                                             _kinetic_delta_sharded, _psum,
                                             _run_blocks, delta_action_sharded,
                                             force_sharded,
                                             plaq_phase_sharded, shard_rows,
                                             topo_charge_sharded)
from fthmc_tpu_torch.parallel.domain_flow import (_check_spec,
                                                  flow_forward_sharded)
from fthmc_tpu_torch.parallel.mesh import Mesh, rank_generator
from fthmc_tpu_torch.schwinger import (SchwingerConfig, _setup,
                                       leapfrog_aux, omelyan_aux)

__all__ = ["dirac_sharded", "dirac_dag_sharded", "apply_mdagm_sharded",
           "apply_mdagm_eo_sharded", "parity_mask_sharded",
           "dirac_hat_sharded", "dirac_hat_dag_sharded", "cg_solve_sharded",
           "pf_refresh_sharded", "pf_refresh_sharded_from",
           "pf_action_exact_sharded", "pf_action_lin_sharded",
           "dyn_force_sharded", "make_domain_hmc_dyn_step",
           "run_domain_hmc_dyn_chunked", "ft_dyn_force_sharded",
           "run_domain_fthmc_dyn_chunked"]


def _row_halos(mesh: Mesh, first: torch.Tensor, last: torch.Tensor):
    """Complex planes' halo rows in one exchange, as (re, im) pairs: (the
    next rank's first row of ``first``, the previous rank's last row of
    ``last``)."""
    a, b = _fetch(mesh, (torch.view_as_real(first[..., :1, :]), 1),
                  (torch.view_as_real(last[..., -1:, :]), -1))
    return torch.view_as_complex(a), torch.view_as_complex(b)


def _global_rows(theta: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    ls = theta.shape[-2]
    return mesh.rank * ls + torch.arange(ls, device=theta.device)


def _links_sharded(theta: torch.Tensor, mesh: Mesh):
    """Effective complex links with the global antiperiodic time boundary:
    the -1 sign on the global last row, on the last rank only (cf.
    fermion._links)."""
    u = torch.exp(1j * theta.to(torch.float32))
    u0, u1 = u[..., 0, :, :], u[..., 1, :, :]
    grow = _global_rows(theta, mesh)
    sign = torch.where(grow == mesh.size * theta.shape[-2] - 1, -1.0, 1.0)
    return u0 * sign.to(torch.float32)[:, None], u1


def _hop_sharded(theta, psi, mesh: Mesh) -> torch.Tensor:
    """The half-spinor Wilson hop (fermion._hop) with the row rolls
    crossing ranks (one exchange); the column rolls stay local."""
    u0, u1 = _links_sharded(theta, mesh)
    s0, s1 = psi[..., 0], psi[..., 1]
    dm = s0 - s1
    ep = u0.conj() * (s0 + s1)
    from_next, from_prev = _row_halos(mesh, dm, ep)
    d = u0 * torch.cat([dm[..., 1:, :], from_next], dim=-2)
    e = torch.cat([from_prev, ep[..., :-1, :]], dim=-2)
    w = u1 * torch.roll(s0 + 1j * s1, -1, dims=-1)
    v = torch.roll(u1.conj() * (s0 - 1j * s1), 1, dims=-1)
    h0 = d + e + w + v
    h1 = -d + e - 1j * w + 1j * v
    return torch.stack((h0, h1), dim=-1)


def dirac_sharded(theta, psi, mass: float, mesh: Mesh) -> torch.Tensor:
    """Row-sharded D(theta) psi (fermion.dirac)."""
    return (mass + 2.0) * psi - 0.5 * _hop_sharded(theta, psi, mesh)


def dirac_dag_sharded(theta, psi, mass: float, mesh: Mesh):
    """D^dag = g5 D g5 (g5 is site-local)."""
    return _g5(dirac_sharded(theta, _g5(psi), mass, mesh))


def apply_mdagm_sharded(theta, psi, mass: float, mesh: Mesh):
    """M = D^dag D on row-sharded fields."""
    return dirac_dag_sharded(theta, dirac_sharded(theta, psi, mass, mesh),
                             mass, mesh)


def parity_mask_sharded(shape_local, mesh: Mesh, parity: int = 0,
                        device=None) -> torch.Tensor:
    """(L0loc, L1, 1) fp32 mask of global parity (x0_global + x1) % 2 ==
    parity for a spinor of local shape (..., L0loc, L1, 2) on ``device``
    (the mesh's by default)."""
    ls, L1 = shape_local[-3], shape_local[-2]
    dev = mesh.device if device is None else device
    grow = mesh.rank * ls + torch.arange(ls, device=dev)
    p = (grow[:, None] + torch.arange(L1, device=dev)[None, :]) % 2
    return (p == parity).to(torch.float32)[..., None]


def dirac_hat_sharded(theta, psi_e, mass: float, mesh: Mesh):
    """The even-odd Schur complement Dhat on even-masked sharded fields
    (fermion.dirac_hat with the global parity)."""
    me = parity_mask_sharded(psi_e.shape, mesh, 0, psi_e.device)
    mo = 1.0 - me
    h = me * _hop_sharded(theta, mo * _hop_sharded(theta, psi_e, mesh),
                          mesh)
    return (mass + 2.0) * psi_e - 0.25 / (mass + 2.0) * h


def dirac_hat_dag_sharded(theta, psi_e, mass: float, mesh: Mesh):
    return _g5(dirac_hat_sharded(theta, _g5(psi_e), mass, mesh))


def apply_mdagm_eo_sharded(theta, psi_e, mass: float, mesh: Mesh):
    return dirac_hat_dag_sharded(
        theta, dirac_hat_sharded(theta, psi_e, mass, mesh), mass, mesh)


def _cdot_g(a, b, mesh: Mesh) -> torch.Tensor:
    """The global per-chain inner product: the local one, all-reduced."""
    return _psum(mesh, _cdot(a, b))


@torch.no_grad()
def cg_solve_sharded(theta, b, mass: float, x0=None, *, tol: float = 1e-8,
                     maxiter: int = 1000, eo: bool = False,
                     mesh: Mesh) -> CGResult:
    """Batched CG for (D^dag D) x = b on row-sharded fields: fermion's CG
    loop with the sharded operator and all-reduced dot products. The host
    loop stops on the all-reduced |r|^2 (alike on every rank): one host
    read an iteration and one, in ``reads``."""
    theta = theta.detach()
    apply = apply_mdagm_eo_sharded if eo else apply_mdagm_sharded
    return _cg_loop(lambda p: apply(theta, p, mass, mesh), b, x0, tol,
                    maxiter, lambda u, v: _cdot_g(u, v, mesh))


def pf_refresh_sharded_from(chi, theta, mass: float, *, eo: bool = False,
                            mesh: Mesh):
    """phi = D^dag chi (eo: chi even-masked, phi = Dhat^dag chi) on this
    rank's rows and the global start action chi^dag chi (B,). chi: this
    rank's noise rows (..., L0loc, L1, 2), CN(0, 1)."""
    theta = theta.detach()
    chi = chi.to(torch.complex64)
    with torch.no_grad():
        if eo:
            chi = chi * parity_mask_sharded(chi.shape, mesh, 0, chi.device)
            phi = dirac_hat_dag_sharded(theta, chi, mass, mesh)
        else:
            phi = dirac_dag_sharded(theta, chi, mass, mesh)
        return phi, _cdot_g(chi, chi, mesh).real


def _noise(generator: torch.Generator, theta: torch.Tensor) -> torch.Tensor:
    """CN(0, 1) spinor noise of theta's local rows: its real parts, then
    its imaginary parts, from ``generator`` (fermion.pf_refresh's order)."""
    shape = theta.shape[:-3] + theta.shape[-2:] + (2,)
    re = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
    im = torch.randn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
    return (torch.complex(re, im) * math.sqrt(0.5)).to(theta.device)


def pf_refresh_sharded(generator: torch.Generator, theta, mass: float, *,
                       eo: bool = False, mesh: Mesh):
    """The pseudofermion heatbath on row-sharded fields: noise rows from
    ``generator``, which is this rank's own (``rank_generator(g,
    mesh.rank)``: independent rows on every rank, JAX's fold_in of the
    shard index). Returns (phi, s0)."""
    return pf_refresh_sharded_from(_noise(generator, theta), theta, mass,
                                   eo=eo, mesh=mesh)


def _pf_action_lin_local(theta, phi, x_sol, mass: float, eo: bool,
                         mesh: Mesh) -> torch.Tensor:
    """This rank's contribution (no all-reduce) to the variational action
    fermion.pf_action_lin: the differentiation target of the force."""
    op = apply_mdagm_eo_sharded if eo else apply_mdagm_sharded
    xs = x_sol.detach()
    return (2.0 * _cdot(xs, phi).real
            - _cdot(xs, op(theta, xs, mass, mesh)).real)


def pf_action_lin_sharded(theta, phi, x_sol, mass: float, *,
                          eo: bool = False, mesh: Mesh) -> torch.Tensor:
    """The global variational pseudofermion action per chain."""
    with torch.no_grad():
        return _psum(mesh, _pf_action_lin_local(theta, phi, x_sol, mass, eo,
                                                mesh))


def pf_action_exact_sharded(theta, phi, mass: float, *, tol: float = 1e-10,
                            maxiter: int = 2000, x0=None, eo: bool = False,
                            mesh: Mesh):
    """S_pf = phi^dag M^{-1} phi from a tight sharded solve (the Metropolis
    energy). Returns (s, CGResult), as fermion.pf_action_exact."""
    res = cg_solve_sharded(theta, phi, mass, x0, tol=tol, maxiter=maxiter,
                           eo=eo, mesh=mesh)
    return _cdot_g(phi, res.x, mesh).real, res


def _pf_force_local(theta, phi, x_sol, mass, eo, mesh: Mesh):
    """d/dtheta of this rank's pf_action_lin contribution (autograd)."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            _pf_action_lin_local(th, phi, x_sol, mass, eo, mesh).sum(), th)
    return g


def dyn_force_sharded(x, phi, beta: float, mass: float, x_guess, *,
                      tol: float = 1e-8, maxiter: int = 1000,
                      eo: bool = False, mesh: Mesh):
    """The total dynamical force on the row-sharded field: the analytic
    gauge stencil (domain.force_sharded) + the gradient of this rank's
    fermion action contribution. Returns (force, CGResult)."""
    res = cg_solve_sharded(x, phi, mass, x_guess, tol=tol, maxiter=maxiter,
                           eo=eo, mesh=mesh)
    with torch.no_grad():
        f = force_sharded(x, beta, mesh)
    return f + _pf_force_local(x, phi, res.x, mass, eo, mesh), res


# ------------------------------------------------------------- HMC kernel

def _check_cfg(cfg: SchwingerConfig, n_dev: int) -> None:
    if cfg.n_inner > 0 or cfg.hasenbusch_dm > 0:
        raise ValueError("domain-decomposed dynamical HMC is single-scale "
                         "(MTS/Hasenbusch not sharded; see module docs)")
    if cfg.L % n_dev:
        raise ValueError(f"L={cfg.L} rows do not split over {n_dev} ranks")
    if (cfg.L // n_dev) % 2 != 0 and cfg.eo_precond:
        raise ValueError("eo preconditioning needs an even number of rows "
                         f"per shard (L={cfg.L}, devices={n_dev})")
    if cfg.integrator not in ("leapfrog", "omelyan"):
        raise ValueError(f"unknown integrator {cfg.integrator!r}")


def _log(cg_log, kind, res):
    if cg_log is not None:
        cg_log.add(kind, res)


def _dyn_draws(generator: torch.Generator, mesh: Mesh, x: torch.Tensor):
    """(v0, chi) of this rank's rows from its rank generator, then the
    accept uniforms u (B,) from the shared ``generator``."""
    rg = rank_generator(generator, mesh.rank)
    v0 = torch.randn(x.shape, generator=rg, dtype=x.dtype,
                     device=rg.device).to(x.device)
    chi = _noise(rg, x)
    u = torch.rand((x.shape[0],), generator=generator, dtype=x.dtype,
                   device=generator.device).to(x.device)
    return v0, chi, u


@torch.no_grad()
def _domain_hmc_dyn_step_from(x, q_old, cfg: SchwingerConfig, draws,
                              mesh: Mesh, cg_log=None):
    """One dynamical HMC trajectory of the row-sharded field on the given
    draws (this rank's v0 and chi, the shared u); mirrors
    schwinger.hmc_step_dyn. Returns (x', q', TrajMetrics of global (B,)
    tensors)."""
    v0, chi, u = draws
    phi, s_pf0 = pf_refresh_sharded_from(chi, x, cfg.mass,
                                         eo=cfg.eo_precond, mesh=mesh)

    def force_fn(xx, x_guess):
        guess = x_guess if cfg.warm_start else torch.zeros_like(phi)
        f, res = dyn_force_sharded(xx, phi, cfg.beta, cfg.mass, guess,
                                   tol=cfg.cg_tol_force,
                                   maxiter=cfg.cg_maxiter,
                                   eo=cfg.eo_precond, mesh=mesh)
        _log(cg_log, "force", res)
        return f, res.x

    integ = omelyan_aux if cfg.integrator == "omelyan" else leapfrog_aux
    x1, v1, x_sol = integ(x, v0, cfg.dt, cfg.nstep, force_fn,
                          torch.zeros_like(phi))
    x1 = lattice.wrap(x1)
    s_pf1, res = pf_action_exact_sharded(
        x1, phi, cfg.mass, tol=cfg.cg_tol_mh, maxiter=cfg.cg_maxiter,
        x0=x_sol if cfg.warm_start else None, eo=cfg.eo_precond, mesh=mesh)
    _log(cg_log, "mh", res)
    dh = (delta_action_sharded(x1, x, cfg.beta, mesh) + (s_pf1 - s_pf0)
          + _kinetic_delta_sharded(v1, v0, mesh))
    (x_new,), q, m = _accept_metrics(dh, u, (x1,), (x,), lambda c: c[0],
                                     q_old, mesh)
    return x_new, q, m


def make_domain_hmc_dyn_step(mesh: Mesh, cfg: SchwingerConfig,
                             cg_log=None):
    """One row-sharded dynamical HMC step: step(generator, x, q_old) ->
    (x', q', TrajMetrics), x this rank's rows, ``generator`` the shared
    one."""
    _check_cfg(cfg, mesh.size)

    def step(generator, x, q_old):
        return _domain_hmc_dyn_step_from(x, q_old, cfg,
                                         _dyn_draws(generator, mesh, x),
                                         mesh, cg_log)

    return step


def _dyn_blocks(mesh: Mesh, step_from, x, q, generator, ntraj: int,
                block: int, callback):
    """Blocks of trajectories of ``step_from(x, q, draws)`` (see
    domain._run_blocks)."""

    def run(n, s):
        x, q = s
        history = []
        for _ in range(n):
            x, q, m = step_from(x, q, _dyn_draws(generator, mesh, x))
            history.append(m)
        return (x, q), _stack(history)

    (x, _), hist = _run_blocks(run, ntraj, block, (x, q), callback)
    return x, hist


def _dyn_setup(mesh: Mesh, cfg: SchwingerConfig, x0, generator):
    """(the shared generator, this rank's rows of the start): x0 global, by
    default run_hmc_dyn's start (a hot start from ``generator``, seeded
    with 0 on every rank when None)."""
    _check_cfg(cfg, mesh.size)
    _, generator, x0 = _setup(cfg, x0, generator, mesh.device)
    return generator, shard_rows(mesh, x0)


def run_domain_hmc_dyn_chunked(mesh: Mesh, cfg: SchwingerConfig, *,
                               block: int = 64, x0=None, generator=None,
                               callback=None, cg_log=None):
    """Blocked row-sharded dynamical HMC (cfg a SchwingerConfig), cfg.ntraj
    trajectories. Returns (this rank's rows of the final field, history
    dict of CPU (ntraj, B) tensors)."""
    generator, x = _dyn_setup(mesh, cfg, x0, generator)

    def step_from(x, q, draws):
        return _domain_hmc_dyn_step_from(x, q, cfg, draws, mesh, cg_log)

    return _dyn_blocks(mesh, step_from, x, topo_charge_sharded(x, mesh),
                       generator, cfg.ntraj, block, callback)


# ------------------------------------------------------------------ FT-HMC

def ft_dyn_force_sharded(params, spec: FlowSpec, z, cfg: SchwingerConfig,
                         phi, x_guess, L0: int, mesh: Mesh,
                         remat: bool = True):
    """dS_eff/dz of the row-sharded dynamical theory: one backward through
    the sharded flow carries the gauge stencil, log-det and fermion terms
    to latent space (schwinger.ft_dyn_force with domain_flow), the target
    this rank's LOCAL contribution; the solve runs on the detached
    physical field. Returns (force_z, CGResult)."""
    with torch.enable_grad(), full_fp32():
        zz = z.detach().requires_grad_(True)
        y, logdet_local = flow_forward_sharded(params, zz, spec, L0, mesh,
                                               remat=remat, reduce=False)
        res = cg_solve_sharded(y.detach(), phi, cfg.mass, x_guess,
                               tol=cfg.cg_tol_force, maxiter=cfg.cg_maxiter,
                               eo=cfg.eo_precond, mesh=mesh)
        sg = -cfg.beta * torch.cos(plaq_phase_sharded(y, mesh)).sum(
            dim=(1, 2))
        sf = _pf_action_lin_local(y, phi, res.x, cfg.mass, cfg.eo_precond,
                                  mesh)
        (g,) = torch.autograd.grad((sg + sf - logdet_local).sum(), zz)
    return g, res


@torch.no_grad()
def _domain_fthmc_dyn_step_from(params, z, q_old, cfg: SchwingerConfig,
                                spec: FlowSpec, L0: int, draws, mesh: Mesh,
                                remat: bool = True, cg_log=None):
    """One row-sharded dynamical FT-HMC trajectory on the given draws;
    mirrors schwinger.fthmc_step_dyn (the heatbath on the physical field y
    = f(z))."""
    v0, chi, u = draws
    y0, logdet0 = flow_forward_sharded(params, z, spec, L0, mesh, remat)
    phi, s_pf0 = pf_refresh_sharded_from(chi, y0, cfg.mass,
                                         eo=cfg.eo_precond, mesh=mesh)

    def force_fn(zz, x_guess):
        guess = x_guess if cfg.warm_start else torch.zeros_like(phi)
        f, res = ft_dyn_force_sharded(params, spec, zz, cfg, phi, guess, L0,
                                      mesh, remat)
        _log(cg_log, "force", res)
        return f, res.x

    integ = omelyan_aux if cfg.integrator == "omelyan" else leapfrog_aux
    z1, v1, x_sol = integ(z, v0, cfg.dt, cfg.nstep, force_fn,
                          torch.zeros_like(phi))
    z1 = lattice.wrap(z1)
    y1, logdet1 = flow_forward_sharded(params, z1, spec, L0, mesh, remat)
    s_pf1, res = pf_action_exact_sharded(
        y1, phi, cfg.mass, tol=cfg.cg_tol_mh, maxiter=cfg.cg_maxiter,
        x0=x_sol if cfg.warm_start else None, eo=cfg.eo_precond, mesh=mesh)
    _log(cg_log, "mh", res)
    dsw = -cfg.beta * _psum(mesh, (torch.cos(plaq_phase_sharded(y1, mesh))
                                   - torch.cos(plaq_phase_sharded(y0, mesh))
                                   ).sum(dim=(1, 2)))
    dh = (dsw + (s_pf1 - s_pf0) - (logdet1 - logdet0)
          + _kinetic_delta_sharded(v1, v0, mesh))
    (z_new, y_new), q, m = _accept_metrics(dh, u, (z1, y1), (z, y0),
                                           lambda c: c[1], q_old, mesh)
    return z_new, q, m


def run_domain_fthmc_dyn_chunked(mesh: Mesh, params, spec: FlowSpec,
                                 cfg: SchwingerConfig, *, block: int = 32,
                                 z0=None, generator=None, callback=None,
                                 remat: bool = True, cg_log=None):
    """Blocked row-sharded dynamical FT-HMC: the latent chain state
    row-sharded, the flow parameters alike on every rank. Returns (this
    rank's rows of the final latents, history dict of CPU (ntraj, B)
    tensors)."""
    _check_spec(spec)
    generator, z = _dyn_setup(mesh, cfg, z0, generator)
    with torch.no_grad():
        y0, _ = flow_forward_sharded(params, z, spec, cfg.L, mesh, remat)

    def step_from(z, q, draws):
        return _domain_fthmc_dyn_step_from(params, z, q, cfg, spec, cfg.L,
                                           draws, mesh, remat, cg_log)

    return _dyn_blocks(mesh, step_from, z, topo_charge_sharded(y0, mesh),
                       generator, cfg.ntraj, block, callback)
