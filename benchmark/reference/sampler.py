"""Plain HMC and FT-HMC trajectories, replayed from given starts and
generator states, in plain torch: the reference that the program's
trajectories are compared with.

Each trajectory takes its random numbers from the generator in the order
the sampler under test takes them (``Replayed.draws``), so that the same
generator state gives both sides the same draws. The arithmetic runs in
the dtype of the start handed in (float64 for the reference; a lower
precision for the control).

Plain HMC: leapfrog (half drift, nstep kicks and drifts, half drift
undone) with the Wilson force. FT-HMC (arXiv:2112.01586): the latent field
z moves under S_eff(z) = S(f(z)) - log det df/dz by Omelyan's 2MN
integrator (lambda = 0.1931833275037836, adjacent kicks merged, so
2 nstep + 1 forces), the force by autograd through ``flow.Flow``; the
observables are measured on y = f(z). Both: dH = delta S + delta K (FT:
minus the log det difference), accept where u < exp(-dH), the plaquette
and charge of the field kept.
"""
from __future__ import annotations

import torch

from benchmark.reference import lattice as lat

OMELYAN_LAMBDA = 0.1931833275037836


def leapfrog(x, v, dt: float, nstep: int, force):
    x = x + 0.5 * dt * v
    for _ in range(nstep):
        v = v - dt * force(x)
        x = x + dt * v
    x = x - 0.5 * dt * v
    return x, v


def omelyan(x, v, dt: float, nstep: int, force):
    lam = OMELYAN_LAMBDA
    v = v - (lam * dt) * force(x)
    for i in range(nstep):
        x = x + (0.5 * dt) * v
        v = v - ((1.0 - 2.0 * lam) * dt) * force(x)
        x = x + (0.5 * dt) * v
        w = lam * dt if i == nstep - 1 else 2.0 * lam * dt
        v = v - w * force(x)
    return x, v


class Replayed:
    """What the check asks of a reference: ``replay``, one trajectory from
    each given start and generator state. By default a trajectory's draws
    are its momenta (``randn`` of the field's shape, fp32) and then its
    accept uniforms (``rand`` of (B,), fp32), as the plain and FT samplers
    under test draw them; a sampler that draws otherwise overrides
    ``draws`` (and ``trajectory``) or ``replay`` itself."""

    def draws(self, g: torch.Generator, x: torch.Tensor):
        """(v0, u) of one trajectory of x from ``g``."""
        v0 = torch.randn(x.shape, generator=g, dtype=torch.float32,
                         device=g.device)
        u = torch.rand((x.shape[0],), generator=g, dtype=torch.float32,
                       device=g.device)
        return v0, u

    @torch.no_grad()
    def replay(self, starts: list, gen_states: list, device) -> dict:
        """One trajectory from each start (B_i, 2, L, L) with draws from a
        generator on ``device`` set to the matching state, as each block's
        own draws. The starts run as one batch (chains are independent);
        their dtype is the arithmetic's. Returns per chain, over the starts
        in order, float64 CPU tensors ``dh``, ``acc``, ``plaq``, ``q``,
        ``margin`` (-dH - log u, how far the accept decision lies from its
        threshold) and the plaquette and charge of the start
        (``start_plaq``, ``start_q``)."""
        v0s, us = [], []
        for x, state in zip(starts, gen_states):
            g = torch.Generator(device)
            g.set_state(state)
            v0, u = self.draws(g, x)
            v0s.append(v0)
            us.append(u)
        x = torch.cat(starts)
        v0 = torch.cat(v0s).to(x.dtype)
        u = torch.cat(us).to(torch.float64)
        x1, dh, y1, y0 = self.trajectory(x, v0)
        dh = dh.to(torch.float64)
        acc = u < torch.exp(-dh)
        y = torch.where(acc[:, None, None, None], y1, y0)
        return {"dh": dh.cpu(), "acc": acc.to(torch.float64).cpu(),
                "plaq": lat.plaq_mean(y).double().cpu(),
                "q": lat.charge(y).double().cpu(),
                "margin": (-dh - torch.log(u)).cpu(),
                "start_plaq": lat.plaq_mean(y0).double().cpu(),
                "start_q": lat.charge(y0).double().cpu()}


class PlainHMC(Replayed):
    """Plain HMC of the Wilson action with leapfrog."""

    def __init__(self, beta: float, tau: float, nstep: int):
        self.beta, self.dt, self.nstep = beta, tau / nstep, nstep

    def trajectory(self, x, v0):
        """(x1 wrapped, dH, field observed at x1, field observed at x)."""
        x1, v1 = leapfrog(x, v0, self.dt, self.nstep,
                          lambda xx: lat.force(xx, self.beta))
        x1 = lat.wrap(x1)
        dh = lat.delta_action(x1, x, self.beta) + lat.kinetic_delta(v1, v0)
        return x1, dh, x1, x


class FlowedHMC(Replayed):
    """FT-HMC in the latent field of ``flow`` with Omelyan's integrator."""

    def __init__(self, flow, beta: float, tau: float, nstep: int):
        self.flow, self.beta = flow, beta
        self.dt, self.nstep = tau / nstep, nstep

    def force(self, z):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            y, logdet = self.flow.forward(zz)
            s_eff = lat.action(y, self.beta) - logdet
            (g,) = torch.autograd.grad(s_eff.sum(), zz)
        return g.detach()

    def trajectory(self, z, v0):
        with torch.no_grad():
            y0, ld0 = self.flow.forward(z)
        z1, v1 = omelyan(z, v0, self.dt, self.nstep, self.force)
        z1 = lat.wrap(z1)
        with torch.no_grad():
            y1, ld1 = self.flow.forward(z1)
        dh = (lat.delta_action(y1, y0, self.beta) - (ld1 - ld0)
              + lat.kinetic_delta(v1, v0))
        return z1, dh, y1, y0
