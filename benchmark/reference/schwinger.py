"""Dynamical FT-HMC of the two-flavour Schwinger model, plain torch: the
reference that the program's trajectories of a ``schwinger`` cell are
compared with.

The model, 2D U(1) with two degenerate flavours of Wilson fermions, its
fermions as pseudofermions seen through a gauge-equivariant flow
(arXiv:2207.08945) and sampled by FT-HMC (arXiv:2112.01586):

- links U_mu(x) = exp(i y_mu(x)) of the physical field y (B, 2, L0, L1),
  direction mu along axis mu; the Wilson gauge action S_g = -beta sum_P
  cos P (``lattice``);
- the Wilson-Dirac operator on spinors psi (B, L0, L1, 2),

      D psi(x) = (m + 2) psi(x) - 1/2 sum_mu [(1 - g_mu) U_mu(x) psi(x + mu)
                 + (1 + g_mu) U_mu(x - mu)^* psi(x - mu)],

  g_0 = sigma_x, g_1 = sigma_y, g_5 = sigma_z, periodic along axis 1 and
  antiperiodic along axis 0 (time);
- even-odd: with A = m + 2 on the diagonal, the Schur complement on the
  even sites Dhat = A - D_eo D_oe / A, and Dhat^dag = g_5 Dhat g_5;
  det(D^dag D) = A^V det(Dhat^dag Dhat) (V the sites), so two flavours
  are the pseudofermion action S_pf = phi^dag (Dhat^dag Dhat)^-1 phi on
  the even sites (without eo: D in place of Dhat, on every site);
- the heatbath: chi ~ CN(0, 1) on the even sites, phi = Dhat^dag chi,
  S_pf at the start chi^dag chi;
- the latent field z, y = f(z) (``flow.Flow``), S_eff(z) = S_g(y) +
  S_pf(y) - log det df/dz; the force dS_eff/dz by torch.autograd through
  the flow, S_pf in its variational form 2 Re<X, phi> - |Dhat(y) X|^2 at
  X = (Dhat^dag Dhat)^-1 phi held fixed (S_pf at X, its gradient the exact
  fermion force);
- Omelyan's 2MN integrator, position first, two forces a step (lambda =
  0.1931833275037836): z += lambda dt v, v -= dt/2 F, z += (1 - 2 lambda)
  dt v, v -= dt/2 F, z += lambda dt v;
- dH = S_g(y1) - S_g(y0) + S_pf(y1) - chi^dag chi - (log det1 - log det0)
  + (|v1|^2 - |v0|^2) / 2, accept where u < exp(-dH), the plaquette and
  charge of the accepted y kept.

Departures from that description, each as the sampler under test runs:
- the antiperiodic boundary is folded into the links U_0 of the last time
  slice (the same operator);
- z1 is wrapped to [-pi, pi) before its energies (the flow and every
  action see angles only through periodic functions of them);
- every CG runs to |r|^2 / |b|^2 <= 1e-20 in float64 (1e-12 in a lower
  precision, the control), far below the sampler's 1e-9 in the force and
  1e-12 at the Metropolis step; each starts from the last solution, which
  moves nothing but the iterations;
- the draws come from the sampler's generator in its order: v0 (float32,
  z's shape), chi's real parts, its imaginary parts ((B, L0, L1, 2)
  float32 each, chi = (re + i im) / sqrt 2, then masked to the even
  sites), u ((B,) float32).

The arithmetic runs in the dtype of the start handed in (float64 for the
reference), complex in the matching complex dtype. The flow is
``flow.Flow`` with its convs as one batched ``conv2d`` of the periodically
padded field (``BatchedFlow``: the same cross-correlation as
``flow.conv3x3``, whose ``unfold`` launches a kernel a chain on the card),
and its passes run over ``CHUNK`` chains at a time, so that the autograd
through the flow fits in the card's memory at any batch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import flow as rflow
from benchmark.reference import lattice as lat

OMELYAN_LAMBDA = 0.1931833275037836
CG_TOL = 1e-20   # float64; 1e-12 in any lower precision
CG_MAXITER = 4000
CHUNK = 1024   # chains a flow pass: its autograd memory grows with it


def links(y: torch.Tensor):
    """(U_0, U_1), each (B, L0, L1) complex, the antiperiodic time boundary
    folded into U_0 of the last time slice."""
    u = torch.polar(torch.ones_like(y), y)
    sign = torch.ones(y.shape[-2], 1, dtype=y.dtype, device=y.device)
    sign[-1] = -1.0
    return u[:, 0] * sign, u[:, 1]


def _gammas(dtype, device):
    """(1 - g_mu, 1 + g_mu) for mu = 0, 1, each (2, 2)."""
    one = torch.eye(2, dtype=dtype, device=device)
    g = [torch.tensor([[0, 1], [1, 0]], dtype=dtype, device=device),
         torch.tensor([[0, -1j], [1j, 0]], dtype=dtype, device=device)]
    return [(one - gm, one + gm) for gm in g]


def hop(u, psi: torch.Tensor) -> torch.Tensor:
    """sum_mu [(1 - g_mu) U_mu(x) psi(x + mu) + (1 + g_mu) U_mu(x - mu)^*
    psi(x - mu)] of psi (B, L0, L1, 2)."""
    out = torch.zeros_like(psi)
    for mu, (pm, pp) in enumerate(_gammas(psi.dtype, psi.device)):
        um = u[mu][..., None]
        fwd = um * torch.roll(psi, -1, dims=1 + mu)
        bwd = torch.roll(um.conj() * psi, 1, dims=1 + mu)
        out = (out + torch.einsum("st,bxyt->bxys", pm, fwd)
               + torch.einsum("st,bxyt->bxys", pp, bwd))
    return out


def even_mask(psi: torch.Tensor) -> torch.Tensor:
    """(L0, L1, 1) mask of the sites with x0 + x1 even."""
    L0, L1 = psi.shape[1:3]
    par = (torch.arange(L0, device=psi.device)[:, None]
           + torch.arange(L1, device=psi.device)[None, :]) % 2
    return (par == 0).to(psi.real.dtype)[..., None]


def dirac(u, psi: torch.Tensor, mass: float) -> torch.Tensor:
    """D psi."""
    return (mass + 2.0) * psi - 0.5 * hop(u, psi)


def dirac_hat(u, psi: torch.Tensor, mass: float) -> torch.Tensor:
    """Dhat psi on even-masked psi: A psi - D_eo D_oe psi / A, the
    off-diagonal blocks being -1/2 the hop restricted to the other
    parity."""
    me = even_mask(psi)
    a = mass + 2.0
    return a * psi - me * hop(u, (1.0 - me) * hop(u, psi)) / (4.0 * a)


def _g5(psi: torch.Tensor) -> torch.Tensor:
    return torch.stack((psi[..., 0], -psi[..., 1]), dim=-1)


def dagger(op):
    """The adjoint of a g_5-hermitian operator: g_5 op g_5."""
    return lambda u, psi, mass: _g5(op(u, _g5(psi), mass))


def cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-chain <a, b>."""
    return (a.conj() * b).sum(dim=(1, 2, 3))


def cg(apply, b: torch.Tensor, x0: torch.Tensor, tol: float,
       maxiter: int = CG_MAXITER) -> torch.Tensor:
    """x with apply(x) = b, per chain (each stops at its own |r|^2 <= tol
    |b|^2)."""
    stop = tol * cdot(b, b).real
    x = x0.clone()
    r = b - apply(x)
    p = r
    rsq = cdot(r, r).real
    for _ in range(maxiter):
        live = rsq > stop
        if not bool(live.any()):
            break
        ap = apply(p)
        alpha = torch.where(live, rsq / cdot(p, ap).real, 0.0)
        x = x + alpha[:, None, None, None] * p
        r = r - alpha[:, None, None, None] * ap
        rn = cdot(r, r).real
        beta = torch.where(live, rn / rsq, 0.0)
        p = r + beta[:, None, None, None] * p
        rsq = torch.where(live, rn, rsq)
    return x


def conv3x3(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Periodic 3x3 cross-correlation plus bias, (B, C, L0, L1) -> (B, O,
    L0, L1), as ``flow.conv3x3`` computes it."""
    return F.conv2d(F.pad(h, (1, 1, 1, 1), mode="circular"), w, b)


class BatchedFlow(rflow.Flow):
    """``flow.Flow`` with its convs batched over the chains."""

    def conditioner(self, layer, h: torch.Tensor) -> torch.Tensor:
        with rflow.tf32(self.allow_tf32):
            for j, conv in enumerate(layer):
                if j:
                    h = self.act(h)
                h = conv3x3(h, conv["w"], conv["b"])
        return h


class SchwingerFT:
    """FT-HMC of the two-flavour Schwinger model in the latent field of
    ``flow`` (a ``flow.Flow``), one trajectory of Omelyan's integrator from
    each start; ``eo`` the even-odd Schur system."""

    def __init__(self, flow, beta: float, mass: float, tau: float,
                 nstep: int, eo: bool = True):
        self.flow, self.beta, self.mass = flow, beta, mass
        self.dt, self.nstep, self.eo = tau / nstep, nstep, eo
        self.op = dirac_hat if eo else dirac
        self.op_dag = dagger(self.op)

    # ---------------------------------------------------------------- parts

    def draws(self, g: torch.Generator, z: torch.Tensor):
        """(v0, chi, u) of one trajectory of z from ``g``, in the sampler's
        order; chi complex128, not yet masked."""
        v0 = torch.randn(z.shape, generator=g, dtype=torch.float32,
                         device=g.device)
        shape = (z.shape[0], *z.shape[2:], 2)
        re = torch.randn(shape, generator=g, dtype=torch.float32,
                         device=g.device)
        im = torch.randn(shape, generator=g, dtype=torch.float32,
                         device=g.device)
        u = torch.rand((z.shape[0],), generator=g, dtype=torch.float32,
                       device=g.device)
        chi = torch.complex(re.double(), im.double()) * math.sqrt(0.5)
        return v0, chi, u

    def _slices(self, n: int):
        return [slice(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK)]

    @torch.no_grad()
    def field(self, z: torch.Tensor):
        """(f(z), log det df/dz), a chunk of chains at a time."""
        out = [self.flow.forward(z[s]) for s in self._slices(z.shape[0])]
        return (torch.cat([o[0] for o in out]),
                torch.cat([o[1] for o in out]))

    def refresh(self, y: torch.Tensor, chi: torch.Tensor):
        """(phi, chi^dag chi) of the heatbath at y."""
        chi = chi.to(torch.complex128 if y.dtype == torch.float64
                     else torch.complex64)
        if self.eo:
            chi = chi * even_mask(chi)
        return self.op_dag(links(y), chi, self.mass), cdot(chi, chi).real

    def solve(self, y: torch.Tensor, phi: torch.Tensor, x0: torch.Tensor):
        """X = (op^dag op)^-1 phi at y."""
        u = links(y)
        tol = CG_TOL if y.dtype == torch.float64 else 1e-12
        return cg(lambda p: self.op_dag(u, self.op(u, p, self.mass),
                                        self.mass), phi, x0, tol)

    def pf_action(self, y, phi, x):
        """S_pf in its variational form at X = x."""
        dx = self.op(links(y), x, self.mass)
        return 2.0 * cdot(x, phi).real - cdot(dx, dx).real

    def force(self, z: torch.Tensor, phi: torch.Tensor, x0: torch.Tensor):
        """(dS_eff/dz, the solution X at f(z)): the solve on all chains, the
        autograd through the flow a chunk at a time."""
        y, _ = self.field(z)
        x = self.solve(y, phi, x0)
        g = torch.empty_like(z)
        for s in self._slices(z.shape[0]):
            with torch.enable_grad():
                zz = z[s].detach().requires_grad_(True)
                yy, logdet = self.flow.forward(zz)
                s_eff = (lat.action(yy, self.beta)
                         + self.pf_action(yy, phi[s], x[s]) - logdet)
                (g[s],) = torch.autograd.grad(s_eff.sum(), zz)
        return g, x

    # ----------------------------------------------------------- trajectory

    @torch.no_grad()
    def trajectory(self, z: torch.Tensor, v0: torch.Tensor,
                   chi: torch.Tensor):
        """(dH, y1, y0) of one trajectory from z with momenta v0 and the
        heatbath's chi."""
        lam, dt = OMELYAN_LAMBDA, self.dt
        y0, ld0 = self.field(z)
        phi, s0 = self.refresh(y0, chi)
        x = torch.zeros_like(phi)
        v = v0
        for _ in range(self.nstep):
            z = z + lam * dt * v
            f, x = self.force(z, phi, x)
            v = v - 0.5 * dt * f
            z = z + (1.0 - 2.0 * lam) * dt * v
            f, x = self.force(z, phi, x)
            v = v - 0.5 * dt * f
            z = z + lam * dt * v
        z = lat.wrap(z)
        y1, ld1 = self.field(z)
        x = self.solve(y1, phi, x)
        s1 = cdot(phi, x).real
        dh = (lat.delta_action(y1, y0, self.beta) + (s1 - s0)
              - (ld1 - ld0) + lat.kinetic_delta(v, v0))
        return dh, y1, y0

    @torch.no_grad()
    def replay(self, starts: list, gen_states: list, device) -> dict:
        """One trajectory from each start (B_i, 2, L, L), its draws from a
        generator on ``device`` set to the matching state; the starts run as
        one batch. Returns per chain, over the starts in order, float64 CPU
        tensors ``dh``, ``acc``, ``plaq``, ``q``, ``margin`` (-dH - log u)
        and the plaquette and charge of the start (``start_plaq``,
        ``start_q``): what ``check.compare`` reads."""
        v0s, chis, us = [], [], []
        for z, state in zip(starts, gen_states):
            g = torch.Generator(device)
            g.set_state(state)
            v0, chi, u = self.draws(g, z)
            v0s.append(v0)
            chis.append(chi)
            us.append(u)
        z = torch.cat(starts)
        dh, y1, y0 = self.trajectory(z, torch.cat(v0s).to(z.dtype),
                                     torch.cat(chis).to(z.device))
        dh = dh.to(torch.float64)
        u = torch.cat(us).to(torch.float64)
        acc = u < torch.exp(-dh)
        y = torch.where(acc[:, None, None, None], y1, y0)
        return {"dh": dh.cpu(), "acc": acc.to(torch.float64).cpu(),
                "plaq": lat.plaq_mean(y).double().cpu(),
                "q": lat.charge(y).double().cpu(),
                "margin": (-dh - torch.log(u)).cpu(),
                "start_plaq": lat.plaq_mean(y0).double().cpu(),
                "start_q": lat.charge(y0).double().cpu()}
