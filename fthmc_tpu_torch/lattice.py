"""Lattice physics of 2D U(1) gauge theory on link-angle fields.

A configuration is ``x`` of shape ``(2, L0, L1)`` (direction axis first);
batched chains add a leading axis, ``(B, 2, L0, L1)``. The functions below
take any number of leading axes. Counterpart of ``fthmc_tpu/lattice.py``,
with its one plaquette convention (mu=0, nu=1):

    P(x) = theta_0(x) + theta_1(x + e0) - theta_0(x + e1) - theta_1(x)

so ``P = x[0] + roll(x[1], -1, 0) - roll(x[0], -1, 1) - x[1]`` on the
(L0, L1) plane.
"""
from __future__ import annotations

import math

import torch

from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.ops.lattice_kernels import force as _force_kernel

PI = math.pi
TWO_PI = 2.0 * math.pi

# Exact <plaq> = I_1(beta)/I_0(beta) (ratio of modified Bessel functions).
PLAQ_EXACT = {
    1.0: 0.44638990, 1.5: 0.59613320,
    2.0: 0.69777477, 2.5: 0.76499665,
    3.0: 0.80998540, 3.5: 0.84110373,
    4.0: 0.86352290, 4.5: 0.88033150,
    5.0: 0.89338326, 5.5: 0.90381753,
    6.0: 0.91235965, 6.5: 0.91948840,
    7.0: 0.92553246, 7.5: 0.93072510,
    8.0: 0.93523590, 8.5: 0.93919160,
    9.0: 0.94268996, 9.5: 0.94580620,
}


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi). A floor-mod: ``torch.remainder`` takes the
    sign of the divisor, where ``fmod`` would keep that of ``x``."""
    return torch.remainder(x + PI, TWO_PI) - PI


def mod_2pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [0, 2pi)."""
    return torch.remainder(x, TWO_PI)


def plaq_phase(x: torch.Tensor) -> torch.Tensor:
    """Plaquette phase: (..., 2, L0, L1) -> (..., L0, L1)."""
    x0, x1 = x[..., 0, :, :], x[..., 1, :, :]
    return (x0 + torch.roll(x1, -1, dims=-2)
            - torch.roll(x0, -1, dims=-1) - x1)


def action(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Wilson action S = -beta * sum_P cos(P): (..., 2, L, L) -> (...)."""
    return -beta * torch.cos(plaq_phase(x)).sum(dim=(-2, -1))


def action_density(x: torch.Tensor) -> torch.Tensor:
    """cos(P) field; S = -beta * sum(action_density)."""
    return torch.cos(plaq_phase(x))


def delta_action(x1: torch.Tensor, x0: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """S(x1) - S(x0) as a sum of per-site cos differences, which stays well
    conditioned in fp32 when |S| ~ beta * V is large."""
    d = torch.cos(plaq_phase(x1)) - torch.cos(plaq_phase(x0))
    return -beta * d.sum(dim=(-2, -1))


def plaq_mean(x: torch.Tensor) -> torch.Tensor:
    """Average plaquette <cos P>: (..., 2, L, L) -> (...)."""
    return torch.cos(plaq_phase(x)).mean(dim=(-2, -1))


def topo_charge(x: torch.Tensor) -> torch.Tensor:
    """Geometric topological charge Q = sum_P wrap(P) / 2pi."""
    return wrap(plaq_phase(x)).sum(dim=(-2, -1)) / TWO_PI


def force(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Analytic gauge force dS/dtheta as a sin stencil, in plain torch ops:
      dS/dtheta_0(y) = beta * [sin P(y) - sin P(y - e1)]
      dS/dtheta_1(y) = beta * [sin P(y - e0) - sin P(y)]"""
    sp = torch.sin(plaq_phase(x))
    f0 = sp - torch.roll(sp, 1, dims=-1)
    f1 = torch.roll(sp, 1, dims=-2) - sp
    return beta * torch.stack((f0, f1), dim=-3)


def grad_force(x: torch.Tensor, beta: float) -> torch.Tensor:
    """dS/dx by autograd, the cross-check of the analytic stencil."""
    with torch.enable_grad():
        y = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(action(y, beta).sum(), y)
    return g


def wilson_loop_phase(x: torch.Tensor, R: int, T: int) -> torch.Tensor:
    """Phase of the R x T rectangular Wilson loop at every site:
    (..., 2, L0, L1) -> (..., L0, L1).

    theta(y) = sum_{r<R} t0(y + r e0) + sum_{t<T} t1(y + R e0 + t e1)
             - sum_{r<R} t0(y + r e0 + T e1) - sum_{t<T} t1(y + t e1);
    R = T = 1 is the plaquette phase."""
    x0, x1 = x[..., 0, :, :], x[..., 1, :, :]
    bottom = sum(torch.roll(x0, -r, dims=-2) for r in range(R))
    top = torch.roll(bottom, -T, dims=-1)
    left = sum(torch.roll(x1, -t, dims=-1) for t in range(T))
    right = torch.roll(left, -R, dims=-2)
    return bottom + right - top - left


def wilson_loop(x: torch.Tensor, R: int, T: int) -> torch.Tensor:
    """<cos theta> of the R x T Wilson loop: (..., 2, L0, L1) -> (...). In
    2D U(1) its expectation is (I1/I0)^(R T)."""
    return torch.cos(wilson_loop_phase(x, R, T)).mean(dim=(-2, -1))


def polyakov_loop(x: torch.Tensor, mu: int = 0) -> torch.Tensor:
    """Volume-averaged Polyakov loop winding direction mu, as the real pair
    [Re P, Im P]: (..., 2, L0, L1) -> (..., 2). Gauge invariant."""
    theta = x[..., mu, :, :].sum(dim=-2 + mu)
    return torch.stack((torch.cos(theta).mean(dim=-1),
                        torch.sin(theta).mean(dim=-1)), dim=-1)


def gauge_transform(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """theta_mu(y) -> alpha(y) + theta_mu(y) - alpha(y + e_mu) for links
    (..., 2, L0, L1) and alpha (..., L0, L1); the plaquette phase is
    unchanged."""
    return torch.stack([alpha + x[..., mu, :, :]
                        - torch.roll(alpha, -1, dims=-2 + mu)
                        for mu in range(2)], dim=-3)


def random_gauge_transform(generator: torch.Generator,
                           x: torch.Tensor) -> torch.Tensor:
    """Gauge-transform each chain of (B, 2, L0, L1) by its own alpha,
    uniform in [0, 2pi), drawn on the generator's device."""
    alpha = torch.rand(x.shape[:1] + x.shape[2:], generator=generator,
                       dtype=x.dtype, device=generator.device) * TWO_PI
    return gauge_transform(x, alpha.to(x.device))


# Batched names of the JAX package: every function above already takes a
# leading chain axis.
batch_plaqs = plaq_phase
batch_action = action
batch_charges = topo_charge
batch_plaq_mean = plaq_mean
batch_wilson_loops = wilson_loop
batch_polyakov_loops = polyakov_loop


def batch_force(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Force per chain, (B, 2, L, L) -> same shape. On the card this is the
    hand-written force kernel (ops/lattice_kernels.py)."""
    return _force_kernel(x, beta)


def cold_start(L: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Zero-link (unit gauge) configuration (2, L, L)."""
    return torch.zeros((2, L, L), dtype=dtype, device=resolve_device(device))


def hot_start(generator: torch.Generator, batch: int, L: int, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """Uniform(-pi, pi) batch (batch, 2, L, L), drawn on the generator's
    device and moved to ``device``."""
    u = torch.rand((batch, 2, L, L), generator=generator, dtype=dtype,
                   device=generator.device)
    return (u * TWO_PI - PI).to(resolve_device(device))
