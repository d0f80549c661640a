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


# Batched names of the JAX package: every function above already takes a
# leading chain axis.
batch_plaqs = plaq_phase
batch_action = action
batch_charges = topo_charge
batch_plaq_mean = plaq_mean


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
