"""Plain 2D U(1) lattice gauge theory on link angles, the reference's own.

A field is (B, 2, L0, L1), the direction axis second. The plaquette phase
(mu=0, nu=1) is

    P(x) = theta_0(x) + theta_1(x + e0) - theta_0(x + e1) - theta_1(x),

the Wilson action S = -beta sum_P cos P, its force dS/dtheta a sin
stencil, and the geometric charge Q = sum_P wrap(P) / 2pi. Written from
these formulas in plain torch, in whatever dtype the field has.
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Angles to [-pi, pi)."""
    return torch.remainder(x + math.pi, TWO_PI) - math.pi


def plaq_phase(x: torch.Tensor) -> torch.Tensor:
    """(B, 2, L0, L1) -> (B, L0, L1)."""
    x0, x1 = x[:, 0], x[:, 1]
    return x0 + torch.roll(x1, -1, dims=-2) - torch.roll(x0, -1, dims=-1) - x1


def action(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Wilson action per chain."""
    return -beta * torch.cos(plaq_phase(x)).sum(dim=(-2, -1))


def delta_action(x1: torch.Tensor, x0: torch.Tensor,
                 beta: float) -> torch.Tensor:
    """S(x1) - S(x0) per chain, as a sum of per-site differences."""
    d = torch.cos(plaq_phase(x1)) - torch.cos(plaq_phase(x0))
    return -beta * d.sum(dim=(-2, -1))


def force(x: torch.Tensor, beta: float) -> torch.Tensor:
    """dS/dtheta: beta [sin P(y) - sin P(y - e1)] on theta_0 and
    beta [sin P(y - e0) - sin P(y)] on theta_1."""
    sp = torch.sin(plaq_phase(x))
    f0 = sp - torch.roll(sp, 1, dims=-1)
    f1 = torch.roll(sp, 1, dims=-2) - sp
    return beta * torch.stack((f0, f1), dim=1)


def plaq_mean(x: torch.Tensor) -> torch.Tensor:
    """<cos P> per chain."""
    return torch.cos(plaq_phase(x)).mean(dim=(-2, -1))


def charge(x: torch.Tensor) -> torch.Tensor:
    """Geometric topological charge per chain."""
    return wrap(plaq_phase(x)).sum(dim=(-2, -1)) / TWO_PI


def kinetic_delta(v1: torch.Tensor, v0: torch.Tensor) -> torch.Tensor:
    """0.5 (|v1|^2 - |v0|^2) per chain, as an elementwise difference."""
    d = (v1 - v0) * (v1 + v0)
    return 0.5 * d.reshape(d.shape[0], -1).sum(dim=-1)
