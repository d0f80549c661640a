"""Prior distributions over link fields.

Counterpart of ``fthmc_tpu/models/priors.py``: a prior is a NamedTuple of
(sample_n, log_prob) closures over static shape information. ``sample_n``
draws from the caller's ``torch.Generator``, on the generator's device, and
places the draw on the prior's device.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from fthmc_tpu_torch.device import resolve_device

__all__ = ["Prior", "uniform_link_prior", "normal_prior"]

PI = math.pi
TWO_PI = 2.0 * math.pi


class Prior(NamedTuple):
    sample_n: Callable  # (generator, batch) -> (batch, *event_shape)
    log_prob: Callable  # (x) -> (batch,)
    event_shape: tuple


def uniform_link_prior(L: int, dtype=torch.float32, device=None) -> Prior:
    """Uniform(-pi, pi) on every link angle of a (2, L, L) field, drawn on
    the generator's device and placed on ``device`` (the card by default).
    log q(x) = -2 L^2 log(2 pi), a constant."""
    device = resolve_device(device)
    event_shape = (2, L, L)
    logp_const = -2 * L * L * math.log(TWO_PI)

    def sample_n(generator: torch.Generator, batch: int) -> torch.Tensor:
        u = torch.rand((batch, *event_shape), generator=generator,
                       dtype=dtype, device=generator.device)
        return (-PI + TWO_PI * u).to(device)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        return torch.full((x.shape[0],), logp_const, dtype=x.dtype,
                          device=x.device)

    return Prior(sample_n, log_prob, event_shape)


def normal_prior(event_shape: tuple, dtype=torch.float32,
                 device=None) -> Prior:
    """Standard normal prior over an arbitrary event shape, drawn on the
    generator's device and placed on ``device`` (the card by default)."""
    device = resolve_device(device)
    n = math.prod(event_shape)
    const = -0.5 * n * math.log(TWO_PI)

    def sample_n(generator: torch.Generator, batch: int) -> torch.Tensor:
        return torch.randn((batch, *event_shape), generator=generator,
                           dtype=dtype, device=generator.device).to(device)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        return const - 0.5 * (x.reshape(x.shape[0], -1) ** 2).sum(dim=-1)

    return Prior(sample_n, log_prob, event_shape)
