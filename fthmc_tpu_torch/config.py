"""Run configuration of the PyTorch port: the flow architecture, the
integrator and plain-HMC run parameters.

The port's own copy of the dataclasses in ``fthmc_tpu/config.py`` (the port
imports nothing of the JAX package). Field names and defaults are the same,
so a FlowSpec recorded in a checkpoint's metadata loads into either.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

__all__ = ["FlowSpec", "LeapfrogConfig", "HMCConfig", "filter_kwargs"]


@dataclass(frozen=True)
class FlowSpec:
    """Static architecture of the gauge-equivariant flow (3x3 CNN
    conditioners, so the same parameters apply at any lattice size)."""
    n_layers: int = 24            # coupling layers in the stack
    n_mixture: int = 2            # mixture components per active plaquette
    hidden_sizes: tuple[int, ...] = (8, 8)
    kernel_size: int = 3
    coupling: str = "ncp"         # 'ncp' | 'rncp' (rotated mixture) |
                                  # 'spline' (not ported yet)
    n_knots: int = 8              # spline bins per site (coupling='spline')
    activation: str = "silu"      # relu | silu | swish | leaky_relu | tanh
    init: str = "reference"       # 'reference' | 'normal' | 'set_weights_bug'
    conv_dtype: str = "float32"   # 'bfloat16' runs the conditioner convs in
                                  # bf16; transforms and logJ stay fp32
    s_clip: float | None = None   # smooth cap s -> s_clip * tanh(s / s_clip)

    def __post_init__(self):
        object.__setattr__(self, "hidden_sizes", tuple(self.hidden_sizes))


@dataclass(frozen=True)
class LeapfrogConfig:
    """Trajectory length and step count."""
    tau: float = 2.0
    nstep: int = 10

    @property
    def dt(self) -> float:
        return self.tau / self.nstep


@dataclass(frozen=True)
class HMCConfig:
    """Plain-HMC run parameters."""
    beta: float = 6.0
    L: int = 8
    tau: float = 2.0
    nstep: int = 10
    ntraj: int = 256
    nrun: int = 4
    n_chains: int = 1
    nprint: int = 256
    seed: int = 11 * 13
    randinit: bool = False

    @property
    def dt(self) -> float:
        return self.tau / self.nstep

    @property
    def lat(self) -> tuple[int, int]:
        return (self.L, self.L)

    @property
    def volume(self) -> int:
        return self.L * self.L

    @property
    def lf(self) -> LeapfrogConfig:
        return LeapfrogConfig(tau=self.tau, nstep=self.nstep)


def filter_kwargs(cls, d: dict[str, Any]) -> dict[str, Any]:
    """Keep only the keys of ``d`` that are fields of dataclass ``cls``."""
    names = {f.name for f in fields(cls)}
    return {k: v for k, v in d.items() if k in names}
