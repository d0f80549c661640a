"""Run configuration of the PyTorch port: the flow architecture, the
integrator, plain-HMC run parameters, and flow training with its
reduce-on-plateau scheduler; and their JSON loading (``make_configs``,
``load_json_configs``).

The port's own copy of the dataclasses in ``fthmc_tpu/config.py`` (the port
imports nothing of the JAX package). Field names and defaults are the same,
so a FlowSpec recorded in a checkpoint's metadata loads into either.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field, fields, replace
from typing import Any

__all__ = ["FlowSpec", "LeapfrogConfig", "HMCConfig", "SchedulerConfig",
           "TrainConfig", "filter_kwargs", "make_configs",
           "load_json_configs", "config_to_dict", "with_updates"]


@dataclass(frozen=True)
class FlowSpec:
    """Static architecture of the gauge-equivariant flow (3x3 CNN
    conditioners, so the same parameters apply at any lattice size)."""
    n_layers: int = 24            # coupling layers in the stack
    n_mixture: int = 2            # mixture components per active plaquette
    hidden_sizes: tuple[int, ...] = (8, 8)
    kernel_size: int = 3
    coupling: str = "ncp"         # 'ncp' | 'rncp' (rotated mixture) |
                                  # 'spline' (circular RQ spline)
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


@dataclass(frozen=True)
class SchedulerConfig:
    """Reduce-on-plateau settings of flow training (``train.py``): after
    ``patience`` epochs without a relative improvement of ``threshold``,
    the learning rate is multiplied by ``factor``, floored at ``min_lr``,
    and ``cooldown`` epochs pass before bad epochs count again."""
    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    cooldown: int = 0
    min_lr: float = 1e-5

    def uniquestr(self) -> str:
        return f"f{self.factor}_p{self.patience}_m{self.min_lr}"


@dataclass(frozen=True)
class TrainConfig:
    """Flow-training run parameters: reverse-KL training of ``flow`` at
    (L, beta), ``n_era`` eras of ``n_epoch`` steps of ``batch_size`` prior
    draws, Adam at ``base_lr``."""
    L: int = 8
    beta: float = 2.0
    n_era: int = 10
    n_epoch: int = 100
    batch_size: int = 64
    base_lr: float = 0.001
    flow: FlowSpec = field(default_factory=FlowSpec)
    with_force: bool = False      # alternate a force-matching step
    force_lr_factor: float = 0.01  # its learning rate: base_lr * this
    force_weight: float = 0.0     # joint objective: dkl_factor * D_KL +
                                   # force_weight * mean(F_eff^2) on the
                                   # same prior batch; 0 = off
    ferm_mass: float = 0.0        # F_eff with the exact two-flavour
                                   # log-det at this Wilson mass (dense,
                                   # train volumes only); 0 = pure gauge
    dkl_factor: float = 1.0
    beta_init: float | None = None  # beta ramps linearly from beta_init to
                                    # beta over beta_anneal_frac of all
                                    # steps; None = constant beta
    beta_anneal_frac: float = 0.7
    grad_clip: float | None = None  # global-norm gradient clipping; None =
                                    # off
    print_freq: int = 50
    plot_freq: int = 50
    log_freq: int = 50
    seed: int = 1331
    restore: bool = False

    @property
    def lat(self) -> tuple[int, int]:
        return (self.L, self.L)

    @property
    def volume(self) -> int:
        return self.L * self.L

    def uniquestr(self) -> str:
        hstr = "".join(str(i) for i in self.flow.hidden_sizes)
        return "_".join([
            f"L{self.L}", f"b{self.beta}", f"nb{self.batch_size}",
            f"act{self.flow.activation}", f"nh{self.flow.n_layers}",
            f"ns{self.flow.n_mixture}", f"ks{self.flow.kernel_size}",
            f"hl{hstr}", f"lr{self.base_lr}",
            f"era{self.n_era}", f"epoch{self.n_epoch}",
        ])

    def logdir(self, basedir: str = "logs") -> str:
        lat = "x".join(str(x) for x in self.lat)
        return os.path.join(
            basedir, "models", f"lat{lat}", f"beta{self.beta}",
            self.uniquestr())


def filter_kwargs(cls, d: dict[str, Any]) -> dict[str, Any]:
    """Keep only the keys of ``d`` that are fields of dataclass ``cls``."""
    names = {f.name for f in fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def make_configs(raw: dict[str, Any]):
    """(HMCConfig, TrainConfig, LeapfrogConfig, SchedulerConfig or None)
    from one JSON dict: either nested {"hmc": {...}, "train": {...},
    "fthmc": {...}, "scheduler": {...}} or a flat one, each flat key routed
    to every configuration that has a field of that name. The reference's
    spellings ``n_s_nets`` (n_mixture) and ``activation_fn`` (activation)
    are read too."""
    nested = {k: raw.get(k, {})
              for k in ("hmc", "train", "fthmc", "scheduler")}
    flat = {k: v for k, v in raw.items() if k not in nested}

    train_raw = {**flat, **nested["train"]}
    flow_kwargs = filter_kwargs(FlowSpec, train_raw)
    for src, dst in (("n_s_nets", "n_mixture"),
                     ("activation_fn", "activation")):
        v = train_raw.get(src)
        if v is not None:
            flow_kwargs[dst] = v
    if "hidden_sizes" in flow_kwargs:
        flow_kwargs["hidden_sizes"] = tuple(flow_kwargs["hidden_sizes"])
    flow = FlowSpec(**flow_kwargs)

    hmc = HMCConfig(**filter_kwargs(HMCConfig, {**flat, **nested["hmc"]}))
    train = TrainConfig(flow=flow, **filter_kwargs(
        TrainConfig, {k: v for k, v in train_raw.items() if k != "flow"}))
    lf = LeapfrogConfig(**filter_kwargs(LeapfrogConfig,
                                        {**flat, **nested["fthmc"]}))
    sched = None
    if nested["scheduler"]:
        sched = SchedulerConfig(
            **filter_kwargs(SchedulerConfig, nested["scheduler"]))
    return hmc, train, lf, sched


def load_json_configs(path: str):
    """``make_configs`` of a JSON file."""
    with open(path) as f:
        raw = json.load(f)
    return make_configs(raw)


def config_to_dict(cfg) -> dict:
    """A configuration as a plain dict (nested dataclasses included)."""
    return asdict(cfg)


def with_updates(cfg, **kwargs):
    """A copy of ``cfg`` with the given fields replaced."""
    return replace(cfg, **kwargs)
