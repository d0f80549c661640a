"""Reference-compatible API facade.

Counterpart of ``fthmc_tpu/api.py``: the names users of nftqcd/fthmc know,
mapped onto the port's functions:

    fthmc/utils/qed_helpers.py: BatchAction, batch_plaqs, batch_charges,
        plaq_phase, action, force, regularize, torch_wrap -> wrap,
        ft_flow, ft_flow_inv, ft_action, ft_force, leapfrog, hmc
    fthmc/utils/layers.py: make_u1_equiv_layers (-> make_flow),
        gauge_transform, random_gauge_transform
    fthmc/utils/distributions.py: calc_dkl, calc_ess, bootstrap,
        MultivariateUniform (-> uniform_link_prior), SimpleNormal
    fthmc/utils/samplers.py: apply_flow_to_prior, make_mcmc_ensemble,
        generate_ensemble
    fthmc/ft_hmc.py: FieldTransformation

Where the JAX facade takes a key, this one takes a ``torch.Generator``, and
the functions that make tensors take a ``device`` (the card by default).
``FieldTransformation.force_backend`` takes the port's names: 'auto' (the
kernels on the card, autograd on the CPU), 'autograd', 'kernel'.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import (FlowSpec, HMCConfig, LeapfrogConfig,
                                    SchedulerConfig, TrainConfig)
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import (TrajMetrics, ft_action, ft_force, fthmc_step,
                                 hmc_step, leapfrog, resolve_force_backend,
                                 run_fthmc, run_hmc)
from fthmc_tpu_torch.models.flow import (count_parameters, flow_forward,
                                         flow_reverse, init_flow_params)
from fthmc_tpu_torch.models.priors import normal_prior, uniform_link_prior
from fthmc_tpu_torch.observables import bootstrap, calc_dkl, calc_ess
from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel
from fthmc_tpu_torch.sampling import generate_ensemble, make_mcmc_ensemble

# --- qed_helpers-style names -------------------------------------------------

plaq_phase = lattice.plaq_phase
batch_plaqs = lattice.batch_plaqs
batch_charges = lattice.batch_charges
batch_action = lattice.batch_action
topo_charge = lattice.topo_charge
action = lattice.action
force = lattice.force
wrap = lattice.wrap
regularize = lattice.wrap      # the reference's regularize is the same map
gauge_transform = lattice.gauge_transform
random_gauge_transform = lattice.random_gauge_transform
PLAQ_EXACT = lattice.PLAQ_EXACT


class BatchAction:
    """Callable Wilson action over a batch (reference BatchAction,
    qed_helpers.py:166-186)."""

    def __init__(self, beta: float):
        self.beta = beta

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return lattice.batch_action(x, self.beta)


def make_flow(generator: torch.Generator, *, n_layers: int = 24,
              n_mixture: int = 2, hidden_sizes=(8, 8), kernel_size: int = 3,
              activation: str = "silu", device=None, dtype=torch.float32):
    """Build flow (params, spec) on ``device``, drawn from ``generator`` -
    the analogue of make_u1_equiv_layers (reference layers.py:399-429).
    Params are lattice-size independent."""
    spec = FlowSpec(n_layers=n_layers, n_mixture=n_mixture,
                    hidden_sizes=tuple(hidden_sizes),
                    kernel_size=kernel_size, activation=activation)
    return init_flow_params(spec, generator, device=device, dtype=dtype), spec


def ft_flow(params, spec: FlowSpec, x: torch.Tensor) -> torch.Tensor:
    """Forward flow, field only (reference qed_helpers.py:191-198)."""
    y, _ = flow_forward(params, x, spec)
    return y


def ft_flow_inv(params, spec: FlowSpec, y: torch.Tensor) -> torch.Tensor:
    """Inverse flow, field only (reference qed_helpers.py:201-209)."""
    x, _ = flow_reverse(params, y, spec)
    return x


def apply_flow_to_prior(params, spec: FlowSpec, generator: torch.Generator,
                        *, batch_size: int, L: int):
    """(x, z, logq) triple (reference samplers.py:40-56), on the
    parameters' device and in their dtype, z drawn from ``generator``."""
    from fthmc_tpu_torch.train import sample_and_logq
    return sample_and_logq(params, spec, generator, batch_size, L,
                           dtype=params[0][0]["w"].dtype)


# --- FieldTransformation facade ---------------------------------------------

@dataclass
class FieldTransformation:
    """OO facade over the FT-HMC functions (reference ft_hmc.py:109-346).

    The chain state is latent (z); `run` returns the metric history as
    stacked tensors. Construct via `FieldTransformation(params, spec, beta,
    lf)`; ``device`` (the card by default) is where the runs and the
    initializer place their tensors, and the parameters must be there.
    """
    params: Any
    spec: FlowSpec
    beta: float
    lf: LeapfrogConfig
    force_backend: str = "auto"   # 'auto' | 'autograd' | 'kernel' (K7, K1,
                                  # K8: ops/coupling_vjp_kernels.py)
    device: Any = None

    def action(self, z: torch.Tensor) -> torch.Tensor:
        return ft_action(self.params, self.spec, z, self.beta)

    def force(self, z: torch.Tensor) -> torch.Tensor:
        if resolve_force_backend(self.force_backend, self.spec, z.shape,
                                 z.dtype, z.device) == "kernel":
            return ft_force_kernel(self.params, self.spec, z, self.beta)
        return ft_force(self.params, self.spec, z, self.beta,
                        device=z.device)

    def flow_forward(self, z: torch.Tensor):
        return flow_forward(self.params, z, self.spec)

    def flow_backward(self, y: torch.Tensor):
        return flow_reverse(self.params, y, self.spec)

    def hmc(self, generator: torch.Generator, z: torch.Tensor, q_old=None):
        if q_old is None:
            with torch.no_grad():
                y, _ = self.flow_forward(z)
            q_old = lattice.batch_charges(y)
        return fthmc_step(self.params, self.spec, generator, z, q_old,
                          self.beta, self.lf.dt, self.lf.nstep,
                          force_backend=self.force_backend,
                          device=self.device)

    def run(self, generator: torch.Generator, z0: torch.Tensor,
            num_trajs: int = 1024):
        return run_fthmc(self.params, self.spec, self.lf, beta=self.beta,
                         ntraj=num_trajs, z0=z0, generator=generator,
                         force_backend=self.force_backend,
                         device=self.device)

    def initializer(self, generator: torch.Generator, n_chains: int, L: int,
                    rand: bool = True) -> torch.Tensor:
        device = resolve_device(self.device)
        if rand:
            return lattice.hot_start(generator, n_chains, L, device=device)
        return torch.zeros((n_chains, 2, L, L), dtype=torch.float32,
                           device=device)


__all__ = [
    "plaq_phase", "batch_plaqs", "batch_charges", "batch_action",
    "topo_charge", "action", "force", "wrap", "regularize",
    "gauge_transform", "random_gauge_transform", "PLAQ_EXACT", "BatchAction",
    "make_flow", "ft_flow", "ft_flow_inv", "ft_action", "ft_force",
    "apply_flow_to_prior", "FieldTransformation", "leapfrog", "hmc_step",
    "run_hmc", "run_fthmc", "fthmc_step", "calc_dkl", "calc_ess", "bootstrap",
    "uniform_link_prior", "normal_prior", "make_mcmc_ensemble",
    "generate_ensemble", "count_parameters", "TrajMetrics",
    "FlowSpec", "HMCConfig", "LeapfrogConfig", "SchedulerConfig",
    "TrainConfig",
]
