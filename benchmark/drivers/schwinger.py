"""Dynamical FT-HMC of the two-flavour Schwinger model through the program's
production driver, ``fthmc_tpu_torch.schwinger.run_fthmc_dyn_chunked``,
called as the ``schwinger`` command line calls it (the CG backend set
process-wide, force backend 'auto': K11 and the coupling kernels on the
card), one block of trajectories a call.

The trained flow is read from the benchmark's own copy of the ``.npz`` with
numpy and handed to the program and to the reference alike, and the chains
start at z0 = f^-1(unit links), as the flagship's driver starts them. The
set-up logs what 'auto' resolved to. Each block passes ``CG_LOG``, one
of the program's own ``fermion.CGLog``, to the program's driver: it keeps
the Python ints each solve's ``CGResult`` carries, so it reads nothing
from the device. ``launches`` adds its solves and CG iterations by kind to
the program's launch counters, as ``cg_solves.<kind>`` and
``cg_iters.<kind>``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch
from fthmc_tpu_torch.fermion import CGLog

from benchmark.drivers import common
from benchmark.drivers.common import seeds
from benchmark.reference.flow import load_npz
from benchmark.reference.schwinger import BatchedFlow, SchwingerFT


def _flow_file(config: dict, root) -> Path:
    return Path(root) / config["flow"]["file"]


# the solves of every block the samplers of this module run
CG_LOG = CGLog()


def launches() -> dict:
    """The program's launch counters, and the solves and CG iterations of
    ``CG_LOG`` by kind."""
    out = common.launches()
    for kind, solves in CG_LOG.solves.items():
        out[f"cg_solves.{kind}"] = len(solves)
        out[f"cg_iters.{kind}"] = sum(e[0] for e in solves)
    return out


class Sampler:
    """The program's dynamical FT-HMC chains of one cell."""

    def __init__(self, config: dict, cell: dict, seed: int, device, root):
        from fthmc_tpu_torch import fermion
        from fthmc_tpu_torch.config import FlowSpec
        from fthmc_tpu_torch.hmc import resolve_force_backend
        from fthmc_tpu_torch.models.flow import flow_reverse
        from fthmc_tpu_torch.schwinger import (SchwingerConfig,
                                               run_fthmc_dyn_chunked)
        from fthmc_tpu_torch.weights import flow_params_from_numpy
        self._run = run_fthmc_dyn_chunked
        fl = config["flow"]
        self.spec = FlowSpec(
            n_layers=fl["n_layers"], n_mixture=fl["n_mixture"],
            hidden_sizes=tuple(fl["hidden_sizes"]),
            kernel_size=fl["kernel_size"], coupling=fl["coupling"],
            activation=fl["activation"], conv_dtype=fl["conv_dtype"],
            s_clip=fl["s_clip"])
        self.device = torch.device(device)
        tree = load_npz(_flow_file(config, root), fl["n_layers"],
                        len(fl["hidden_sizes"]) + 1)
        self.params = flow_params_from_numpy(tree, self.spec,
                                             device=self.device)
        self.chains, self.block = cell["chains"], cell["block"]
        self.steps_per_traj = config["nstep"]
        L = config["L"]
        self.cfg = SchwingerConfig(
            L=L, beta=config["beta"], mass=config["mass"],
            tau=config["tau"], nstep=config["nstep"],
            n_chains=self.chains, ntraj=self.block,
            integrator=config["integrator"],
            eo_precond=config["eo_precond"],
            warm_start=config["warm_start"],
            cg_tol_force=config["cg_tol_force"],
            cg_tol_mh=config["cg_tol_mh"])
        self.force_backend = config["force_backend"]
        fermion.set_cg_backend(config["cg_backend"])
        shape = (self.chains, 2, L, L)
        cg = fermion.resolve_cg_backend(None, self.device)
        force = resolve_force_backend(self.force_backend, self.spec, shape,
                                      torch.float32, self.device)
        print(f"schwinger: {self.chains} chains of {L}^2, cg backend "
              f"{config['cg_backend']!r} -> {cg!r}, force backend "
              f"{self.force_backend!r} -> {force!r}", file=sys.stderr)
        self.generator = torch.Generator(self.device).manual_seed(
            seeds(seed, 1)[0])
        y0 = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.state, _ = flow_reverse(self.params, y0, self.spec)

    def run_block(self, callback) -> None:
        self.state, _ = self._run(
            self.params, self.spec, self.cfg, block=self.block,
            z0=self.state, generator=self.generator, callback=callback,
            force_backend=self.force_backend, device=self.device,
            cg_log=CG_LOG)

    def release(self) -> None:
        self.state = self.params = None


def reference(config: dict, root, device, dtype, allow_tf32=False):
    """The plain reference of this configuration, its flow and fermions in
    ``dtype`` (TF32 convs where ``allow_tf32``)."""
    if config["integrator"] != "omelyan":
        raise ValueError("the reference integrates with Omelyan's 2MN only")
    flow = BatchedFlow(config["flow"], _flow_file(config, root), dtype,
                       device, allow_tf32=allow_tf32)
    return SchwingerFT(flow, config["beta"], config["mass"], config["tau"],
                       config["nstep"], eo=config["eo_precond"])
