"""FT-HMC through the program's production driver,
``fthmc_tpu_torch.hmc.run_fthmc_chunked``, called as its command line calls
it (Omelyan, force backend 'auto': the coupling kernels on the card), one
block of trajectories a call.

The trained flow is read from the benchmark's own copy of the ``.npz`` with
numpy and handed to the program (``weights.flow_params_from_numpy``) and to
the reference alike. The chains start at z0 = f^-1(y0), the latent image of
the start field through the program's ``flow_reverse``, as the command
line's cold start does.
"""
from __future__ import annotations

from pathlib import Path

import torch

# the harness reads the program's launch counters through ``launches``
from benchmark.drivers.common import launches, seeds  # noqa: F401
from benchmark.reference.flow import Flow, load_npz
from benchmark.reference.sampler import FlowedHMC


def _flow_file(config: dict, root) -> Path:
    return Path(root) / config["flow"]["file"]


class Sampler:
    """The program's FT-HMC chains of one cell."""

    def __init__(self, config: dict, cell: dict, seed: int, device, root):
        from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
        from fthmc_tpu_torch.hmc import run_fthmc_chunked
        from fthmc_tpu_torch.models.flow import flow_reverse
        from fthmc_tpu_torch.weights import flow_params_from_numpy
        self._run = run_fthmc_chunked
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
        self.lf = LeapfrogConfig(tau=config["tau"], nstep=config["nstep"])
        self.beta = config["beta"]
        self.chains, self.block = cell["chains"], cell["block"]
        self.steps_per_traj = config["nstep"]
        self.integrator = config["integrator"]
        self.force_backend = config["force_backend"]
        self.generator = torch.Generator(self.device).manual_seed(
            seeds(seed, 1)[0])
        L = config["L"]
        y0 = torch.zeros((self.chains, 2, L, L), dtype=torch.float32,
                         device=self.device)
        self.state, _ = flow_reverse(self.params, y0, self.spec)

    def run_block(self, callback) -> None:
        self.state, _ = self._run(
            self.params, self.spec, self.lf, beta=self.beta,
            ntraj=self.block, z0=self.state, generator=self.generator,
            block=self.block, callback=callback, integrator=self.integrator,
            force_backend=self.force_backend, device=self.device)

    def release(self) -> None:
        self.state = self.params = None


def reference(config: dict, root, device, dtype, allow_tf32=False):
    """The plain reference of this configuration, its flow in ``dtype``
    (TF32 convs where ``allow_tf32``)."""
    flow = Flow(config["flow"], _flow_file(config, root), dtype, device,
                allow_tf32=allow_tf32)
    return FlowedHMC(flow, config["beta"], config["tau"], config["nstep"])
