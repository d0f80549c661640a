"""Plain HMC through the program's production driver,
``fthmc_tpu_torch.hmc.run_hmc_chunked``, called as its command line calls
it (backend 'auto', leapfrog), one block of trajectories a call.

A call runs ``run_blocks`` over one block, so its history comes back to the
host through ``run_blocks`` and the harness's callback stamps each block's
delivery. One long call would run the same work: ``run_blocks`` calls
``run_hmc`` once a block either way.
"""
from __future__ import annotations

import torch

# the harness reads the program's launch counters through ``launches``
from benchmark.drivers.common import launches, seeds  # noqa: F401
from benchmark.reference.sampler import PlainHMC


class Sampler:
    """The program's plain-HMC chains of one cell, from the cold start."""

    def __init__(self, config: dict, cell: dict, seed: int, device, root):
        from fthmc_tpu_torch.config import HMCConfig
        from fthmc_tpu_torch.hmc import run_hmc_chunked
        self._run = run_hmc_chunked
        self.chains, self.block = cell["chains"], cell["block"]
        self.steps_per_traj = config["nstep"]
        self.cfg = HMCConfig(beta=config["beta"], L=config["L"],
                             tau=config["tau"], nstep=config["nstep"],
                             ntraj=self.block, n_chains=self.chains,
                             randinit=False)
        self.integrator, self.backend = config["integrator"], config["backend"]
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(
            seeds(seed, 1)[0])
        self.state = torch.zeros((self.chains, 2, config["L"], config["L"]),
                                 dtype=torch.float32, device=self.device)

    def run_block(self, callback) -> None:
        self.state, _ = self._run(self.cfg, block=self.block, x0=self.state,
                                  generator=self.generator, callback=callback,
                                  backend=self.backend,
                                  integrator=self.integrator,
                                  device=self.device)

    def release(self) -> None:
        self.state = None


def reference(config: dict, root, device, dtype, allow_tf32=False):
    """The plain reference of this configuration."""
    del root, device, dtype, allow_tf32
    return PlainHMC(config["beta"], config["tau"], config["nstep"])

