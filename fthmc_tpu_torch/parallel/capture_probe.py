"""Whether a data-parallel training era, its NCCL all-reduces included,
can be captured in a CUDA graph and replayed to the eager era's losses.

``train.MESH_ERA_GRAPHED`` holds the answer as a fixed rule; this probe
finds it on the cards at hand. It runs a small era eager, then graphed,
from the same state, and exits 0 only if the graphed era's losses equal
the eager one's within 1e-5 relative on every rank. A failed capture can
leave the CUDA context unusable, so run it in a process of its own, never
inside a program that goes on:

    python -m fthmc_tpu_torch.parallel.capture_probe          # one card
    torchrun --nproc-per-node=N -m fthmc_tpu_torch.parallel.capture_probe

Under ``torchrun`` the group comes from its environment, each rank on
cuda:<LOCAL_RANK>; alone, the probe makes a group of one on a HashStore
(no TCP port).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from fthmc_tpu_torch import train as tt
from fthmc_tpu_torch.config import FlowSpec, TrainConfig
from fthmc_tpu_torch.parallel import mesh as pm

# latents a rank an epoch, epochs an era
LOCAL_BATCH, N_EPOCH = 8, 4


def probe() -> list[np.ndarray]:
    """(the eager era's losses, the graphed era's) on this rank, the
    process group initialized."""
    mesh = pm.make_chain_mesh()
    spec = FlowSpec(n_layers=2, coupling="ncp", n_mixture=2,
                    hidden_sizes=(4,))
    batch = LOCAL_BATCH * mesh.size
    cfg = TrainConfig(L=8, beta=2.0, batch_size=batch, flow=spec)
    rule, loss = tt.MESH_ERA_GRAPHED, []
    try:
        for graphed in (False, True):
            tt.MESH_ERA_GRAPHED = graphed
            st = tt.init_train_state(
                torch.Generator(mesh.device).manual_seed(0), cfg,
                device=mesh.device)
            _, h = pm.sharded_train_era(mesh, st, spec, batch=batch, L=8,
                                        beta=2.0, n_epoch=N_EPOCH)
            loss.append(np.asarray(h["loss_dkl"]))
    finally:
        tt.MESH_ERA_GRAPHED = rule
    torch.cuda.synchronize()
    return loss


def main() -> None:
    if "RANK" in os.environ:
        pm.initialize_multihost()
    else:
        pm.initialize_multihost(num_processes=1, process_id=0,
                                store=dist.HashStore())
    try:
        eager, graphed = probe()
        rank, size = dist.get_rank(), dist.get_world_size()
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} of {size}: eager {eager.tolist()} graphed "
          f"{graphed.tolist()}", flush=True)
    if not np.allclose(eager, graphed, rtol=1e-5, atol=0):
        raise SystemExit(f"rank {rank}: the graphed era's losses differ "
                         f"from the eager era's")


if __name__ == "__main__":
    main()
