"""Run an SPMD function on ranks of this host without ``torchrun``.

``spawn(fn, nprocs, *args)`` starts ``nprocs`` processes, joins them in a
process group built on a ``FileStore`` under a directory of the caller's
(no TCP port, so several groups can run side by side), calls ``fn(rank,
*args)`` in each and returns every rank's return value, in rank order.
The ranks are gloo ranks on the CPU, one torch thread each, the way the
parallel drivers run on a host without cards; for the cards of one host
use ``torchrun --nproc-per-node=N`` and ``mesh.initialize_multihost()``
instead.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn"]


def _rank_main(rank: int, fn, nprocs: int, workdir: str,
               args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), nprocs)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=nprocs)
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def spawn(fn, nprocs: int, *args, workdir: str | None = None) -> list:
    """``fn(rank, *args)`` on ``nprocs`` new processes joined in a gloo
    process group (one torch thread each): every rank's return value
    (anything ``torch.save`` takes), in rank order. ``fn`` must be
    importable (a module's top-level function). The store and the results
    live in ``workdir`` (a new temporary directory when None)."""
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        mp.spawn(_rank_main, args=(fn, nprocs, d, args),
                 nprocs=nprocs, join=True)
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
