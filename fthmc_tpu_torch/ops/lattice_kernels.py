"""K1, the Wilson gauge force stencil, and its plain PyTorch twin.

Replaces the TPU kernel ``fthmc_tpu/ops/pallas_lattice.py::_force_kernel``
(``pallas_force``). CUDA source: ``csrc/force.cu``, one thread per (chain,
site). Memory-bound on the card: at 16^2 with 64 chains it reads and writes
131 KB each, against a few flops per site.
"""
from __future__ import annotations

import torch

from fthmc_tpu_torch.ops import _build

__all__ = ["force", "force_plain"]


def force_plain(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Plain twin: F = beta * (sin P - shifted sin P), (B, 2, L, L)."""
    _build.PLAIN_CALLS["K1"] += 1
    sp = torch.sin(x[:, 0] + torch.roll(x[:, 1], -1, dims=1)
                   - torch.roll(x[:, 0], -1, dims=2) - x[:, 1])
    f0 = sp - torch.roll(sp, 1, dims=2)
    f1 = torch.roll(sp, 1, dims=1) - sp
    return beta * torch.stack((f0, f1), dim=1)


def _launch(lib, x: torch.Tensor, beta: float, stream: int) -> torch.Tensor:
    B, _, L, _ = x.shape
    f = torch.empty_like(x)
    rc = lib.k1_force(x.data_ptr(), f.data_ptr(), B, L, float(beta), stream)
    _build.check(rc, "K1 force", lib)
    return f


def force(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Gauge force of a batch x: (B, 2, L, L). A CPU tensor takes the plain
    twin; a CUDA tensor launches K1."""
    if x.ndim != 4 or x.shape[1] != 2 or x.shape[2] != x.shape[3]:
        raise ValueError(f"force takes (B, 2, L, L), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return force_plain(x, beta)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _build.require_fp32_contiguous("K1 force", x)
    f = _launch(_build.library("force"), x, beta, _build.stream_handle(x))
    _build.LAUNCHES["K1"] += 1
    return f
