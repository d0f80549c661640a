"""Device resolution for the port's entry points: the card unless the caller
asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Raises when no card is present instead
    of falling back to the CPU; pass ``device="cpu"`` to run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fthmc_tpu_torch runs on the CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev

