"""What the samplers' adapters share: the program's launch counters and the
generator seeds a run derives from its ``--seed``."""
from __future__ import annotations

import numpy as np


def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 64-bit seeds from the run's seed (any whole
    number)."""
    ss = np.random.SeedSequence(seed & (2 ** 64 - 1))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64)]


def launches() -> dict:
    """The program's own count of each kernel's launches so far
    (``fthmc_tpu_torch.ops._build.LAUNCHES``)."""
    from fthmc_tpu_torch.ops import _build
    return dict(_build.LAUNCHES)
