"""Static stripe masks of the gauge-equivariant coupling layers.

The port's own copy of ``fthmc_tpu/models/masks.py`` (numpy constants,
cached per lattice shape, mu and offset). Coupling layer i acts with
mu = i % 2 and off = (i // 2) % 4:
  - link "active" mask: 1-in-4 stripes of mu-oriented links (the links updated)
  - plaquette "active": single stripes (the plaquettes transformed)
  - plaquette "frozen": double stripes at off+1 (the conditioner's input)
  - plaquette "passive": the rest (carried through unchanged)
With L a multiple of 4 the stripe of a site is (coord - off) % 4, coord the
axis perpendicular to mu: 0 active, 1 and 2 frozen, 3 passive. The CUDA
kernels compute the masks in that closed form.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["link_active_stripes", "single_stripes", "double_stripes",
           "plaq_masks", "layer_mask_params"]


def layer_mask_params(i: int) -> tuple[int, int]:
    """(mu, off) of coupling layer i."""
    return i % 2, (i // 2) % 4


@lru_cache(maxsize=None)
def link_active_stripes(shape: tuple[int, int, int], mu: int,
                        off: int) -> np.ndarray:
    """Active-link mask (2, L0, L1): 1-in-4 stripes of mu-links, rolled by
    ``off`` along the perpendicular axis; the other channel is 0."""
    if len(shape) != 3 or shape[0] != 2 or mu not in (0, 1):
        raise ValueError(f"bad link mask request {shape}, mu={mu}")
    mask = np.zeros(shape, dtype=np.float32)
    if mu == 0:
        mask[0, :, 0::4] = 1.0
    else:
        mask[1, 0::4, :] = 1.0
    mask = np.roll(mask, off, axis=2 - mu)
    mask.setflags(write=False)
    return mask


@lru_cache(maxsize=None)
def single_stripes(shape: tuple[int, int], mu: int, off: int) -> np.ndarray:
    """Single-stripe plaquette mask, period 4 perpendicular to mu."""
    if len(shape) != 2 or mu not in (0, 1):
        raise ValueError(f"bad plaquette mask request {shape}, mu={mu}")
    mask = np.zeros(shape, dtype=np.float32)
    if mu == 0:
        mask[:, 0::4] = 1.0
    else:
        mask[0::4, :] = 1.0
    mask = np.roll(mask, off, axis=1 - mu)
    mask.setflags(write=False)
    return mask


@lru_cache(maxsize=None)
def double_stripes(shape: tuple[int, int], mu: int, off: int) -> np.ndarray:
    """Double-stripe plaquette mask, period 4 perpendicular to mu."""
    if len(shape) != 2 or mu not in (0, 1):
        raise ValueError(f"bad plaquette mask request {shape}, mu={mu}")
    mask = np.zeros(shape, dtype=np.float32)
    if mu == 0:
        mask[:, 0::4] = 1.0
        mask[:, 1::4] = 1.0
    else:
        mask[0::4, :] = 1.0
        mask[1::4, :] = 1.0
    mask = np.roll(mask, off, axis=1 - mu)
    mask.setflags(write=False)
    return mask


@lru_cache(maxsize=None)
def plaq_masks(shape: tuple[int, int], mu: int, off: int):
    """(frozen, active, passive) plaquette masks: a disjoint partition of the
    lattice, frozen at off+1."""
    frozen = double_stripes(shape, mu, off + 1)
    active = single_stripes(shape, mu, off)
    passive = 1.0 - frozen - active
    passive.setflags(write=False)
    return frozen, active, passive
