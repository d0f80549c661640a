"""The port's counter-based generator, Philox4x32-10, in plain torch integer
ops: the twin of ``csrc/philox.cuh``, bit for bit.

K4 draws its momenta and accept uniforms in the kernel from this stream,
keyed by (seed, chain) with the counter running over (site, link direction,
draw kind, 0); the plain twin of K4 draws the same numbers here, so the two
can be held elementwise against each other on the card. (The TPU kernel it
replaces used the TPU's own generator, which has no CPU lowering; its
streams are not these.)

torch has no unsigned 32-bit multiply-high, so each 32 x 32-bit product is
split into 16-bit halves inside int64. The functions take Python ints or
int64 tensors (which broadcast) and return the same kind.
"""
from __future__ import annotations

import math

import torch

__all__ = ["philox4x32_10", "uniform24", "momenta", "accept_uniforms"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # key schedule (Weyl) increments
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b):
    """(hi, lo) words of the 64-bit product of the constant ``a`` and the
    32-bit words ``b``, every partial product below 2^49."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32 with 10 rounds (Salmon et al., SC'11). ``counter``: four
    32-bit words, ``key``: two. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform24(w: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(0, 1] uniforms from 24 bits of each word, (m + 1) 2^-24: exact in
    fp32, never 0, as the JAX package's ``_uniform_from_bits``."""
    m = ((w & 0x7FFFFFFF) >> 7).to(dtype)
    return m * 2.0 ** -24 + 2.0 ** -24


def _key0(seed: torch.Tensor) -> torch.Tensor:
    """The seed (one int32, any sign) as an unsigned 32-bit key word."""
    return seed.reshape(()).to(torch.int64) & _MASK32


def momenta(seed: torch.Tensor, B: int, L: int, dtype=torch.float32,
            device=None) -> torch.Tensor:
    """K4's momenta (B, 2, L, L): link (d, s) of chain b is
    sqrt(-2 log u1) cos(2 pi u2) from words 0, 1 of
    Philox(counter (s, d, 0, 0), key (seed, b))."""
    device = seed.device if device is None else device
    s = torch.arange(L * L, device=device).view(1, 1, L, L)
    d = torch.arange(2, device=device).view(1, 2, 1, 1)
    b = torch.arange(B, device=device).view(B, 1, 1, 1)
    w = philox4x32_10((s, d, 0, 0), (_key0(seed).to(device), b))
    u1, u2 = uniform24(w[0], dtype), uniform24(w[1], dtype)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def accept_uniforms(seed: torch.Tensor, B: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """K4's accept draws (B,): word 0 of Philox(counter (0, 0, 1, 0),
    key (seed, b))."""
    device = seed.device if device is None else device
    b = torch.arange(B, device=device)
    w = philox4x32_10((0, 0, 1, 0), (_key0(seed).to(device), b))
    return uniform24(w[0], dtype)
