"""Circular-padded 3x3 convolution chains of the coupling-layer conditioners.

Counterpart of ``fthmc_tpu/ops/conv.py``: wrap padding then a VALID
cross-correlation, NCHW activations and OIHW weights, so a JAX weight
``w`` of shape (Cout, Cin, 3, 3) is used as it is.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["circular_conv2d", "circular_conv2d_dense", "conv_net_apply",
           "conv_net_preacts", "dense_circulant", "init_conv_net",
           "ACTIVATIONS", "full_fp32"]


@contextlib.contextmanager
def full_fp32():
    """Run fp32 convolutions and products in full fp32. cuDNN's default
    TF32 keeps about three decimal digits; every comparison of the port
    assumes fp32 accumulation."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def circular_conv2d(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Periodic 2D conv. x: (B, Cin, H, W), w: (Cout, Cin, k, k), b: (Cout,).
    The bias is added after the convolution, as the JAX package does."""
    p = w.shape[-1] // 2
    with full_fp32():
        y = F.conv2d(F.pad(x, (p, p, p, p), mode="circular"), w)
    return y + b[None, :, None, None]


@lru_cache(maxsize=None)
def _circulant_index(L: int, k: int):
    """Neighbour table of the dense-circulant expansion: for each kernel tap
    (dy, dx), the flat site q(p) = ((i+dy)%L)*L + (j+dx)%L of every site p.
    Returns numpy arrays (taps, L*L) and (L*L,)."""
    r = k // 2
    p = np.arange(L * L)
    i, j = p // L, p % L
    qs = [((i + dy) % L) * L + ((j + dx) % L)
          for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    return np.stack(qs), p


def dense_circulant(w: torch.Tensor, L: int) -> torch.Tensor:
    """A (Cout, Cin, k, k) periodic-conv kernel as the equivalent dense
    matrix (Cin*L*L, Cout*L*L), so that the conv is one matmul. A utility
    for operators precomputed once: as the flow's conv it lost 3x in the
    JAX package (64x the operations)."""
    O, C, k, _ = w.shape
    qs, p = _circulant_index(L, k)
    D = torch.zeros((C, L * L, O, L * L), dtype=w.dtype, device=w.device)
    p_t = torch.as_tensor(p, device=w.device)
    for t in range(k * k):
        dy, dx = divmod(t, k)
        # y[b, o, p] += w[o, c, dy, dx] * x[b, c, q(p)]
        q_t = torch.as_tensor(qs[t], device=w.device)
        D[:, q_t, :, p_t] += w[:, :, dy, dx].T[None]
    return D.reshape(C * L * L, O * L * L)


def circular_conv2d_dense(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Periodic conv through the dense-circulant matmul. x: (B, Cin, L, L)."""
    B, C, L, _ = x.shape
    with full_fp32():
        y = x.reshape(B, C * L * L) @ dense_circulant(w, L)
    return y.reshape(B, w.shape[0], L, L) + b[None, :, None, None]


ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
}


def init_conv_net(generator: torch.Generator, in_channels: int,
                  hidden_sizes: tuple[int, ...], out_channels: int,
                  kernel_size: int, init: str = "reference",
                  dtype=torch.float32, device=None) -> list[dict]:
    """Parameters of a conv chain: a list of {'w', 'b'} tensors, drawn on
    the generator's device and moved to ``device``.

    init='reference' is torch's default Conv2d init, weights and bias ~
    U(-1/sqrt(fan_in), +1/sqrt(fan_in)) (what the reference code runs in
    effect). init='set_weights_bug' applies the reference's intended N(1, 2)
    weights and -1 bias literally, kept to document that quirk.
    init='normal' is a fan-in-scaled normal with zero bias.
    """
    sizes = (in_channels, *hidden_sizes, out_channels)
    gdev = generator.device
    params = []
    for i in range(len(sizes) - 1):
        shape = (sizes[i + 1], sizes[i], kernel_size, kernel_size)
        bound = 1.0 / (sizes[i] * kernel_size * kernel_size) ** 0.5

        def uniform(sh):
            u = torch.rand(sh, generator=generator, dtype=dtype, device=gdev)
            return (2.0 * u - 1.0) * bound

        if init == "reference":
            w, b = uniform(shape), uniform((sizes[i + 1],))
        elif init == "set_weights_bug":
            w = 1.0 + 2.0 * torch.randn(shape, generator=generator,
                                        dtype=dtype, device=gdev)
            b = -torch.ones((sizes[i + 1],), dtype=dtype, device=gdev)
        elif init == "normal":
            w = torch.randn(shape, generator=generator, dtype=dtype,
                            device=gdev) * bound
            b = torch.zeros((sizes[i + 1],), dtype=dtype, device=gdev)
        else:
            raise ValueError(f"unknown init {init!r}")
        params.append({"w": w.to(device), "b": b.to(device)})
    return params


def conv_net_preacts(params: list[dict], x: torch.Tensor, activation: str,
                     compute_dtype: torch.dtype | None = None
                     ) -> list[torch.Tensor]:
    """The conv chain's pre-activations, one per conv; the last is the
    chain's output (no activation after it).

    With ``compute_dtype`` (torch.bfloat16) each conv casts its input,
    weights and bias to it, runs in it (cuDNN accumulates in fp32 and rounds
    the output) and casts the result back to x's dtype, as the JAX package
    does; the activations run in x's dtype."""
    act = ACTIVATIONS[activation]
    out_dtype = x.dtype
    pre = []
    for p in params:
        h = act(pre[-1]) if pre else x
        if compute_dtype is not None and compute_dtype != out_dtype:
            y = circular_conv2d(h.to(compute_dtype), p["w"].to(compute_dtype),
                                p["b"].to(compute_dtype)).to(out_dtype)
        else:
            y = circular_conv2d(h, p["w"], p["b"])
        pre.append(y)
    return pre


def conv_net_apply(params: list[dict], x: torch.Tensor, activation: str,
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Apply the conv chain with ``activation`` between convs (none after
    the last), each conv in ``compute_dtype`` when given."""
    return conv_net_preacts(params, x, activation, compute_dtype)[-1]
