"""The gauge-equivariant flow: a stack of coupling layers.

Counterpart of ``fthmc_tpu/models/flow.py``. Flow parameters are a list
(one entry per coupling layer) of conv-chain parameter lists of
{'w': (Cout, Cin, 3, 3), 'b': (Cout,)} tensors, the JAX package's layout.
They hold no lattice size, so the same parameters apply at any L that is a
multiple of 4.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.models.coupling import (_SPLINE_TODO,
                                             link_coupling_forward,
                                             link_coupling_reverse)
from fthmc_tpu_torch.models.masks import layer_mask_params
from fthmc_tpu_torch.ops.conv import full_fp32, init_conv_net

__all__ = ["init_flow_params", "flow_forward", "flow_reverse",
           "count_parameters", "flow_out_channels"]


def flow_out_channels(spec: FlowSpec) -> int:
    """Conditioner output channels: M + 1 for ncp (s_i, t), 2M + 1 for rncp
    (s_i, r_i, t)."""
    if spec.coupling == "rncp":
        return 2 * spec.n_mixture + 1
    if spec.coupling == "ncp":
        return spec.n_mixture + 1
    raise NotImplementedError(_SPLINE_TODO)


def init_flow_params(spec: FlowSpec, generator: torch.Generator,
                     device=None, dtype=torch.float32):
    """Fresh parameters of a ``spec.n_layers``-deep flow, drawn from
    ``generator`` and placed on ``device`` (the card by default)."""
    device = resolve_device(device)
    return [init_conv_net(generator, 2, spec.hidden_sizes,
                          flow_out_channels(spec), spec.kernel_size,
                          init=spec.init, dtype=dtype, device=device)
            for _ in range(spec.n_layers)]


def flow_forward(params, x: torch.Tensor, spec: FlowSpec, remat: bool = True):
    """Apply the whole flow: x (B, 2, L, L) -> (y, logdet (B,)).

    Differentiable. With ``remat`` and autograd recording, each layer runs
    under ``torch.utils.checkpoint``, so a backward pass keeps one layer's
    activations at a time (the JAX package's per-layer remat).
    """
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    use_ckpt = remat and torch.is_grad_enabled()
    for i, p in enumerate(params):
        mu, off = layer_mask_params(i)
        if use_ckpt:
            x, logJ = checkpoint(link_coupling_forward, p, x, mu, off, spec,
                                 use_reentrant=False)
        else:
            x, logJ = link_coupling_forward(p, x, mu, off, spec)
        logdet = logdet + logJ
    return x, logdet


@torch.no_grad()
def flow_reverse(params, y: torch.Tensor, spec: FlowSpec, tol: float = 1e-6,
                 max_iter: int = 1000):
    """Apply the whole flow in reverse by bisection (not differentiable):
    y (B, 2, L, L) -> (x, logdet_rev (B,)), logdet_rev = -logdet_fwd(x).
    Plain torch ops on whatever device ``y`` lies on."""
    logdet = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
    with full_fp32():
        for i in reversed(range(len(params))):
            mu, off = layer_mask_params(i)
            y, logJ = link_coupling_reverse(params[i], y, mu, off, spec,
                                            tol=tol, max_iter=max_iter)
            logdet = logdet + logJ
    return y, logdet


def count_parameters(params) -> int:
    """Total trainable parameter count."""
    return sum(int(t.numel()) for net in params for conv in net
               for t in conv.values())
