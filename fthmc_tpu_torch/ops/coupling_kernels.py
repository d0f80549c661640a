"""K6, the fused coupling-layer forward, its plain twin, and the kernels'
support envelope.

Replaces the TPU kernel ``fthmc_tpu/ops/pallas_coupling.py::_ncp_kernel``
(``pallas_link_coupling_forward``, driven by ``pallas_flow_forward``).
CUDA source: ``csrc/coupling_fwd.cu`` (with ``csrc/coupling_common.cuh``),
one block per chain for the whole layer. Bound on the card: the conv flops
the layer's outputs depend on (the last conv on the active stripe, the one
before on its one-site halo: 285 MFLOP per launch at the flagship's widths,
16^2 and 64 chains, of the dense chain's 481); the bytes it must move are
~100x smaller. The energy flows of FT-HMC (y = f(z) before and after a
trajectory) run through it.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.models.coupling import (CouplingOut,
                                             link_coupling_forward)
from fthmc_tpu_torch.models.masks import layer_mask_params
from fthmc_tpu_torch.ops import _build

__all__ = ["coupling_forward", "coupling_forward_plain",
           "kernel_flow_forward", "kernel_fits"]

ACT_CODES = {"relu": 0, "silu": 1, "swish": 1, "leaky_relu": 2, "tanh": 3}


@lru_cache(maxsize=None)
def smem_bytes(widths: tuple[int, ...], L: int) -> int:
    """Dynamic shared memory of one K6/K7/K8 block, as the kernels' own
    ``smem_layout`` reckons it (csrc/coupling_common.cuh); -1 for a
    conditioner the kernels do not take (more than their MAX_CONVS convs)."""
    return _build.library("coupling_fwd").ft_smem_bytes(
        len(widths) - 1, _build.int_array(widths), L)


@lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """Dynamic shared memory one block may opt in to on a CUDA device."""
    limit = _build.library("coupling_fwd").ft_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"cannot read the shared memory limit of "
                           f"cuda:{device_index}")
    return limit


def _conv_widths(spec: FlowSpec) -> list[int]:
    M = spec.n_mixture
    out = 2 * M + 1 if spec.coupling == "rncp" else M + 1
    return [2, *spec.hidden_sizes, out]


def kernel_fits(spec: FlowSpec, L: int, B: int) -> bool:
    """The kernels' envelope in the spec and shape alone: ncp/rncp with fp32
    3x3 convs and a ported activation, L a multiple of 4 (the closed-form
    stripe masks), any chain count B (one block per chain). This covers the
    JAX package's envelope (L <= 8 or B <= 128, for L a multiple of 4) and
    the flagship's 16^2 and 64^2 shapes. On the card a launch also needs
    one block's weights and haloed tile within the device's shared memory;
    ``check_kernel_call`` asks the kernels' library for that and refuses a
    conditioner too wide or too deep. The CPU's plain twins take any."""
    return (spec.coupling in ("ncp", "rncp") and spec.conv_dtype == "float32"
            and spec.kernel_size == 3 and spec.activation in ACT_CODES
            and L % 4 == 0 and L >= 4 and B >= 1)


def check_kernel_call(what: str, layer, x: torch.Tensor,
                      spec: FlowSpec) -> None:
    """Refuse, loudly, what the kernels do not take."""
    if x.ndim != 4 or x.shape[1] != 2 or x.shape[2] != x.shape[3]:
        raise ValueError(f"{what}: links must be (B, 2, L, L), got "
                         f"{tuple(x.shape)}")
    B, _, L, _ = x.shape
    if not kernel_fits(spec, L, B):
        raise ValueError(f"{what}: outside the kernels' envelope "
                         f"(coupling={spec.coupling!r}, "
                         f"conv_dtype={spec.conv_dtype!r}, L={L}, B={B})")
    widths = [2] + [int(p["w"].shape[0]) for p in layer]
    if widths != _conv_widths(spec):
        raise ValueError(f"{what}: conv widths {widths} do not match spec")
    _build.require_fp32_contiguous(what, x, *[t for p in layer
                                              for t in (p["w"], p["b"])])
    need = smem_bytes(tuple(widths), L)
    limit = smem_limit(x.device.index if x.device.index is not None
                       else torch.cuda.current_device())
    if not 0 < need <= limit:
        raise ValueError(f"{what}: conv widths {widths} at L={L} need "
                         f"{need} bytes of shared memory a block (-1: too "
                         f"many convs); the card allows {limit}")


def net_args(layer, spec: FlowSpec):
    """(n_convs, widths, w pointers, b pointers, rncp, M, s_clip,
    activation) of the C entries."""
    widths = _conv_widths(spec)
    return (len(layer), _build.int_array(widths),
            _build.ptr_array([p["w"] for p in layer]),
            _build.ptr_array([p["b"] for p in layer]),
            int(spec.coupling == "rncp"), spec.n_mixture,
            float(spec.s_clip) if spec.s_clip is not None else 0.0,
            ACT_CODES[spec.activation])


def launch_forward(layer, x: torch.Tensor, mu: int, off: int,
                   spec: FlowSpec, bufs):
    """Run the coupling forward entry of K6 and K7 with activation buffers
    ``bufs`` (one per conv: K6's scratch, K7's residuals); returns
    (fx, logJ)."""
    lib = _build.library("coupling_fwd")
    B, _, L, _ = x.shape
    fx = torch.empty_like(x)
    logj = torch.empty(B, dtype=x.dtype, device=x.device)
    n, widths, w, b, rncp, M, s_clip, act = net_args(layer, spec)
    rc = lib.ft_coupling_forward(x.data_ptr(), fx.data_ptr(),
                                 logj.data_ptr(), _build.ptr_array(bufs), B,
                                 L, n, widths, w, b, rncp, M, s_clip, act, mu,
                                 off, _build.stream_handle(x))
    _build.check(rc, "ft_coupling_forward", lib)
    return fx, logj


def coupling_forward_plain(layer, x: torch.Tensor, mu: int, off: int,
                           spec: FlowSpec) -> CouplingOut:
    """Plain twin of K6: the torch coupling forward."""
    _build.PLAIN_CALLS["K6"] += 1
    return link_coupling_forward(layer, x, mu, off, spec)


def coupling_forward(layer, x: torch.Tensor, mu: int, off: int,
                     spec: FlowSpec) -> CouplingOut:
    """One coupling layer forward, links x: (B, 2, L, L) -> (fx, logJ (B,)).
    Not differentiable. A CPU tensor takes the plain twin; a CUDA tensor
    launches K6."""
    if x.device.type == "cpu":
        return coupling_forward_plain(layer, x, mu, off, spec)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_call("K6 coupling forward", layer, x, spec)
    B, _, L, _ = x.shape
    cmax = max(_conv_widths(spec))
    ping, pong = torch.empty((2, B * cmax * L * L), dtype=x.dtype,
                             device=x.device)
    bufs = [ping if i % 2 == 0 else pong for i in range(len(layer))]
    fx, logj = launch_forward(layer, x, mu, off, spec, bufs)
    _build.LAUNCHES["K6"] += 1
    return CouplingOut(fx, logj)


def kernel_flow_forward(params, x: torch.Tensor, spec: FlowSpec):
    """Whole flow forward through K6, one launch per layer (the plain twin
    on the CPU): x (B, 2, L, L) -> (y, logdet (B,)). Not differentiable."""
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, layer in enumerate(params):
        mu, off = layer_mask_params(i)
        x, logJ = coupling_forward(layer, x, mu, off, spec)
        logdet = logdet + logJ
    return x, logdet
