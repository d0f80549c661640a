"""K7 and K8, the coupling-layer forward-with-residuals and its
input-cotangent backward, their plain twins, and the FT-HMC force built on
them.

K7 replaces ``fthmc_tpu/ops/pallas_coupling_vjp.py::_fwd_res_kernel``
(``pallas_link_coupling_fwd_res``); K8 replaces ``_bwd_kernel``
(``pallas_link_coupling_bwd``); ``ft_force_kernel`` is the counterpart of
``ft_force_pallas``, with K1 for dS/dy at the flow output. CUDA sources:
``csrc/coupling_fwd.cu`` (K7 shares K6's kernel) and ``csrc/coupling_bwd.cu``.
Both are bound by the conv flops their outputs depend on (K7 285 MFLOP, K8
276 MFLOP per launch at the flagship's widths, 16^2 and 64 chains:
cotangents enter on the active stripe and leave on the frozen stripes;
``chip_smoke.coupling_macs`` counts them). The force needs d/dz only, so
K8 computes input cotangents and no parameter gradients, and reads the
activation gates from K7's stored pre-activations instead of recomputing
the convs. Fields stay chains-first (B, 2, L, L): the TPU kernels'
chains-last layout was a lane-axis device and is not carried over.
"""
from __future__ import annotations

import torch

from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.models.coupling import (_clip_s, _masks, _S_CLIP, _TINY,
                                             link_coupling_from_net_out,
                                             plaq_of_links, stack_cos_sin,
                                             wrap_pi)
from fthmc_tpu_torch.models.masks import layer_mask_params
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.conv import circular_conv2d, conv_net_preacts
from fthmc_tpu_torch.ops.coupling_kernels import (_conv_widths,
                                                  check_kernel_call,
                                                  launch_forward, net_args)
from fthmc_tpu_torch.ops.lattice_kernels import force as force_kernel

__all__ = ["coupling_fwd_res", "coupling_fwd_res_plain", "coupling_bwd",
           "coupling_bwd_plain", "ft_force_kernel"]


def coupling_fwd_res_plain(layer, x: torch.Tensor, mu: int, off: int,
                           spec: FlowSpec):
    """Plain twin of K7: (fx, logJ, residuals), the residuals being every
    conv's pre-activation (the last is the raw conditioner output)."""
    _build.PLAIN_CALLS["K7"] += 1
    frozen = _masks(tuple(x.shape[-2:]), mu, off, x.dtype, x.device)[0]
    plaq = plaq_of_links(x)
    res = conv_net_preacts(layer, stack_cos_sin(frozen * plaq),
                           spec.activation)
    fx, logj = link_coupling_from_net_out(x, plaq, res[-1], mu, off, spec)
    return fx, logj, tuple(res)


def coupling_fwd_res(layer, x: torch.Tensor, mu: int, off: int,
                     spec: FlowSpec):
    """One coupling layer forward keeping the residuals K8 needs:
    x (B, 2, L, L) -> (fx, logJ (B,), residuals). A CPU tensor takes the
    plain twin; a CUDA tensor launches K7."""
    if x.device.type == "cpu":
        return coupling_fwd_res_plain(layer, x, mu, off, spec)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_call("K7 coupling fwd_res", layer, x, spec)
    B, _, L, _ = x.shape
    res = tuple(torch.empty((B, c, L, L), dtype=x.dtype, device=x.device)
                for c in _conv_widths(spec)[1:])
    fx, logj = launch_forward(layer, x, mu, off, spec, res)
    _build.LAUNCHES["K7"] += 1
    return fx, logj, res


_ACT_GRADS = {
    "relu": lambda v: (v > 0).to(v.dtype),
    "silu": lambda v: torch.sigmoid(v) * (1 + v * (1 - torch.sigmoid(v))),
    "leaky_relu": lambda v: torch.where(v > 0, 1.0, 0.01).to(v.dtype),
    "tanh": lambda v: 1 - torch.tanh(v) ** 2,
}
_ACT_GRADS["swish"] = _ACT_GRADS["silu"]


def coupling_bwd_plain(layer, x: torch.Tensor, residuals, gy: torch.Tensor,
                       gl: torch.Tensor, mu: int, off: int,
                       spec: FlowSpec) -> torch.Tensor:
    """Plain twin of K8: the input cotangent gx of one coupling layer from
    the output cotangents (gy on the links, gl (B,) on logJ) and K7's
    residuals, by the same hand-derived chain rule as the kernel."""
    _build.PLAIN_CALLS["K8"] += 1
    frozen, active, _, links = _masks(tuple(x.shape[-2:]), mu, off, x.dtype,
                                      x.device)
    plaq = plaq_of_links(x)
    raw = residuals[-1]
    M, rncp = spec.n_mixture, spec.coupling == "rncp"

    # transform and link-lift backward
    s = _clip_s(raw[:, :M], spec)
    xa = (active * plaq)[:, None]
    y = wrap_pi(xa - raw[:, M:2 * M]) if rncp else xa.expand_as(s)
    g_f = active * (links[0] * gy[:, 0] - links[1] * gy[:, 1])
    gate = (s.abs() < _S_CLIP).to(s.dtype)
    cy, sy = torch.cos(0.5 * y), torch.sin(0.5 * y)
    e = torch.exp(torch.clamp(s, -_S_CLIP, _S_CLIP))
    dh_dy = e / (cy * cy + e * e * sy * sy)
    dh_ds = 2 * sy * cy * dh_dy * gate
    m = s.abs()
    ep, en = torch.exp(s - m), torch.exp(-s - m)
    inner = en * cy * cy + ep * sy * sy
    lj = -(m + torch.log(inner + _TINY))
    dlj_dy = -(sy * cy) * (ep - en) / (inner + _TINY)
    dlj_ds = (en * cy * cy - ep * sy * sy) / (inner + _TINY)
    g_hy = g_f[:, None] / M
    g_lj = (gl[:, None, None] * active)[:, None] * torch.softmax(lj, dim=1)
    g_y = g_hy * dh_dy + g_lj * dlj_dy - (g_hy if rncp else 0)
    g_s = g_hy * dh_ds + g_lj * dlj_ds
    if spec.s_clip is not None:
        g_s = g_s * (1 - (s / spec.s_clip) ** 2)
    g_xa = g_y.sum(dim=1) + (g_f if rncp else 0)
    g = torch.cat([g_s] + ([-g_y] if rncp else []) + [g_f[:, None]], dim=1)
    g_p = active * (g_xa - g_f)

    # transposed conv chain, gated by the stored pre-activations
    act_grad = _ACT_GRADS[spec.activation]
    for li in range(len(layer) - 1, -1, -1):
        w = layer[li]["w"]
        wt = w.flip(2, 3).transpose(0, 1).contiguous()
        g = circular_conv2d(g, wt, w.new_zeros(w.shape[1]))
        if li > 0:
            g = g * act_grad(residuals[li - 1])
    x2 = frozen * plaq
    g_p = g_p + frozen * (-torch.sin(x2) * g[:, 0] + torch.cos(x2) * g[:, 1])

    # plaquette-stencil transpose
    gx0 = gy[:, 0] + g_p - torch.roll(g_p, 1, dims=2)
    gx1 = gy[:, 1] + torch.roll(g_p, 1, dims=1) - g_p
    return torch.stack((gx0, gx1), dim=1)


def coupling_bwd(layer, x: torch.Tensor, residuals, gy: torch.Tensor,
                 gl: torch.Tensor, mu: int, off: int,
                 spec: FlowSpec) -> torch.Tensor:
    """Input cotangent of one coupling layer, (B, 2, L, L). A CPU tensor
    takes the plain twin; a CUDA tensor launches K8."""
    if x.device.type == "cpu":
        return coupling_bwd_plain(layer, x, residuals, gy, gl, mu, off, spec)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    check_kernel_call("K8 coupling bwd", layer, x, spec)
    B, _, L, _ = x.shape
    widths = _conv_widths(spec)
    if gy.shape != x.shape or gl.shape != (B,):
        raise ValueError("K8 coupling bwd: gy must match x and gl be (B,)")
    if [tuple(r.shape) for r in residuals] != [(B, c, L, L)
                                               for c in widths[1:]]:
        raise ValueError("K8 coupling bwd: residuals do not match the layer")
    _build.require_fp32_contiguous("K8 coupling bwd", x, gy, gl, *residuals)
    gx = launch_bwd(_build.library("coupling_bwd"), layer, x, residuals, gy,
                    gl, mu, off, spec, _build.stream_handle(x))
    _build.LAUNCHES["K8"] += 1
    return gx


def launch_bwd(lib, layer, x, residuals, gy, gl, mu: int, off: int,
               spec: FlowSpec, stream: int) -> torch.Tensor:
    """Run the K8 entry with freshly allocated scratch; returns gx."""
    B, _, L, _ = x.shape
    cmax = max(_conv_widths(spec))
    scratch = torch.empty((2, B * cmax * L * L), dtype=x.dtype,
                          device=x.device)
    gp = torch.empty((B, L, L), dtype=x.dtype, device=x.device)
    gx = torch.empty_like(x)
    n, widths, w, _, rncp, M, s_clip, act = net_args(layer, spec)
    rc = lib.k8_coupling_bwd(x.data_ptr(), gy.data_ptr(), gl.data_ptr(),
                             gx.data_ptr(), _build.ptr_array(residuals),
                             scratch[0].data_ptr(), scratch[1].data_ptr(),
                             gp.data_ptr(), B, L, n, widths, w, rncp, M,
                             s_clip, act, mu, off, stream)
    _build.check(rc, "k8_coupling_bwd", lib)
    return gx


@torch.no_grad()
def ft_force_kernel(params, spec: FlowSpec, z: torch.Tensor,
                    beta: float) -> torch.Tensor:
    """FT-HMC force dS_eff/dz, S_eff(z) = S(f(z)) - log|det df/dz|, through
    the per-layer kernels: K7 forward over every layer keeping residuals,
    K1 for dS/dy at the flow output, then K8 back through every layer with
    gl = -1. On the CPU every step is its plain twin. z: (B, 2, L, L)."""
    xs, residuals = [], []
    x = z
    for i, layer in enumerate(params):
        mu, off = layer_mask_params(i)
        xs.append(x)
        x, _, res = coupling_fwd_res(layer, x, mu, off, spec)
        residuals.append(res)
    gy = force_kernel(x, beta)
    gl = torch.full((z.shape[0],), -1.0, dtype=z.dtype, device=z.device)
    for i in range(len(params) - 1, -1, -1):
        mu, off = layer_mask_params(i)
        gy = coupling_bwd(params[i], xs[i], residuals[i], gy, gl, mu, off,
                          spec)
    return gy
