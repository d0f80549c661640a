"""K7 and K8, the coupling-layer forward-with-residuals and its
input-cotangent backward, their plain twins, and the FT-HMC force built on
them.

K7 replaces ``fthmc_tpu/ops/pallas_coupling_vjp.py::_fwd_res_kernel``
(``pallas_link_coupling_fwd_res``); K8 replaces ``_bwd_kernel``
(``pallas_link_coupling_bwd``); ``ft_force_kernel`` is the counterpart of
``ft_force_pallas``, with K1 for dS/dy at the flow output. CUDA sources:
``csrc/coupling_fwd.cu`` (K7 shares K6's kernel) and ``csrc/coupling_bwd.cu``,
both a thread-block cluster per chain with the activations (K8: the
cotangents) in the bands' shared memory (``coupling_kernels.band_plan``).
Both are bound by the conv flops their outputs depend on (K7 285 MFLOP, K8
276 MFLOP per launch at the flagship's widths, 16^2 and 64 chains:
cotangents enter on the active stripe and leave on the frozen stripes;
PERF.md section 6). Each runs 361: K7 its last conv
on the active stripe alone, K8 only the taps of its first transposed conv
that reach that stripe (``coupling_kernels.launch_macs``). The force needs
d/dz only, so K8 computes input cotangents and no parameter gradients, and
reads the activation gates from K7's stored pre-activations instead of
recomputing the convs; K7's residual of the last conv, the raw conditioner
output, is kept on the active stripe, 0 elsewhere, as K8 reads it there.
Fields stay chains-first (B, 2, L, L): the TPU kernels' chains-last layout
was a lane-axis device and is not carried over.
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
from fthmc_tpu_torch.ops.coupling_kernels import (_conv_widths, forward_call,
                                                  launch_macs, launch_args,
                                                  launch_forward,
                                                  scratch_for)
from fthmc_tpu_torch.ops.lattice_kernels import force as force_kernel

__all__ = ["coupling_fwd_res", "coupling_fwd_res_plain", "coupling_bwd",
           "coupling_bwd_plain", "transform_bwd_plain", "bwd_call",
           "flow_vjp_kernel", "ft_force_kernel"]


def coupling_fwd_res_plain(layer, x: torch.Tensor, mu: int, off: int,
                           spec: FlowSpec):
    """Plain twin of K7: (fx, logJ, residuals), the residuals being every
    conv's pre-activation, the last (the raw conditioner output) on the
    active stripe and 0 elsewhere, as the kernel stores it."""
    _build.PLAIN_CALLS["K7"] += 1
    frozen, active = _masks(tuple(x.shape[-2:]), mu, off, x.dtype,
                            x.device)[:2]
    plaq = plaq_of_links(x)
    res = conv_net_preacts(layer, stack_cos_sin(frozen * plaq),
                           spec.activation)
    fx, logj = link_coupling_from_net_out(x, plaq, res[-1], mu, off, spec)
    res[-1] = res[-1] * active
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
    a = launch_args("K7 coupling fwd_res", layer, x, spec)
    return launch_forward(a, x, mu, off, True)


ACT_GRADS = {
    "relu": lambda v: (v > 0).to(v.dtype),
    "silu": lambda v: torch.sigmoid(v) * (1 + v * (1 - torch.sigmoid(v))),
    "leaky_relu": lambda v: torch.where(v > 0, 1.0, 0.01).to(v.dtype),
    "tanh": lambda v: 1 - torch.tanh(v) ** 2,
}
ACT_GRADS["swish"] = ACT_GRADS["silu"]


def transform_bwd_plain(x: torch.Tensor, raw: torch.Tensor, gy: torch.Tensor,
                        gl: torch.Tensor, mu: int, off: int, spec: FlowSpec):
    """K8's stage A in torch: the link-lift and mixture-transform backward
    of one coupling layer from its raw conditioner output. Returns (g, g_p):
    the cotangent of the raw output (B, Cout, L, L) and the direct part of
    the plaquette cotangent (B, L, L)."""
    _, active, _, links = _masks(tuple(x.shape[-2:]), mu, off, x.dtype,
                                 x.device)
    plaq = plaq_of_links(x)
    M, rncp = spec.n_mixture, spec.coupling == "rncp"
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
    return g, active * (g_xa - g_f)


def coupling_bwd_plain(layer, x: torch.Tensor, residuals, gy: torch.Tensor,
                       gl: torch.Tensor, mu: int, off: int,
                       spec: FlowSpec) -> torch.Tensor:
    """Plain twin of K8: the input cotangent gx of one coupling layer from
    the output cotangents (gy on the links, gl (B,) on logJ) and K7's
    residuals, by the same hand-derived chain rule as the kernel."""
    _build.PLAIN_CALLS["K8"] += 1
    g, g_p = transform_bwd_plain(x, residuals[-1], gy, gl, mu, off, spec)
    # transposed conv chain, gated by the stored pre-activations
    act_grad = ACT_GRADS[spec.activation]
    for li in range(len(layer) - 1, -1, -1):
        w = layer[li]["w"]
        wt = w.flip(2, 3).transpose(0, 1).contiguous()
        g = circular_conv2d(g, wt, w.new_zeros(w.shape[1]))
        if li > 0:
            g = g * act_grad(residuals[li - 1])
    frozen = _masks(tuple(x.shape[-2:]), mu, off, x.dtype, x.device)[0]
    x2 = frozen * plaq_of_links(x)
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
    what = "K8 coupling bwd"
    a = launch_args(what, layer, x, spec)
    if gy.shape != x.shape or gl.shape != (a.B,):
        raise ValueError(f"{what}: gy must match x and gl be (B,)")
    if tuple(r.shape for r in residuals) != a.res_shapes:
        raise ValueError(f"{what}: residuals do not match the layer")
    _build.require_fp32_contiguous(what, x, gy, gl, *residuals)
    gx = torch.empty_like(x)
    _scratch, scratch = scratch_for(a, x)
    bwd_call(a, x.data_ptr(), gy.data_ptr(), gl.data_ptr(), gx.data_ptr(),
             _build.ptr_array(residuals), scratch, mu, off,
             _build.stream_handle(x))
    return gx


def bwd_call(a, x: int, gy: int, gl: int, gx: int, res, scratch, mu: int,
             off: int, stream: int) -> None:
    """One launch of the K8 entry on device pointers (``res`` a C array of
    K7's residuals), counted with the conv multiply-adds it runs. Every
    K8 launch of the port goes through here."""
    lib = _build.library("coupling_bwd")
    rc = lib.k8_coupling_bwd(x, gy, gl, gx, res, scratch, a.B, a.L, a.n,
                             a.widths, a.w_bwd, a.rncp, a.M, a.s_clip, a.act,
                             mu, off, a.C, a.row0, a.limit, stream)
    _build.check(rc, "k8_coupling_bwd", lib)
    _build.LAUNCHES["K8"] += 1
    _build.CONV_MACS["K8"] += launch_macs(a.conv_widths, a.L, a.B, a.plan,
                                          mu, off)[1]


@torch.no_grad()
def flow_vjp_kernel(params, spec: FlowSpec, z: torch.Tensor, cotangent,
                    logdet_cotangent: float = -1.0) -> torch.Tensor:
    """d/dz of S(f(z)) + gl log|det df/dz| for an action S whose gradient
    at the flow output y = f(z) is ``cotangent(y)``, gl the log-det
    cotangent (-1: S_eff's own log-det term; 0: the pull-back of S alone,
    the nested FT integrator's fermion force), through the per-layer
    kernels: K7 forward over every layer keeping residuals, the cotangent
    at y, then K8 back through every layer with that gl. On the CPU every
    step is its plain twin. z: (B, 2, L, L)."""
    if z.device.type == "cuda":
        return _flow_vjp_cuda(params, spec, z, cotangent, logdet_cotangent)
    xs, residuals = [], []
    x = z
    for i, layer in enumerate(params):
        mu, off = layer_mask_params(i)
        xs.append(x)
        x, _, res = coupling_fwd_res(layer, x, mu, off, spec)
        residuals.append(res)
    gy = cotangent(x)
    gl = torch.full((z.shape[0],), logdet_cotangent, dtype=z.dtype,
                    device=z.device)
    for i in range(len(params) - 1, -1, -1):
        mu, off = layer_mask_params(i)
        gy = coupling_bwd(params[i], xs[i], residuals[i], gy, gl, mu, off,
                          spec)
    return gy


def _flow_vjp_cuda(params, spec: FlowSpec, z: torch.Tensor, cotangent,
                   logdet_cotangent: float):
    """flow_vjp_kernel on the card, its launch path lean: one workspace for
    every layer's output, residuals and logJ (K7's logJ is not needed here)
    and the band scratch, and one for two cotangent fields; each launch
    then costs the host the layer's cached arguments (``launch_args``, which
    checks every layer at z's shape) and one ctypes call."""
    n = len(params)
    args = [launch_args("K7 coupling fwd_res", layer, z, spec)
            for layer in params]
    B, L = args[0].B, args[0].L
    site = B * L * L                 # floats of one channel; a multiple of 16
    widths = _conv_widths(spec)
    per_layer = site * sum(widths[1:])
    scratch = args[0].scratch        # the same for every layer
    ws = torch.empty(n * 2 * site + n * per_layer + scratch + n * B,
                     dtype=z.dtype, device=z.device)
    base = ws.data_ptr()

    def xs(i: int) -> int:           # layer i's output
        return base + 4 * 2 * site * i

    res = []
    for i in range(n):
        first = n * 2 * site + i * per_layer
        offs = [first + site * sum(widths[1:c]) for c in range(1, len(widths))]
        res.append(_build.int_ptrs([base + 4 * o for o in offs]))
    sp = base + 4 * (n * (2 * site + per_layer)) if scratch else None
    logj = base + 4 * (n * (2 * site + per_layer) + scratch)
    stream = _build.stream_handle(z)
    for i in range(n):
        mu, off = layer_mask_params(i)
        forward_call(args[i], z.data_ptr() if i == 0 else xs(i - 1), xs(i),
                     logj + 4 * B * i, res[i], sp, mu, off, stream)
    y = ws[2 * site * (n - 1):2 * site * n].view(z.shape)
    gy = cotangent(y)
    _build.require_fp32_contiguous("flow_vjp_kernel cotangent", z, gy)
    if gy.shape != z.shape:
        raise ValueError("flow_vjp_kernel: the cotangent must match z")
    gl = torch.full((B,), logdet_cotangent, dtype=z.dtype, device=z.device)
    gx = torch.empty((2, *z.shape), dtype=z.dtype, device=z.device)
    g_in, g_base = gy.data_ptr(), gx.data_ptr()
    for k, i in enumerate(range(n - 1, -1, -1)):
        mu, off = layer_mask_params(i)
        g_out = g_base + 4 * 2 * site * (k & 1)
        bwd_call(args[i], z.data_ptr() if i == 0 else xs(i - 1), g_in,
                 gl.data_ptr(), g_out, res[i], sp, mu, off, stream)
        g_in = g_out
    return gx[(n - 1) & 1]


def ft_force_kernel(params, spec: FlowSpec, z: torch.Tensor,
                    beta: float) -> torch.Tensor:
    """FT-HMC force dS_eff/dz, S_eff(z) = S(f(z)) - log|det df/dz| with the
    Wilson action S: ``flow_vjp_kernel`` with K1's force at y."""
    return flow_vjp_kernel(params, spec, z, lambda y: force_kernel(y, beta))
