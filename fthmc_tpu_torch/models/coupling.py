"""Gauge-equivariant coupling layers: mixture plaquette transform + link lift.

Counterpart of ``fthmc_tpu/models/coupling.py`` in plain, differentiable
torch ops. Fields are chains-first (B, 2, L, L). Math of the non-compact
projection (ncp) mixture on the active plaquettes:

    h_s(x)   = 2 atan(e^s tan(x/2))                   (monotone on (-pi, pi))
    f(x)     = wrap( mean_i h_{s_i}(x) + t )
    log|J|   = logsumexp_i( -log(e^{-s_i} cos^2(x/2) + e^{s_i} sin^2(x/2)) )
               - log(n_mix)

and of the rotated mixture (rncp): f(x) = x + mean_i [h_{s_i}(y_i) - y_i]
with y_i = wrap(x - r_i), logJ = logsumexp_i log h'_{s_i}(y_i) - log M. The
circular rational-quadratic spline (spline) is ``models/spline.py``. The
conditioner CNN reads stack(cos, sin) of the frozen plaquettes and returns
(s, t) for ncp, (s, r, t) for rncp, (3K spline channels, t) for spline; with
``conv_dtype='bfloat16'`` its convs run in bf16 and the transforms in fp32.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.models.masks import link_active_stripes, plaq_masks
from fthmc_tpu_torch.models.spline import spline_forward, spline_inverse
from fthmc_tpu_torch.ops.conv import conv_net_apply

PI = math.pi
TWO_PI = 2.0 * math.pi

# Value-path hard clip of the log-scale s: by |s| ~ 30 the transform has
# saturated far below fp32 resolution, so the clip only keeps exp() finite
# (zero gradient outside it). The log-Jacobian does not clip; it factors out
# m = |s| (detached) so both exponents are <= 0.
_S_CLIP = 30.0
_TINY = 1e-30


def wrap_pi(x: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi) with a floor-mod (torch.remainder, never fmod)."""
    return torch.remainder(x + PI, TWO_PI) - PI


def stack_cos_sin(x: torch.Tensor) -> torch.Tensor:
    """(B, L, L) -> (B, 2, L, L) channels (cos x, sin x)."""
    return torch.stack((torch.cos(x), torch.sin(x)), dim=1)


def tan_transform(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """h_s(x) = wrap(2 atan2(e^s sin(x/2), cos(x/2))), exact on (-pi, pi]."""
    sc = torch.clamp(s, -_S_CLIP, _S_CLIP)
    return wrap_pi(2.0 * torch.atan2(torch.exp(sc) * torch.sin(0.5 * x),
                                     torch.cos(0.5 * x)))


def tan_transform_logJ(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """log dh_s/dx = -log(e^-s cos^2(x/2) + e^s sin^2(x/2)), factored by
    m = |s| (detached): no overflow for any s, and d logJ/ds tends to -+1
    for large |s|."""
    c, sn = torch.cos(0.5 * x), torch.sin(0.5 * x)
    m = s.abs().detach()
    inner = torch.exp(-s - m) * c * c + torch.exp(s - m) * sn * sn
    return -(m + torch.log(inner + _TINY))


def mixture_tan_transform(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Mean over mixture axis 1; x: (B,1,L,L), s: (B,M,L,L) -> (B,1,L,L)."""
    return tan_transform(x, s).mean(dim=1, keepdim=True)


def mixture_tan_transform_logJ(x: torch.Tensor,
                               s: torch.Tensor) -> torch.Tensor:
    """log d(mean_i h_{s_i})/dx via logsumexp -> (B, L, L)."""
    return (torch.logsumexp(tan_transform_logJ(x, s), dim=1)
            - math.log(s.shape[1]))


def rotated_mixture_transform(x: torch.Tensor, s: torch.Tensor,
                              r: torch.Tensor) -> torch.Tensor:
    """x: (B,1,L,L), s/r: (B,M,L,L) -> f(x): (B,L,L), unwrapped (the caller
    wraps after adding t)."""
    y = wrap_pi(x - r)
    return x[:, 0] + (tan_transform(y, s) - y).mean(dim=1)


def rotated_mixture_logJ(x: torch.Tensor, s: torch.Tensor,
                         r: torch.Tensor) -> torch.Tensor:
    """log f'(x) = log mean_i h'_{s_i}(y_i): (B, L, L)."""
    y = wrap_pi(x - r)
    return (torch.logsumexp(tan_transform_logJ(y, s), dim=1)
            - math.log(s.shape[1]))


class CouplingOut(NamedTuple):
    x: torch.Tensor      # transformed field
    logJ: torch.Tensor   # per-chain log-Jacobian, (B,)


def _clip_s(s: torch.Tensor, spec: FlowSpec) -> torch.Tensor:
    if spec.s_clip is None:
        return s
    c = spec.s_clip
    return c * torch.tanh(s / c)


def plaq_net_split(net_out: torch.Tensor, spec: FlowSpec):
    """Conditioner channel split and s_clip: (s, t) for ncp, (s, r, t) for
    rncp, (raw, t) for spline. A spline's s_clip bounds all 3K logits,
    c tanh(raw / c): the bin aspect ratio stays below e^{2c}, and with it
    the spline's slope and the FT-HMC force."""
    if spec.coupling == "rncp":
        M = spec.n_mixture
        s, r, t = net_out[:, :M], net_out[:, M:2 * M], net_out[:, 2 * M]
        return _clip_s(s, spec), r, t
    if spec.coupling == "ncp":
        s, t = net_out[:, :-1], net_out[:, -1]
        return _clip_s(s, spec), t
    if spec.coupling == "spline":
        K = spec.n_knots
        return _clip_s(net_out[:, :3 * K], spec), net_out[:, 3 * K]
    raise ValueError(f"unknown coupling {spec.coupling!r}")


_CONV_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def conditioner(net_params, frozen: torch.Tensor, plaq: torch.Tensor,
                spec: FlowSpec) -> torch.Tensor:
    """Raw conditioner output: the conv chain on stack(cos, sin) of the
    frozen plaquettes, (B, C_out, L, L), each conv in ``spec.conv_dtype``
    and the output in the field's dtype."""
    if spec.conv_dtype not in _CONV_DTYPES:
        raise ValueError(f"unknown conv_dtype {spec.conv_dtype!r}")
    return conv_net_apply(net_params, stack_cos_sin(frozen * plaq),
                          spec.activation, _CONV_DTYPES[spec.conv_dtype])


def plaq_transform_apply(net_out, plaq, active, spec: FlowSpec):
    """Active-plaquette transform from the raw conditioner output.
    Returns (fx1 (B,L,L) transform of the active plaquettes (pre-mask),
    local_logJ (B,L,L) active-masked, t (B,L,L) offset channel)."""
    x1 = (active * plaq)[:, None]
    if spec.coupling == "rncp":
        s, r, t = plaq_net_split(net_out, spec)
        local_logJ = active * rotated_mixture_logJ(x1, s, r)
        fx1 = rotated_mixture_transform(x1, s, r)
    elif spec.coupling == "ncp":
        s, t = plaq_net_split(net_out, spec)
        local_logJ = active * mixture_tan_transform_logJ(x1, s)
        fx1 = active * mixture_tan_transform(x1, s)[:, 0]
    else:
        raw, t = plaq_net_split(net_out, spec)
        fx1, logj = spline_forward(x1[:, 0], raw, spec.n_knots)
        local_logJ = active * logj
    return fx1, local_logJ, t


@lru_cache(maxsize=None)
def _masks(lat: tuple[int, int], mu: int, off: int, dtype: torch.dtype,
           device: torch.device):
    """(frozen, active, passive, active_links) of an (L0, L1) lattice as
    tensors on ``device``."""
    planes = plaq_masks(lat, mu, off) + (
        link_active_stripes((2, *lat), mu, off),)
    return tuple(torch.tensor(m, dtype=dtype, device=device)
                 for m in planes)


def _bisect_invert(y, transform, tol: float, max_iter: int):
    """Invert the monotone ``transform`` on (-pi, pi) by bisection, with the
    same tolerance early exit as the JAX while_loop (the error is the
    largest over the whole batch, checked once per halving)."""
    lo = torch.full_like(y, -PI)
    hi = torch.full_like(y, PI)
    i, err = 0, math.inf
    while i < max_iter and err >= tol:
        mid = 0.5 * (lo + hi)
        val = transform(mid)
        greater = (y > val).to(y.dtype)
        err = float((y - val).abs().max())
        lo = greater * mid + (1.0 - greater) * lo
        hi = (1.0 - greater) * mid + greater * hi
        i += 1
    return (0.5 * (lo + hi)).detach()


def _plaq_forward(net_out, plaq, masks, spec: FlowSpec) -> CouplingOut:
    """The plaquettes after a forward coupling, (B, L0, L1), and the
    per-chain logJ, from the raw conditioner output."""
    frozen, active, passive = masks
    fx1, local_logJ, t = plaq_transform_apply(net_out, plaq, active, spec)
    fx = active * wrap_pi(fx1 + t) + passive * plaq + frozen * plaq
    return CouplingOut(fx, local_logJ.sum(dim=(1, 2)))


def plaq_coupling_forward(net_params, plaq: torch.Tensor, mu: int, off: int,
                          spec: FlowSpec) -> CouplingOut:
    """Forward transform of the active plaquettes, plaq: (B, L0, L1), for
    any coupling family (``plaq_transform_apply`` dispatches on it)."""
    masks = _masks(tuple(plaq.shape[-2:]), mu, off, plaq.dtype,
                   plaq.device)[:3]
    return _plaq_forward(conditioner(net_params, masks[0], plaq, spec), plaq,
                         masks, spec)


# the forward body does not depend on the coupling family
rncp_plaq_coupling_forward = plaq_coupling_forward
spline_plaq_coupling_forward = plaq_coupling_forward
plaq_transform_forward = plaq_coupling_forward


def plaq_coupling_reverse(net_params, fplaq: torch.Tensor, mu: int, off: int,
                          spec: FlowSpec, tol: float = 1e-6,
                          max_iter: int = 1000) -> CouplingOut:
    """Inverse ncp transform (bisection on the masked mixture transform)."""
    frozen, active, passive, _ = _masks(tuple(fplaq.shape[-2:]), mu, off,
                                        fplaq.dtype, fplaq.device)
    s, t = plaq_net_split(conditioner(net_params, frozen, fplaq, spec), spec)
    y1 = wrap_pi(active * (fplaq - t))[:, None]
    x1 = _bisect_invert(y1, lambda x: active * mixture_tan_transform(x, s),
                        tol, max_iter)
    local_logJ = active * mixture_tan_transform_logJ(x1, s)
    logJ = -local_logJ.sum(dim=(1, 2))
    x = active * x1[:, 0] + passive * fplaq + frozen * fplaq
    return CouplingOut(x, logJ)


def rncp_plaq_coupling_reverse(net_params, fplaq: torch.Tensor, mu: int,
                               off: int, spec: FlowSpec, tol: float = 1e-6,
                               max_iter: int = 1000) -> CouplingOut:
    """Bisection inverse of the rotated-mixture transform. f maps (-pi, pi]
    onto [f(-pi), f(-pi) + 2pi); the target is lifted into that window
    before bisecting."""
    frozen, active, passive, _ = _masks(tuple(fplaq.shape[-2:]), mu, off,
                                        fplaq.dtype, fplaq.device)
    s, r, t = plaq_net_split(conditioner(net_params, frozen, fplaq, spec),
                             spec)
    y_t = wrap_pi(active * (fplaq - t))[:, None]
    f_lo = rotated_mixture_transform(
        torch.full_like(y_t, -PI + 1e-7), s, r)[:, None]
    y_adj = f_lo + torch.remainder(y_t - f_lo, TWO_PI)
    x1 = _bisect_invert(
        y_adj, lambda x: rotated_mixture_transform(x, s, r)[:, None],
        tol, max_iter)
    local_logJ = active * rotated_mixture_logJ(x1, s, r)
    logJ = -local_logJ.sum(dim=(1, 2))
    x = active * x1[:, 0] + passive * fplaq + frozen * fplaq
    return CouplingOut(x, logJ)


def spline_plaq_coupling_reverse(net_params, fplaq: torch.Tensor, mu: int,
                                 off: int, spec: FlowSpec, tol: float = 1e-6,
                                 max_iter: int = 1000) -> CouplingOut:
    """Analytic inverse of the spline coupling (no bisection; tol and
    max_iter are taken for the mixtures' signature and not used)."""
    del tol, max_iter
    frozen, active, passive, _ = _masks(tuple(fplaq.shape[-2:]), mu, off,
                                        fplaq.dtype, fplaq.device)
    raw, t = plaq_net_split(conditioner(net_params, frozen, fplaq, spec),
                            spec)
    x1, local_logJ = spline_inverse(wrap_pi(active * (fplaq - t)), raw,
                                    spec.n_knots)
    logJ = -(active * local_logJ).sum(dim=(1, 2))
    x = active * x1 + passive * fplaq + frozen * fplaq
    return CouplingOut(x, logJ)


def plaq_transform_reverse(net_params, fplaq, mu, off, spec: FlowSpec,
                           tol: float = 1e-6, max_iter: int = 1000):
    if spec.coupling == "spline":
        return spline_plaq_coupling_reverse(net_params, fplaq, mu, off, spec)
    if spec.coupling == "rncp":
        return rncp_plaq_coupling_reverse(net_params, fplaq, mu, off, spec,
                                          tol=tol, max_iter=max_iter)
    return plaq_coupling_reverse(net_params, fplaq, mu, off, spec,
                                 tol=tol, max_iter=max_iter)


def plaq_of_links(x: torch.Tensor) -> torch.Tensor:
    """Batched plaquette phase (B, 2, L, L) -> (B, L, L)."""
    return (x[:, 0] + torch.roll(x[:, 1], -1, dims=1)
            - torch.roll(x[:, 0], -1, dims=2) - x[:, 1])


def _apply_delta_links(x, delta_plaq, active_links):
    """Put a plaquette-angle change on the active links: the mu link gets
    +delta, the other channel of the stack -delta (it is masked out)."""
    delta_links = torch.stack((delta_plaq, -delta_plaq), dim=1)
    return active_links * wrap_pi(delta_links + x) + (1.0 - active_links) * x


def link_coupling_from_net_out(x: torch.Tensor, plaq: torch.Tensor,
                               net_out: torch.Tensor, mu: int, off: int,
                               spec: FlowSpec) -> CouplingOut:
    """The rest of a forward coupling once the conditioner has run: the
    active-plaquette transform, its logJ and the link update."""
    *masks, active_links = _masks(tuple(x.shape[-2:]), mu, off, x.dtype,
                                  x.device)
    new_plaq, logJ = _plaq_forward(net_out, plaq, masks, spec)
    return CouplingOut(_apply_delta_links(x, new_plaq - plaq, active_links),
                       logJ)


def link_coupling_forward(net_params, x: torch.Tensor, mu: int, off: int,
                          spec: FlowSpec) -> CouplingOut:
    """One forward gauge-equivariant coupling on links x: (B, 2, L, L)."""
    frozen = _masks(tuple(x.shape[-2:]), mu, off, x.dtype, x.device)[0]
    plaq = plaq_of_links(x)
    net_out = conditioner(net_params, frozen, plaq, spec)
    return link_coupling_from_net_out(x, plaq, net_out, mu, off, spec)


def link_coupling_reverse(net_params, fx: torch.Tensor, mu: int, off: int,
                          spec: FlowSpec, tol: float = 1e-6,
                          max_iter: int = 1000) -> CouplingOut:
    """Inverse of link_coupling_forward."""
    active_links = _masks(tuple(fx.shape[-2:]), mu, off, fx.dtype,
                          fx.device)[3]
    new_plaq = plaq_of_links(fx)
    plaq, logJ = plaq_transform_reverse(net_params, new_plaq, mu, off, spec,
                                        tol=tol, max_iter=max_iter)
    return CouplingOut(_apply_delta_links(fx, plaq - new_plaq, active_links),
                       logJ)
