"""Circular rational-quadratic-spline plaquette transform.

Counterpart of ``fthmc_tpu/models/spline.py``. The active plaquette angles
go through a monotone circle diffeomorphism built from a K-bin
rational-quadratic spline (Durkan et al., arXiv:1906.04032, Appendix A)
with matching end derivatives (Rezende et al., arXiv:2002.02428), then the
same additive phase shift t as the mixture layers. Its inverse is analytic
(one quadratic a site).

Parameterization a site, from the conditioner's 3K+1 channels: K bin
widths (softmax), K bin heights (softmax), K knot derivatives (shifted
softplus, the derivative at knot K equal to knot 0's), and t. A zero
conditioner output is exactly the identity (uniform bins, unit
derivatives, t = 0).

Angles x are (B, L, L) in [-pi, pi); parameter maps keep the knot axis at
axis 1, (B, K, L, L).
"""
from __future__ import annotations

import math

import torch

__all__ = ["spline_knots", "spline_forward", "spline_inverse",
           "spline_out_channels"]

PI = math.pi
TWO_PI = 2.0 * math.pi

_MIN_BIN = 1e-3     # least bin width and height (keeps the map invertible)
_MIN_DERIV = 1e-4   # floor on the knot derivatives
# softplus(_D_SHIFT) + _MIN_DERIV == 1: a zero raw input gives a unit
# derivative (the identity spline, with uniform bins).
_D_SHIFT = math.log(math.expm1(1.0 - _MIN_DERIV))


def spline_out_channels(n_knots: int) -> int:
    """Conditioner output channels of a K-knot circular spline (+1 for the
    phase shift t)."""
    return 3 * n_knots + 1


def spline_knots(raw: torch.Tensor, n_knots: int):
    """Raw conditioner channels (B, 3K, L, L) -> (cum_w, cum_h, w, h, d):
    cum_w, cum_h (B, K+1, L, L) knot positions in [0, 1] with exact 0 and 1
    ends; w, h (B, K, L, L) bin widths and heights; d (B, K+1, L, L) knot
    derivatives with d[K] == d[0]."""
    K = n_knots
    wl, hl, dl = raw[:, :K], raw[:, K:2 * K], raw[:, 2 * K:3 * K]
    scale = 1.0 - K * _MIN_BIN
    w = torch.softmax(wl, dim=1) * scale + _MIN_BIN
    h = torch.softmax(hl, dim=1) * scale + _MIN_BIN
    # softplus as log(1 + e^x) everywhere (torch's F.softplus returns x
    # itself above 20)
    dl = dl + _D_SHIFT
    d = torch.logaddexp(dl, torch.zeros_like(dl)) + _MIN_DERIV
    d = torch.cat([d, d[:, :1]], dim=1)

    def cum(b):
        c = torch.cumsum(b, dim=1)
        # the last knot lands exactly on 1 (the cumsum rounds)
        return torch.cat([torch.zeros_like(c[:, :1]), c[:, :-1],
                          torch.ones_like(c[:, :1])], dim=1)

    return cum(w), cum(h), w, h, d


def _select_bin(cum: torch.Tensor, u: torch.Tensor, K: int) -> torch.Tensor:
    """One-hot bin membership, cum[k] <= u < cum[k+1] (a point on a knot
    goes to the bin above it). cum: (B, K+1, L, L), u: (B, L, L) in [0, 1).
    Returns (B, K, L, L) in u's dtype."""
    uu = u[:, None]
    return ((uu >= cum[:, :K]) & (uu < cum[:, 1:])).to(u.dtype)


def _gather(onehot: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """A site's bin value: the sum over the knot axis of onehot * arr."""
    return (onehot * arr).sum(dim=1)


def _bin_params(oh, cw, ch, w, h, d, K):
    return (_gather(oh, cw[:, :K]), _gather(oh, ch[:, :K]), _gather(oh, w),
            _gather(oh, h), _gather(oh, d[:, :K]), _gather(oh, d[:, 1:]))


def _log_deriv(s, xi, xi1m, d0, d1, denom):
    """log g' = 2 log s + log(d1 xi^2 + 2 s xi(1-xi) + d0 (1-xi)^2)
    - 2 log denom, xi1m = xi(1-xi)."""
    numer = d1 * xi * xi + 2.0 * s * xi1m + d0 * (1.0 - xi) ** 2
    return 2.0 * torch.log(s) + torch.log(numer) - 2.0 * torch.log(denom)


def spline_forward(x: torch.Tensor, raw: torch.Tensor, n_knots: int):
    """Forward circular RQ spline. x: (B, L, L) angles; raw: (B, 3K, L, L).
    Returns (y in [-pi, pi), logJ), logJ the per-site log |dy/dx|."""
    K = n_knots
    cw, ch, w, h, d = spline_knots(raw, K)
    # plaquette angles are sums of four links: wrap first (derivative 1)
    xw = torch.remainder(x + PI, TWO_PI) - PI
    u = torch.clamp((xw + PI) / TWO_PI, 0.0, 1.0 - 1e-6)
    u0, y0, wb, hb, d0, d1 = _bin_params(_select_bin(cw, u, K), cw, ch, w, h,
                                         d, K)
    s = hb / wb
    xi = (u - u0) / wb
    xi1m = xi * (1.0 - xi)
    denom = s + (d1 + d0 - 2.0 * s) * xi1m
    v = y0 + hb * (s * xi * xi + d0 * xi1m) / denom
    return TWO_PI * v - PI, _log_deriv(s, xi, xi1m, d0, d1, denom)


def spline_inverse(y: torch.Tensor, raw: torch.Tensor, n_knots: int):
    """Analytic inverse of spline_forward (a quadratic a site; Durkan et
    al. eq. 29-31). Returns (x, logJ_fwd(x)); the caller negates logJ."""
    K = n_knots
    cw, ch, w, h, d = spline_knots(raw, K)
    yw = torch.remainder(y + PI, TWO_PI) - PI
    v = torch.clamp((yw + PI) / TWO_PI, 0.0, 1.0 - 1e-6)
    u0, y0, wb, hb, d0, d1 = _bin_params(_select_bin(ch, v, K), cw, ch, w, h,
                                         d, K)
    s = hb / wb
    t = v - y0
    q = d1 + d0 - 2.0 * s
    a = hb * (s - d0) + t * q
    b = hb * d0 - t * q
    c = -s * t
    # the stable root in [0, 1]: xi = 2c / (-b - sqrt(b^2 - 4ac))
    disc = b * b - 4.0 * a * c
    xi = (2.0 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
    xi = torch.clamp(xi, 0.0, 1.0)
    x = TWO_PI * (u0 + xi * wb) - PI
    xi1m = xi * (1.0 - xi)
    return x, _log_deriv(s, xi, xi1m, d0, d1, s + q * xi1m)
