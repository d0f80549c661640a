"""The gauge-equivariant flow of FT-HMC, plain torch, the reference's own.

A flow is a stack of coupling layers; layer i acts with mu = i % 2 and
off = (i // 2) % 4 on stripe masks of period 4 perpendicular to mu
(active plaquettes at off, frozen at off + 1 and off + 2, the rest
passive; active links the mu links of the active stripe). A layer:

    P        = plaquette phases of the links
    c        = conv chain (3x3, periodic, activation between convs) on
               (cos, sin) of the frozen plaquettes
    s, r, t  = c's channels [0, M), [M, 2M), 2M; s -> s_clip tanh(s/s_clip)
    h_s(y)   = 2 atan2(e^s sin(y/2), cos(y/2))  (wrapped)
    f(P)     = P + mean_i [h_{s_i}(y_i) - y_i],  y_i = wrap(P - r_i)
    P'       = wrap(f(P) + t) on active plaquettes, P elsewhere
    log J    = sum_active logsumexp_i log h'_{s_i}(y_i) - log M,
               log h'_s(y) = -log(e^-s cos^2(y/2) + e^s sin^2(y/2))
    links    : the active mu links move by P' - P (wrapped)

(the rotated non-compact projection of arXiv:2112.01586 with the
repository's s clip). The weights are read from an ``.npz`` with numpy.
A conv is a matrix product of the weights with the field's 3x3
neighbourhoods (periodic padding, ``unfold``), which runs float64 on the
card's fp64 tensor cores; TF32 stays off unless the caller asks for it (the
lower-precision control).
"""
from __future__ import annotations

import contextlib
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.counts.work import layer_mask_params, plaq_masks
from benchmark.reference.lattice import plaq_phase, wrap

ACTIVATIONS = {"silu": F.silu, "relu": F.relu, "tanh": torch.tanh}


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN's TF32 for the convs on (the control) or off (the reference)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def load_npz(path: Path, n_layers: int, n_convs: int) -> list:
    """Layers of {'w': (Cout, Cin, 3, 3), 'b': (Cout,)} numpy arrays, as the
    exported flows name them (``l<layer>_c<conv>_<w|b>``)."""
    with np.load(path) as data:
        return [[{leaf: np.array(data[f"l{i:02d}_c{j}_{leaf}"])
                  for leaf in ("w", "b")} for j in range(n_convs)]
                for i in range(n_layers)]


def conv3x3(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Periodic 3x3 cross-correlation plus bias: h (B, C, L0, L1), w (O, C,
    3, 3) -> (B, O, L0, L1)."""
    B, _, L0, L1 = h.shape
    cols = F.unfold(F.pad(h, (1, 1, 1, 1), mode="circular"), 3)
    y = w.reshape(w.shape[0], -1) @ cols
    return y.reshape(B, -1, L0, L1) + b[None, :, None, None]


class Flow:
    """The flow of ``spec`` (n_layers, n_mixture, hidden_sizes, activation,
    s_clip) with the weights of ``npz``, in ``dtype`` on ``device``."""

    def __init__(self, spec: dict, npz: Path, dtype, device,
                 allow_tf32: bool = False):
        self.n_layers, self.M = spec["n_layers"], spec["n_mixture"]
        self.act = ACTIVATIONS[spec["activation"]]
        self.s_clip = spec["s_clip"]
        self.allow_tf32 = allow_tf32
        tree = load_npz(npz, self.n_layers, len(spec["hidden_sizes"]) + 1)
        self.layers = [[{k: torch.tensor(v, dtype=dtype, device=device)
                         for k, v in conv.items()} for conv in layer]
                       for layer in tree]
        self.dtype, self.device = dtype, device
        self._masks = {}

    def masks(self, L: int, i: int):
        """(frozen, active, passive, active links) of layer i at L^2."""
        key = (L, i)
        if key not in self._masks:
            mu, off = layer_mask_params(i)
            fr, ac, pa = plaq_masks((L, L), mu, off)
            # the mu links of the active stripe
            links = np.zeros((2, L, L), dtype=np.float32)
            if mu == 0:
                links[0, :, 0::4] = 1.0
                links = np.roll(links, off, axis=2)
            else:
                links[1, 0::4, :] = 1.0
                links = np.roll(links, off, axis=1)
            self._masks[key] = tuple(
                torch.tensor(m, dtype=self.dtype, device=self.device)
                for m in (fr, ac, pa, links))
        return self._masks[key]

    def conditioner(self, layer, h: torch.Tensor) -> torch.Tensor:
        with tf32(self.allow_tf32):
            for j, conv in enumerate(layer):
                if j:
                    h = self.act(h)
                h = conv3x3(h, conv["w"], conv["b"])
        return h

    def layer(self, i: int, x: torch.Tensor):
        """One coupling layer: (links', log J per chain)."""
        frozen, active, passive, links = self.masks(x.shape[-1], i)
        plaq = plaq_phase(x)
        fp = frozen * plaq
        out = self.conditioner(self.layers[i],
                               torch.stack((torch.cos(fp), torch.sin(fp)),
                                           dim=1))
        M, c = self.M, self.s_clip
        s = c * torch.tanh(out[:, :M] / c)
        r, t = out[:, M:2 * M], out[:, 2 * M]
        x1 = (active * plaq)[:, None]
        y = wrap(x1 - r)
        h = wrap(2.0 * torch.atan2(torch.exp(torch.clamp(s, -30.0, 30.0))
                                   * torch.sin(0.5 * y), torch.cos(0.5 * y)))
        fx1 = x1[:, 0] + (h - y).mean(dim=1)
        cy, sy = torch.cos(0.5 * y), torch.sin(0.5 * y)
        m = s.abs().detach()
        logd = -(m + torch.log(torch.exp(-s - m) * cy * cy
                               + torch.exp(s - m) * sy * sy + 1e-30))
        logj = active * (torch.logsumexp(logd, dim=1) - math.log(M))
        new = active * wrap(fx1 + t) + (passive + frozen) * plaq
        delta = new - plaq
        moved = wrap(torch.stack((delta, -delta), dim=1) + x)
        return links * moved + (1.0 - links) * x, logj.sum(dim=(1, 2))

    def forward(self, x: torch.Tensor):
        """(f(x), log det df/dx per chain)."""
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(self.n_layers):
            x, lj = self.layer(i, x)
            logdet = logdet + lj
        return x, logdet
