"""The work each kernel and each step needs, counted from the shapes and the
coupling layers' stripe masks, whatever implements it; and the published
peaks of the card it is held against.

A frozen copy of the repository's counting helpers (``chip_smoke.py``:
``coupling_macs``, ``bounds``, ``traj_bounds`` with ``STEP_OPS``,
``ENERGY_OPS`` and ``DRAW_OPS``, ``PEAK_FP32_FLOPS``, ``PEAK_BYTES``), with
the lattice and chain count as arguments, and its own copy of the stripe
masks. Plain numpy: it imports nothing of the program.

A bound is the least time the card could take: the larger of bytes over
peak bandwidth (each input read once, each output written once) and
operations over the peak fp32 rate outside the tensor cores.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at its full 700 W power limit
PEAK_FP32_FLOPS = 67e12       # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3

# Operations a site of the trajectory kernels' bodies does, counting sinf,
# cosf and logf as 20 each and sqrtf as 4 (their range reduction and
# polynomial), and Philox's integer operations at the fp32 rate:
STEP_OPS = 35        # a step: plaquette 3, sinf 20, force 4, kick 4, drift 4
HALF_DRIFT_OPS = 8   # the two half drifts: 2 links x 2 ops x 2
ENERGY_OPS = 64      # 2 plaquettes 6, 2 cosf 40, 2 sums; kinetic 2 x 4;
                     # wrap and select 2 x 4
DRAW_OPS = 310       # 2 momenta x (Philox4x32-10 100, 2 uniforms 8, logf,
                     # sqrtf, cosf 44, 3 muls)
K1_OPS = 8           # the force a site: P, sin, 2 subs, 2 muls


def layer_mask_params(i: int) -> tuple[int, int]:
    """(mu, off) of coupling layer i."""
    return i % 2, (i // 2) % 4


def _stripes(shape, mu: int, off: int, cols) -> np.ndarray:
    m = np.zeros(shape, dtype=np.float32)
    for c in cols:
        if mu == 0:
            m[:, c::4] = 1.0
        else:
            m[c::4, :] = 1.0
    return np.roll(m, off, axis=1 - mu)


def plaq_masks(shape, mu: int, off: int):
    """(frozen, active, passive) plaquette masks of layer (mu, off):
    single active stripes at off, double frozen stripes at off + 1, period 4
    perpendicular to mu."""
    frozen = _stripes(shape, mu, off + 1, (0, 1))
    active = _stripes(shape, mu, off, (0,))
    return frozen, active, 1.0 - frozen - active


def _dilate(m: np.ndarray) -> np.ndarray:
    """Sites within one step (3x3, periodic) of a site of ``m``."""
    return np.logical_or.reduce([np.roll(m, (dy, dx), axis=(0, 1))
                                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def _taps(need: np.ndarray, nonzero: np.ndarray) -> int:
    """(site, tap) pairs of a periodic 3x3 conv whose output site is in
    ``need`` and whose input site is in ``nonzero``."""
    return sum(int((need & np.roll(nonzero, (dy, dx), axis=(0, 1))).sum())
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def coupling_macs(widths, mu: int, off: int, lat: int) -> dict:
    """Conv multiply-adds per chain that one coupling layer's outputs depend
    on, from its stripe masks. Forward (K6, K7): the raw conditioner output
    is read on the active stripe only, each earlier conv's output where the
    next conv reads it (one site further out) and, for K7, also where K8
    reads it as an activation gate. K8: cotangents enter the transposed
    chain on the active stripe and spread one site a conv; the chain's
    result is read on the frozen stripe."""
    frozen, active, _ = (m.astype(bool) for m in plaq_masks((lat, lat), mu,
                                                            off))
    n = len(widths) - 1
    need_in = [frozen]          # where conv l's input cotangent is read
    for _ in range(1, n):
        need_in.append(_dilate(need_in[-1]))
    nz_out = [active] * n       # where conv l's output cotangent may be != 0
    for li in range(n - 2, -1, -1):
        nz_out[li] = _dilate(nz_out[li + 1])
    k6, k7 = [active] * n, [active] * n     # where conv l's output is read
    for li in range(n - 2, -1, -1):
        k6[li] = _dilate(k6[li + 1])
        k7[li] = _dilate(k7[li + 1]) | (need_in[li + 1] & nz_out[li])
    cc = [widths[li] * widths[li + 1] for li in range(n)]
    return {"K6": sum(c * 9 * int(m.sum()) for c, m in zip(cc, k6)),
            "K7": sum(c * 9 * int(m.sum()) for c, m in zip(cc, k7)),
            "K8": sum(c * _taps(need_in[li], nz_out[li])
                      for li, c in enumerate(cc))}


def bound(nbytes: float, flops: float) -> dict:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "bytes": nbytes, "flops": flops}


def flow_widths(hidden_sizes, out_channels: int) -> list[int]:
    """Channel widths of a conditioner: 2 in, the hidden sizes, the
    output."""
    return [2, *hidden_sizes, out_channels]


def layer_param_count(widths, kernel_size: int = 3) -> int:
    """Weights and biases of one conditioner."""
    return sum(ci * co * kernel_size * kernel_size + co
               for ci, co in zip(widths[:-1], widths[1:]))


def coupling_bounds(widths, mu: int, off: int, B: int, L: int) -> dict:
    """Least time (ms) of K1, K6, K7 and K8 for B chains of L^2 sites on
    coupling layer (mu, off). The coupling kernels' flops are the conv
    multiply-adds (2 flops each) their outputs depend on; their elementwise
    transform work is not counted."""
    sites = B * L * L
    field = 4 * 2 * sites                      # one (B, 2, L, L) fp32 field
    macs = coupling_macs(widths, mu, off, L)
    resid = 4 * sites * sum(widths[1:])
    weights = 4 * layer_param_count(widths)
    work = {
        "K1": (2 * field, K1_OPS * sites),
        "K6": (2 * field + weights + 4 * B, 2 * B * macs["K6"]),
        "K7": (2 * field + weights + 4 * B + resid, 2 * B * macs["K7"]),
        "K8": (3 * field + weights + 4 * B + resid, 2 * B * macs["K8"]),
    }
    return {k: bound(nbytes, flops) for k, (nbytes, flops) in work.items()}


def traj_bounds(B: int, L: int, nstep: int) -> dict:
    """Least time (ms) of the trajectory kernels for B chains of L^2 sites
    over nstep leapfrog steps. K2 and K3 integrate (x, v in; x', v' out);
    K4 is the whole plain step: momentum draw, the steps, both energies and
    the accept (x, seed in; x', dh, acc out); K5 the same with the draws
    given."""
    sites = B * L * L
    field = 4 * 2 * sites
    lf = sites * (STEP_OPS * nstep + HALF_DRIFT_OPS)
    work = {"K2": (4 * field, lf),
            "K3": (4 * field, lf),
            "K4": (2 * field + 4 + 8 * B,
                   lf + sites * (ENERGY_OPS + DRAW_OPS)),
            "K5": (3 * field + 12 * B, lf + sites * ENERGY_OPS)}
    return {k: bound(nbytes, flops) for k, (nbytes, flops) in work.items()}


def flow_layer_bounds(widths, n_layers: int, B: int, L: int) -> dict:
    """Each coupling kernel's bound summed over the flow's layers (ms): the
    least time of one K6 flow, one K7 pass and one K8 pass; and K1's."""
    total = {"K6": 0.0, "K7": 0.0, "K8": 0.0}
    flops = {"K6": 0.0, "K7": 0.0, "K8": 0.0}
    for i in range(n_layers):
        mu, off = layer_mask_params(i)
        b = coupling_bounds(widths, mu, off, B, L)
        for k in total:
            total[k] += b[k]["bound_ms"]
            flops[k] += b[k]["flops"]
    k1 = coupling_bounds(widths, 0, 0, B, L)["K1"]
    return {"bound_ms": total, "flops": flops, "K1": k1}


def ft_traj_flops(widths, n_layers: int, B: int, L: int, nstep: int) -> float:
    """The conv flops an FT-HMC trajectory of the Omelyan integrator needs:
    two energy flows at K6's count and 2 nstep + 1 forces, each one K7 and
    one K8 pass over every layer and one K1."""
    fl = flow_layer_bounds(widths, n_layers, B, L)
    forces = 2 * nstep + 1
    return (2 * fl["flops"]["K6"]
            + forces * (fl["flops"]["K7"] + fl["flops"]["K8"]
                        + fl["K1"]["flops"]))


def plain_traj_ops(B: int, L: int, nstep: int) -> float:
    """The operations a whole plain-HMC step needs (draw, nstep leapfrog
    steps, both energies, the accept): the K4 row's operations."""
    return traj_bounds(B, L, nstep)["K4"]["flops"]
