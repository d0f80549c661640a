"""The lattice kernels K1-K5 and K12 and their plain PyTorch twins: the
counterpart of ``fthmc_tpu/ops/pallas_lattice.py``.

  K1 ``force``             csrc/force.cu     <- _force_kernel (pallas_force)
  K2 ``leapfrog``          csrc/leapfrog.cu  <- _leapfrog_kernel
                                                (pallas_leapfrog)
  K3 ``leapfrog_cl``       csrc/leapfrog.cu  <- _leapfrog_cl_kernel
                                                (pallas_leapfrog_cl)
  K4 ``hmc_traj``          csrc/hmc_traj.cu  <- _hmc_traj_kernel
                                                (pallas_hmc_traj)
  K5 ``hmc_traj_hostrng``  csrc/hmc_traj.cu  <- _hmc_traj_hostrng_kernel
                                                (pallas_hmc_traj_hostrng)
  K12 ``hmc_epilogue``     csrc/hmc_traj.cu  <- none: XLA's fusion of
                                                fthmc_tpu/hmc.py:195-212

A CPU tensor takes the plain twin (``*_plain``, same signature); a CUDA
tensor launches the kernel, or raises for what the kernel does not take. K1
is a band of rows of one chain a CTA, each thread a column and a run of
rows (``force_plan``), bounded by bytes. K2-K5 run the band body of
csrc/traj_common.cuh: a cluster of C row bands a chain (K3: a tile of
chains, the chain the fastest thread index), each thread keeping its S
sites' links and momenta in registers for the whole trajectory, under the
plan ``traj_plan`` picks; they are bounded by operations. K12, the plain
step's epilogue after K2, K3 or the K1 loop, takes K2's band geometry up to
``traj_reach`` and above it a thread a column in EPILOGUE_WIDE_BANDS bands
a chain; it is bounded by bytes. Their envelope on the card: fp32, (B, 2,
L, L), any B; K1 and K12 2 <= L <= 1024 (a thread a column:
``FORCE_MAX_L``), K2-K5 2 <= L <= 256 (``traj_reach``; eight bands of 32
rows, 512 threads of 16 sites).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import torch

from fthmc_tpu_torch.ops import _build, rng

__all__ = ["force", "force_plain", "leapfrog", "leapfrog_plain",
           "leapfrog_cl", "leapfrog_cl_plain", "hmc_traj", "hmc_traj_plain",
           "hmc_traj_hostrng", "hmc_traj_hostrng_plain", "hmc_epilogue",
           "hmc_epilogue_plain", "dh_tolerance", "epilogue_dh_tolerance",
           "ForcePlan", "force_plan", "force_plans", "force_plan_of",
           "force_smem_bytes_of", "FORCE_MAX_L", "TrajPlan", "traj_plan",
           "traj_plans", "traj_plan_of", "traj_reach", "traj_smem_bytes_of"]


# ---------------------------------------------------------------------------
# plain twins: the kernels' arithmetic, op for op, in torch
# ---------------------------------------------------------------------------

def _plaq_of(x: torch.Tensor, chains_last: bool = False) -> torch.Tensor:
    """P = x0 + x1(i+1) - x0(j+1) - x1 of (B, 2, L, L) links, or of
    chains-last (2, L, L, B) ones."""
    if chains_last:
        x0, x1, rows, cols = x[0], x[1], 0, 1
    else:
        x0, x1, rows, cols = x[:, 0], x[:, 1], 1, 2
    return (x0 + torch.roll(x1, -1, dims=rows) - torch.roll(x0, -1, dims=cols)
            - x1)


def _force_of(x: torch.Tensor, beta: float,
              chains_last: bool = False) -> torch.Tensor:
    """F0 = beta (sin P - sin P(j-1)), F1 = beta (sin P(i-1) - sin P)."""
    rows, cols, dim = (0, 1, 0) if chains_last else (1, 2, 1)
    sp = torch.sin(_plaq_of(x, chains_last))
    f0 = sp - torch.roll(sp, 1, dims=cols)
    f1 = torch.roll(sp, 1, dims=rows) - sp
    return beta * torch.stack((f0, f1), dim=dim)


def _leapfrog_of(x, v, beta, dt, nstep, chains_last=False):
    """Half drift, nstep x (kick, drift), trailing half drift undone."""
    x = x + (0.5 * dt) * v
    for _ in range(nstep):
        v = v - dt * _force_of(x, beta, chains_last)
        x = x + dt * v
    return x - (0.5 * dt) * v, v


def _hmc_traj_of(x0, v0, u, beta, dt, nstep):
    """Trajectory, delta-form dH, Metropolis and wrap (``_hmc_traj_body``):
    (x_new, dh, acc) with acc in x0's dtype."""
    cos0 = torch.cos(_plaq_of(x0))
    x1, v1 = _leapfrog_of(x0, v0, beta, dt, nstep)
    dsw = (torch.cos(_plaq_of(x1)) - cos0).sum(dim=(1, 2))
    dk = ((v1 - v0) * (v1 + v0)).sum(dim=(1, 2, 3))
    dh = -beta * dsw + 0.5 * dk
    acc = u < torch.exp(-dh)
    x1w = torch.remainder(x1 + math.pi, 2.0 * math.pi) - math.pi
    return (torch.where(acc[:, None, None, None], x1w, x0), dh,
            acc.to(x0.dtype))


def dh_tolerance(x0, v0, beta, dt, nstep) -> torch.Tensor:
    """Per chain, how far two fp32 computations of the same trajectory's dH
    may lie apart: 2^-19 (32 units of fp32 roundoff) times
    beta sum|cos P1 - cos P0| + beta sum|sin P1| + 1/2 sum|(v1 - v0)(v1 +
    v0)|, on the twin's (x1, v1). The first and last terms bound summing
    the same per-site terms in two orders (each order errs by at most its
    depth, under 32 here, times 2^-24 times the sum of magnitudes); the
    middle one the cos P1 of wrapped links (hmc_step's 'xla' path), which
    moves each plaquette by at most 4 roundings of 2pi-sized angles, under
    2^-19."""
    x1, v1 = _leapfrog_of(x0, v0, beta, dt, nstep)
    p1 = _plaq_of(x1)
    mags = (beta * (torch.cos(p1) - torch.cos(_plaq_of(x0))).abs().sum((1, 2))
            + beta * torch.sin(p1).abs().sum((1, 2))
            + 0.5 * ((v1 - v0) * (v1 + v0)).abs().sum((1, 2, 3)))
    return mags * 2.0 ** -19


def force_plain(x: torch.Tensor, beta: float) -> torch.Tensor:
    """K1's twin: F = beta * (sin P - shifted sin P), (B, 2, L, L)."""
    _build.PLAIN_CALLS["K1"] += 1
    return _force_of(x, beta)


def leapfrog_plain(x, v, beta, dt, nstep):
    """K2's twin: the trajectory as ``hmc.leapfrog`` runs it with this
    force."""
    _build.PLAIN_CALLS["K2"] += 1
    return _leapfrog_of(x, v, beta, dt, nstep)


def leapfrog_cl_plain(x, v, beta, dt, nstep):
    """K3's twin: the same trajectory on chains-last (2, L, L, B) views."""
    _build.PLAIN_CALLS["K3"] += 1
    xt, vt = _leapfrog_of(x.permute(1, 2, 3, 0), v.permute(1, 2, 3, 0),
                          beta, dt, nstep, chains_last=True)
    return xt.permute(3, 0, 1, 2), vt.permute(3, 0, 1, 2)


def hmc_traj_plain(x, seed, beta, dt, nstep):
    """K4's twin: K5's arithmetic on the Philox draws of ``ops/rng.py``."""
    _build.PLAIN_CALLS["K4"] += 1
    B, _, L, _ = x.shape
    v0 = rng.momenta(seed, B, L, x.dtype, x.device)
    u = rng.accept_uniforms(seed, B, x.dtype, x.device)
    return _hmc_traj_of(x, v0, u, beta, dt, nstep)


def hmc_traj_hostrng_plain(x, v0, u, beta, dt, nstep):
    """K5's twin."""
    _build.PLAIN_CALLS["K5"] += 1
    return _hmc_traj_of(x, v0, u, beta, dt, nstep)


def hmc_epilogue_plain(x, x1, v1, v0, u, q_old, beta):
    """K12's twin: the plain step after its trajectory, ``lattice.wrap``,
    ``delta_action`` + ``hmc._kinetic_delta``, ``hmc._metropolis``'s accept
    on the given uniforms and ``hmc._metrics``. Returns (x_new, the (6, B)
    rows of hmc.TrajMetrics' fields)."""
    from fthmc_tpu_torch import hmc, lattice   # both import this module
    _build.PLAIN_CALLS["K12"] += 1
    x1 = lattice.wrap(x1)
    dh = lattice.delta_action(x1, x, beta) + hmc._kinetic_delta(v1, v0)
    exp_mdh = torch.exp(-dh)
    acc = u < exp_mdh
    x_new = torch.where(acc[:, None, None, None], x1, x)
    return x_new, torch.stack(hmc._metrics(dh, exp_mdh, acc, x_new, q_old))


def epilogue_dh_tolerance(x, x1, v1, v0, beta) -> torch.Tensor:
    """Per chain, how far K12's fp32 dH may lie from its twin's in float64
    on the same fp32 inputs: 2^-19 (32 units of fp32 roundoff) times beta
    sum|cos P1 - cos P0| + beta sum(|sin P0| + |sin P1|) + 1/2 sum|(v1 -
    v0)(v1 + v0)|, dH's scale in dh_tolerance with both fields' plaquettes
    (K12 computes both in fp32). The first and last terms bound the sums'
    order (each errs by at most its depth, under 32, times 2^-24 times the
    sum of magnitudes); the middle one each plaquette's three fp32
    roundings of pi-sized sums and the fp32 wrap's shift of x1's links,
    under 2^-19 an angle."""
    x, x1, v1, v0 = (t.double() for t in (x, x1, v1, v0))
    p0 = _plaq_of(x)
    p1 = _plaq_of(torch.remainder(x1 + math.pi, 2 * math.pi) - math.pi)
    mags = (beta * (p1.cos() - p0.cos()).abs().sum((1, 2))
            + beta * (p0.sin().abs() + p1.sin().abs()).sum((1, 2))
            + 0.5 * ((v1 - v0) * (v1 + v0)).abs().sum((1, 2, 3)))
    return mags * 2.0 ** -19


# ---------------------------------------------------------------------------
# the band plan of K1 (csrc/force.cu)
# ---------------------------------------------------------------------------

FORCE_MAX_L = 1024       # a thread a column, at most 1024 threads a CTA
FORCE_SITES = (1, 2, 4, 8)   # sites a thread: the kernel's instances
# the plan's sites a thread and threads a CTA: the fastest or within 2% of
# it at FT's, path A's, path B's and the headline's shapes in a sweep on an
# H100; at 16^2, where a launch takes ~0.002 ms, the plans differ by less
# than the spread between runs (PERF.md section 6, K1's row of the
# kernel table)
FORCE_SITES_PREFERRED = 2
FORCE_THREADS = 256


class ForcePlan(NamedTuple):
    """Bands of ``rows`` rows a chain (the last one shorter where rows does
    not divide L), a CTA each, of ``threads`` threads of ``sites`` sites (a
    column and a run of rows)."""
    rows: int
    threads: int
    sites: int


def force_plan_of(L: int, rows: int, sites: int) -> ForcePlan | None:
    """The plan of bands of ``rows`` rows and ``sites`` sites a thread at
    L, or None where K1 cannot take it (more than 1024 threads a CTA)."""
    if not 2 <= L <= FORCE_MAX_L or not 1 <= rows <= L \
            or sites not in FORCE_SITES:
        return None
    threads = -(-rows // sites) * L
    if threads > FORCE_MAX_L:
        return None
    return ForcePlan(rows, threads, sites)


def force_smem_bytes_of(L: int, plan: ForcePlan) -> int:
    """Shared-memory bytes of a K1 CTA: x0 of the band's rows and sin P of
    the halo row and the band's rows, as ``force_smem_bytes``
    (csrc/force.cu) counts them (a card test holds the two equal)."""
    return 4 * (2 * plan.rows + 1) * L


def force_plans(L: int) -> list[ForcePlan]:
    """Every plan of power-of-two rows (and all L rows) and of sites up to
    the rows a band has, rounded up to a power of two, at L: what the plan
    sweep times and the tests run."""
    rows = sorted({1 << e for e in range(L.bit_length()) if 1 << e < L}
                  | {L})
    out = []
    for r in rows:
        for sites in FORCE_SITES:
            plan = force_plan_of(L, r, sites)
            if plan is not None and sites < 2 * r:
                out.append(plan)
    return out


@lru_cache(maxsize=None)
def force_plan(L: int) -> ForcePlan:
    """The plan K1 runs an L^2 lattice under, whatever the chain count:
    FORCE_SITES_PREFERRED sites a thread, bands of as many rows as
    FORCE_THREADS threads hold (at least a run a column, at most L). On an
    H100 a grid under the SM count was no slower where it saved halo rows
    (16^2 x 64 chains: one band a chain 0.0020 ms, 4 bands 0.0021; PERF.md
    section 6). Raises above FORCE_MAX_L."""
    if not 2 <= L <= FORCE_MAX_L:
        raise ValueError(f"K1 takes 2 <= L <= {FORCE_MAX_L} (a thread a "
                         f"column, at most {FORCE_MAX_L} threads a CTA), "
                         f"got L={L}")
    sites = FORCE_SITES_PREFERRED
    return force_plan_of(L, min(L, sites * max(1, FORCE_THREADS // L)),
                         sites)


# ---------------------------------------------------------------------------
# the band plan of K2-K5 (csrc/traj_common.cuh)
# ---------------------------------------------------------------------------

MAX_BANDS = 8            # bands a chain: the portable cluster (common.cuh)
TRAJ_SITES = (1, 2, 4, 8, 16)   # sites a thread: the kernels' instances
# sites a thread each kernel's plan starts from: the fastest on an H100
# (PERF.md, the plan sweep; K4/K5 at 8 sites hold 128 registers a thread;
# K12 0.080 ms at 16 sites against 0.091 at 8, 64^2 x 1024, and 0.035
# against 0.036 at 128^2 x 64, by CUDA graphs)
SITES_PREFERRED = {"K2": 8, "K3": 4, "K4": 4, "K5": 4, "K12": 16}
MIN_BAND_ROWS = 8        # bands added to fill the card keep this many rows
EPILOGUE_SUMS = 6        # K12's sums a chain (EPI_SUMS, csrc/hmc_traj.cu)
# K12 above traj_reach: bands a chain, a thread a column (csrc/hmc_traj.cu,
# epilogue_wide_kernel)
EPILOGUE_WIDE_BANDS = MAX_BANDS
KINDS = {"K2": 0, "K3": 0, "K4": 1, "K5": 2}   # the smem count's kinds
# chains a K3 tile, and the threads a CTA its sites a thread keep: tiles
# of 2 with the most sites (up to 4) that keep 128 threads made plans
# within 14% of the fastest at 8^2-32^2 x 1024 chains on an H100, one CTA
# a tile beating any cluster (PERF.md section 6, K3's row of the kernel
# table)
K3_TILE = 2
K3_MIN_THREADS = 128
K3_TILES = (2, 4, 8, 16, 32)   # the tiles K3's plan sweep tries


class TrajPlan(NamedTuple):
    """C bands a group, CTA r owning rows [row0[r], row0[r + 1]); each CTA
    ``threads`` threads of ``sites`` sites (a chain of the tile, a column
    and a run of rows); a group is one chain (K2, K4, K5) or a tile of
    ``tile`` chains (K3)."""
    C: int
    row0: tuple
    threads: int
    sites: int
    tile: int = 1

    @property
    def rows(self) -> int:
        """Rows of the largest band."""
        return max(b - a for a, b in zip(self.row0, self.row0[1:]))


def max_threads(sites: int) -> int:
    """Threads a CTA at most: the kernels' launch bounds, which cap a
    thread's registers at 65536 / this (``traj_max_threads``)."""
    return 512 if sites >= 8 else 1024


def traj_plan_of(L: int, C: int, sites: int,
                 tile: int = 1) -> TrajPlan | None:
    """The plan of C even bands (differing by at most a row), ``sites``
    sites a thread and tiles of ``tile`` chains at L, or None where the
    kernels cannot take it: a column's runs of the largest band would need
    more threads than the launch bounds allow."""
    if L < 2 or not 1 <= C <= min(MAX_BANDS, L) or sites not in TRAJ_SITES \
            or tile < 1:
        return None
    row0 = tuple(r * L // C for r in range(C + 1))
    rows = -(-L // C)
    threads = -(-rows // sites) * L * tile
    if threads > max_threads(sites):
        return None
    return TrajPlan(C, row0, threads, sites, tile)


def traj_smem_bytes_of(L: int, plan: TrajPlan, kernel: str) -> int:
    """Shared-memory bytes a CTA of ``kernel`` ('K2'-'K5', 'K12') takes
    under ``plan``: the layout of ``band_smem`` (csrc/traj_common.cuh) or
    ``epilogue_smem`` (K12, csrc/hmc_traj.cu), which the card tests hold
    equal to the library's own count. x0 and sin P of the band's rows (of
    each chain of the tile), x1 of each run's first row; K4/K5 cos P0 and
    the dH tree; K4 its drawn momenta. K12: x0 of the band's rows, x1 of
    each run's first row, the warps' six sums and the CTA's."""
    rl, t = plan.rows * L, plan.threads
    if kernel == "K12":
        return 4 * (rl + t + 33 * EPILOGUE_SUMS)
    floats = 2 * rl * plan.tile + t
    if kernel in ("K4", "K5"):
        floats += rl + 2 * (1 << (t - 1).bit_length()) + 2
        if kernel == "K4":
            floats += 2 * rl
    return 4 * floats


def traj_plans(L: int, tiles=(1,)) -> list[TrajPlan]:
    """Every plan of power-of-two bands, of sites up to the rows a band has
    (rounded up to a power of two) and of the given tiles at L: what the
    plan sweep times and the tests run (K3: ``tiles=K3_TILES``)."""
    out = []
    for tile in tiles:
        C = 1
        while C <= min(MAX_BANDS, L):
            rows = -(-L // C)
            for sites in TRAJ_SITES:
                plan = traj_plan_of(L, C, sites, tile)
                if plan is not None and sites < 2 * rows:
                    out.append(plan)
            C *= 2
    return out


def _sites_plan(L: int, C: int, pref: int) -> TrajPlan | None:
    """The plan of C bands with the fewest sites a thread from ``pref`` up
    (fewer where a band has fewer rows) that fits."""
    pref = min(pref, 1 << (-(-L // C) - 1).bit_length())
    for sites in TRAJ_SITES:
        if sites >= pref:
            plan = traj_plan_of(L, C, sites)
            if plan is not None:
                return plan
    return None


@lru_cache(maxsize=None)
def traj_reach() -> int:
    """The largest L a plan takes."""
    L = MAX_BANDS
    while _sites_plan(L + 1, MAX_BANDS, 1) is not None:
        L += 1
    return L


@lru_cache(maxsize=None)
def traj_plan(L: int, B: int, n_sm: int, kernel: str = "K2") -> TrajPlan:
    """The plan ``kernel`` ('K2'-'K5', 'K12') runs B chains of L^2 sites
    under on a card of ``n_sm`` SMs. K2, K4, K5, K12: one CTA a chain where
    it holds the chain with threads of the kernel's SITES_PREFERRED sites
    (bands doubling while the grid of B x C CTAs is under the SM count and
    the bands keep MIN_BAND_ROWS rows), else the largest cluster, MAX_BANDS
    bands, with the fewest sites a thread from there up that fit. On an
    H100 one CTA a chain was the fastest plan at 64^2 and eight bands the
    fastest at 128^2, where a cluster's barriers cost the same whatever its
    size (PERF.md section 6, K2's row of the kernel table). K3: tiles of
    K3_TILE chains (one where B is), the fewest bands that hold a tile with
    threads of at most SITES_PREFERRED sites, the most that keep
    K3_MIN_THREADS threads a CTA (one CTA a tile up to 44^2); above what
    eight bands hold, K2's plan of one chain a group. Raises above
    ``traj_reach()``."""
    if L < 2 or L > traj_reach():
        raise ValueError(f"the trajectory kernels take 2 <= L <= "
                         f"{traj_reach()} (at most {MAX_BANDS} bands of at "
                         f"most {max_threads(TRAJ_SITES[-1])} threads of "
                         f"{TRAJ_SITES[-1]} sites), got L={L}")
    pref = SITES_PREFERRED[kernel]
    if kernel == "K3" and B > 1:
        for C in range(1, min(MAX_BANDS, L) + 1):
            top = min(pref, 1 << (-(-L // C) - 1).bit_length())
            fits = [p for p in (traj_plan_of(L, C, s, K3_TILE)
                                for s in TRAJ_SITES[::-1] if s <= top) if p]
            if fits:
                return next((p for p in fits
                             if p.threads >= K3_MIN_THREADS), fits[-1])
    if traj_plan_of(L, 1, min(pref, 1 << (L - 1).bit_length())) is None:
        return _sites_plan(L, min(MAX_BANDS, L), pref)
    C = 1
    while 2 * C <= min(MAX_BANDS, L) and B * C < n_sm \
            and L // (2 * C) >= MIN_BAND_ROWS:
        C *= 2
    return _sites_plan(L, C, pref)


# ---------------------------------------------------------------------------
# wrappers: the twin on the CPU, the kernel on the card
# ---------------------------------------------------------------------------

def _check_links(what: str, x: torch.Tensor, *like: torch.Tensor) -> None:
    if x.ndim != 4 or x.shape[1] != 2 or x.shape[2] != x.shape[3] \
            or x.shape[0] < 1 or x.shape[2] < 2:
        raise ValueError(f"{what} takes links (B, 2, L, L), L >= 2, got "
                         f"{tuple(x.shape)}")
    for t in like:
        if t.shape != x.shape:
            raise ValueError(f"{what}: shapes {tuple(t.shape)} and "
                             f"{tuple(x.shape)} differ")


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def _device_index(x: torch.Tensor) -> int:
    return (x.device.index if x.device.index is not None
            else torch.cuda.current_device())


@lru_cache(maxsize=None)
def _force_bytes(L: int, plan: ForcePlan) -> int:
    """The library's count of a K1 CTA's shared memory under ``plan``, -1
    for a plan it does not take."""
    return _build.library("force").force_smem_bytes(L, *plan)


@lru_cache(maxsize=None)
def _band_bytes(name: str, kernel: str, L: int, plan: TrajPlan) -> int:
    """The library's count of a CTA's shared memory under ``plan``, -1 for a
    plan it does not take."""
    if len(plan.row0) != plan.C + 1 or plan.row0[0] != 0 \
            or plan.row0[-1] != L \
            or min(b - a for a, b in zip(plan.row0, plan.row0[1:])) < 1:
        return -1
    if kernel == "K12":
        return _build.library(name).epilogue_smem_bytes(
            L, plan.rows, plan.threads, plan.sites)
    return _build.library(name).traj_band_smem_bytes(
        L, plan.rows, plan.threads, plan.sites, KINDS[kernel], plan.tile)


def _band_library(what: str, kernel: str, name: str, x: torch.Tensor,
                  plan, *tensors: torch.Tensor):
    """(library, plan) of a band-body launch (K2-K5, K12), the plan's
    arguments (C, row0, threads, sites) first, after refusing what it does
    not take: other dtypes, layouts or devices, L above the plans' reach,
    and a plan the library's count refuses or the card's shared memory does
    not hold. ``plan``: a TrajPlan, by default ``traj_plan``'s."""
    _build.require_fp32_contiguous(what, x, *tensors)
    B, _, L, _ = x.shape
    index = _device_index(x)
    try:
        if plan is None:
            plan = traj_plan(L, B, _build.sm_count(index), kernel)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None
    plan = TrajPlan(int(plan[0]), tuple(int(r) for r in plan[1]),
                    *(int(p) for p in plan[2:]))
    lib = _build.library(name)
    need = _band_bytes(name, kernel, L, plan)
    limit = _build.smem_limit(index)
    if not 0 < need <= limit:
        raise ValueError(f"{what}: the plan {plan} at L={L} needs {need} "
                         f"bytes of shared memory a CTA (-1: not a plan the "
                         f"kernel takes); the card allows {limit}")
    return lib, (plan.C, _build.int_array(plan.row0), plan.threads,
                 plan.sites), plan


def _traj_tail(x, beta, dt, nstep):
    """(B, L, beta, dt, dt / 2, nstep) of the trajectory entries."""
    if int(nstep) != nstep or nstep < 0:
        raise ValueError(f"nstep must be a non-negative integer, got {nstep}")
    B, _, L, _ = x.shape
    return (B, L, float(beta), float(dt), float(0.5 * dt), int(nstep))


def force(x: torch.Tensor, beta: float, *,
          plan: ForcePlan | None = None) -> torch.Tensor:
    """Gauge force of a batch x: (B, 2, L, L). A CPU tensor takes the plain
    twin; a CUDA tensor launches K1 under ``plan`` (default
    ``force_plan``'s; another for timing and tests)."""
    if x.ndim != 4 or x.shape[1] != 2 or x.shape[2] != x.shape[3]:
        raise ValueError(f"force takes (B, 2, L, L), got {tuple(x.shape)}")
    if _on_cpu(x):
        return force_plain(x, beta)
    _build.require_fp32_contiguous("K1 force", x)
    B, _, L, _ = x.shape
    index = _device_index(x)
    try:
        plan = force_plan(L) if plan is None else ForcePlan(*map(int, plan))
    except ValueError as e:
        raise ValueError(f"K1 force: {e}") from None
    need = _force_bytes(L, plan)
    if not 0 < need <= _build.smem_limit(index):
        raise ValueError(f"K1 force: the plan {plan} at L={L} needs {need} "
                         f"bytes of shared memory a CTA (-1: not a plan the "
                         f"kernel takes); the card allows "
                         f"{_build.smem_limit(index)}")
    lib = _build.library("force")
    f = torch.empty_like(x)
    rc = lib.k1_force(x.data_ptr(), f.data_ptr(), B, L, float(beta), *plan,
                      _build.stream_handle(x))
    _build.check(rc, "K1 force", lib)
    _build.LAUNCHES["K1"] += 1
    return f


def leapfrog(x: torch.Tensor, v: torch.Tensor, beta: float, dt: float,
             nstep: int, *, plan: TrajPlan | None = None):
    """Whole leapfrog trajectory of chains-first (B, 2, L, L) links x and
    momenta v in one launch of K2. Returns (x', v'), x' unwrapped.
    ``plan``: another band plan than ``traj_plan``'s (timing, tests)."""
    _check_links("K2 leapfrog", x, v)
    if _on_cpu(x):
        return leapfrog_plain(x, v, beta, dt, nstep)
    lib, pa, _ = _band_library("K2 leapfrog", "K2", "leapfrog", x, plan, v)
    tail = _traj_tail(x, beta, dt, nstep)
    xo, vo = torch.empty_like(x), torch.empty_like(v)
    rc = lib.k2_leapfrog(x.data_ptr(), v.data_ptr(), xo.data_ptr(),
                         vo.data_ptr(), *tail, *pa, _build.stream_handle(x))
    _build.check(rc, "K2 leapfrog", lib)
    _build.LAUNCHES["K2"] += 1
    return xo, vo


def leapfrog_cl(x: torch.Tensor, v: torch.Tensor, beta: float, dt: float,
                nstep: int, *, plan: TrajPlan | None = None):
    """The same trajectory through K3: tiles of chains, the chain the
    fastest thread index (chains last in the kernel's shared cells), on the
    (B, 2, L, L) tensors themselves, any B. ``plan``: another than
    ``traj_plan(..., 'K3')``'s (timing, tests)."""
    _check_links("K3 leapfrog_cl", x, v)
    if _on_cpu(x):
        return leapfrog_cl_plain(x, v, beta, dt, nstep)
    lib, pa, plan = _band_library("K3 leapfrog_cl", "K3", "leapfrog", x,
                                  plan, v)
    tail = _traj_tail(x, beta, dt, nstep)
    xo, vo = torch.empty_like(x), torch.empty_like(v)
    rc = lib.k3_leapfrog_cl(x.data_ptr(), v.data_ptr(), xo.data_ptr(),
                            vo.data_ptr(), *tail, *pa, plan.tile,
                            _build.stream_handle(x))
    _build.check(rc, "K3 leapfrog_cl", lib)
    _build.LAUNCHES["K3"] += 1
    return xo, vo


def hmc_traj(x: torch.Tensor, seed: torch.Tensor, beta: float, dt: float,
             nstep: int, *, plan: TrajPlan | None = None):
    """One fused HMC trajectory of (B, 2, L, L) chains through K4: momenta
    and accept draws from the in-kernel Philox stream keyed by (seed,
    chain), the seed one int32 on x's device (so the host never waits).
    Returns (x_new, dh, acc), dh and acc (B,), acc 0/1 in x's dtype.
    ``plan``: as ``leapfrog``'s."""
    _check_links("K4 hmc_traj", x)
    if seed.dtype != torch.int32 or seed.numel() != 1 \
            or seed.device != x.device:
        raise ValueError(f"K4 hmc_traj: seed must be one int32 on "
                         f"{x.device}, got {seed.dtype} {tuple(seed.shape)} "
                         f"on {seed.device}")
    if _on_cpu(x):
        return hmc_traj_plain(x, seed, beta, dt, nstep)
    lib, pa, _ = _band_library("K4 hmc_traj", "K4", "hmc_traj", x, plan)
    tail = _traj_tail(x, beta, dt, nstep)
    B = x.shape[0]
    xo = torch.empty_like(x)
    dh, acc = x.new_empty(B), x.new_empty(B)
    rc = lib.k4_hmc_traj(x.data_ptr(), seed.data_ptr(), xo.data_ptr(),
                         dh.data_ptr(), acc.data_ptr(), *tail, *pa,
                         _build.stream_handle(x))
    _build.check(rc, "K4 hmc_traj", lib)
    _build.LAUNCHES["K4"] += 1
    return xo, dh, acc


def hmc_traj_hostrng(x: torch.Tensor, v0: torch.Tensor, u: torch.Tensor,
                     beta: float, dt: float, nstep: int, *,
                     plan: TrajPlan | None = None):
    """K4's trajectory through K5, with the caller's momenta v0 (B, 2, L, L)
    and accept draws u (B,). Returns (x_new, dh, acc). ``plan``: as
    ``leapfrog``'s."""
    _check_links("K5 hmc_traj_hostrng", x, v0)
    if u.shape != (x.shape[0],):
        raise ValueError(f"K5 hmc_traj_hostrng: u must be ({x.shape[0]},), "
                         f"got {tuple(u.shape)}")
    if _on_cpu(x):
        return hmc_traj_hostrng_plain(x, v0, u, beta, dt, nstep)
    lib, pa, _ = _band_library("K5 hmc_traj_hostrng", "K5", "hmc_traj", x,
                               plan, v0, u)
    tail = _traj_tail(x, beta, dt, nstep)
    B = x.shape[0]
    xo = torch.empty_like(x)
    dh, acc = x.new_empty(B), x.new_empty(B)
    rc = lib.k5_hmc_traj_hostrng(x.data_ptr(), v0.data_ptr(), u.data_ptr(),
                                 xo.data_ptr(), dh.data_ptr(),
                                 acc.data_ptr(), *tail, *pa,
                                 _build.stream_handle(x))
    _build.check(rc, "K5 hmc_traj_hostrng", lib)
    _build.LAUNCHES["K5"] += 1
    return xo, dh, acc


def hmc_epilogue(x: torch.Tensor, x1: torch.Tensor, v1: torch.Tensor,
                 v0: torch.Tensor, u: torch.Tensor, q_old: torch.Tensor,
                 beta: float, *, plan: TrajPlan | None = None):
    """The plain HMC step after its trajectory, in one launch of K12: from
    the start x, the trajectory's unwrapped end (x1, v1) of momenta v0
    (each (B, 2, L, L)), the accept uniforms u and the last charges q_old
    (each (B,)): x1 wrapped, the delta-form dH, the accept u < exp(-dH),
    x_new (wrapped x1 where accepted, else x) and its plaquette and charge.
    Returns (x_new, the (6, B) rows of hmc.TrajMetrics' fields in x's
    dtype). Up to traj_reach() the band kernel runs under ``plan`` (default
    ``traj_plan(..., 'K12')``'s; another for timing and tests), above it, up
    to FORCE_MAX_L, the wide kernel in EPILOGUE_WIDE_BANDS bands a chain."""
    from fthmc_tpu_torch import hmc   # hmc imports this module
    _check_links("K12 hmc_epilogue", x, x1, v1, v0)
    B, _, L, _ = x.shape
    for name, t in (("u", u), ("q_old", q_old)):
        if t.shape != (B,):
            raise ValueError(f"K12 hmc_epilogue: {name} must be ({B},), got "
                             f"{tuple(t.shape)}")
    for t in (x1, v1, v0, u, q_old):
        if t.dtype != x.dtype:
            raise TypeError(f"K12 hmc_epilogue: dtypes {t.dtype} and "
                            f"{x.dtype} differ")
        if t.device != x.device:
            raise ValueError(f"K12 hmc_epilogue: tensors on {t.device} and "
                             f"{x.device}")
    if _on_cpu(x):
        return hmc_epilogue_plain(x, x1, v1, v0, u, q_old, beta)
    args = (x1, v1, v0, u, q_old)
    if L <= traj_reach():
        lib, pa, _ = _band_library("K12 hmc_epilogue", "K12", "hmc_traj", x,
                                   plan, *args)
        entry = lib.k12_hmc_epilogue
    else:
        _build.require_fp32_contiguous("K12 hmc_epilogue", x, *args)
        if L > FORCE_MAX_L or plan is not None:
            raise ValueError(f"K12 hmc_epilogue takes L <= {FORCE_MAX_L}, "
                             f"with band plans up to L = {traj_reach()}; got "
                             f"L={L}" + (" and a plan" if plan else ""))
        lib = _build.library("hmc_traj")
        C = EPILOGUE_WIDE_BANDS
        pa = (C, _build.int_array([r * L // C for r in range(C + 1)]))
        entry = lib.k12_hmc_epilogue_wide
    xo = torch.empty_like(x)
    out = x.new_empty((len(hmc.TrajMetrics._fields), B))
    rc = entry(x.data_ptr(), x1.data_ptr(), v1.data_ptr(), v0.data_ptr(),
               u.data_ptr(), q_old.data_ptr(), xo.data_ptr(), out.data_ptr(),
               B, L, float(beta), *pa, _build.stream_handle(x))
    _build.check(rc, "K12 hmc_epilogue", lib)
    _build.LAUNCHES["K12"] += 1
    return xo, out
