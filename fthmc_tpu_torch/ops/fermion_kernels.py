"""The Wilson-Dirac kernels K9-K11, their plain PyTorch twins, and the CG
built on them: the counterpart of ``fthmc_tpu/ops/pallas_fermion.py``.

  K9  ``mdagm``           csrc/fermion.cu  <- _mdagm_kernel (_mdagm_call,
                                              pallas_mdagm layout 'cf')
  K10 ``mdagm_cl``        csrc/fermion.cu  <- _mdagm_cl_kernel
                                              (_mdagm_call_cl)
  K11 ``cg_solve_fused``  csrc/fermion.cu  <- cg_solve_fused, its
                                              while_loop included
  K11_bf16 (``cg_solve_mixed``'s inner solve, K11 on bf16 storage)
                          csrc/fermion.cu  <- _cg_solve_mixed's bf16 inner
                                              while_loop (fermion.py)

K9 and K10 apply the normal operator D^dag D, or the even-odd Schur
Dhat^dag Dhat, to packed real planes [Re s0, Im s0, Re s1, Im s1]: K9 on
chains-first (B, 4, L0, L1), K10 on chains-last (4, L0, L1, B), each in
one launch an operator. A chain (K9) or a tile of ``K10_TILE`` chains
(K10) is split into C bands of rows, a CTA each (``fermion_band_plan``),
the band's planes with four halo rows a side and every intermediate in
shared memory, so the CTAs need nothing of each other. K11 is the whole
CG solve in one launch, on either layout: a chain is a cluster of row
bands (``cg_plan``), the operator's passes those of K9, the vectors
and the loop on the card, and the host reads the iteration counters once
a solve. ``cg_solve_mixed`` is the mixed-precision CG: an fp32
refinement loop on the host, each cycle a K9 / K10 residual and one
K11_bf16 launch.

The twins' math has one source, ``hop_planes`` and ``normal_op_planes``
(ports of ``_hop_planes`` and ``normal_op_planes``), with a roll callable
for the layout, as in the JAX package; K11's twin ``cg_solve_fused_plain``
is the JAX while_loop on them. A CPU tensor takes the twin; a CUDA tensor
launches the kernel, or raises for what the kernels do not take: other
dtypes, odd sides or sides under 4 (``check_sides``), an eo solve whose b
or x0 is not zero on the odd sites. There is no upper limit: a band lives
in shared memory where it fits (on an H100, K9 under
``fermion_band_plan``'s plans to 96^2 at least, K10's 8-chain tiles to
32^2, K11's chains to 160^2 eo and 120^2 not) and in a scratch buffer the
wrapper allocates beyond (``operator_plan``, ``cg_plan``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from fthmc_tpu_torch.ops import _build

__all__ = ["pack_spinor", "unpack_spinor", "link_planes", "parity_masks",
           "hop_planes", "normal_op_planes", "mdagm_plain", "mdagm_cl_plain",
           "cg_update_plain", "cg_planes_plain", "mdagm", "mdagm_cl",
           "check_sides", "resolve_layout", "fused_mdagm", "CGResult",
           "cg_solve_fused", "cg_solve_fused_plain", "fermion_band_plan",
           "operator_plan", "operator_launch", "CGPlan", "cg_plan",
           "cg_launch", "K10_TILE", "MIXED_INNER_TOL", "MIXED_INNER_MAX",
           "cg_planes_bf16_plain", "cg_solve_mixed"]

MAX_BANDS = 8            # bands a group (csrc/common.cuh)
HALO_ROWS = 4            # halo rows a side of a band (csrc/fermion.cu)
# chains a K10 tile (a power of two): the chains-last layout's coalesced
# axis (8, 16 and 32 timed on an H100: PERF.md section 6)
K10_TILE = 8
CG_MAX_THREADS = 1024


# ---------------------------------------------------------------------------
# packing helpers (once per solve, not per iteration)
# ---------------------------------------------------------------------------

def pack_spinor(psi: torch.Tensor) -> torch.Tensor:
    """Complex spinor field (..., L0, L1, 2) -> packed (..., 4, L0, L1) fp32
    planes [Re s0, Im s0, Re s1, Im s1]."""
    s0, s1 = psi[..., 0], psi[..., 1]
    return torch.stack((s0.real, s0.imag, s1.real, s1.imag), dim=-3)


def unpack_spinor(p4: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_spinor: (..., 4, L0, L1) -> (..., L0, L1, 2)."""
    s0 = torch.complex(p4[..., 0, :, :], p4[..., 1, :, :])
    s1 = torch.complex(p4[..., 2, :, :], p4[..., 3, :, :])
    return torch.stack((s0, s1), dim=-1)


def link_planes(theta: torch.Tensor):
    """(ur, ui), each (..., 2, L0, L1) fp32: the links' real and imaginary
    parts, with the antiperiodic time boundary folded into direction 0's
    last time slice (the sign convention of ``fermion._links``)."""
    th = theta.to(torch.float32)
    ur, ui = torch.cos(th), torch.sin(th)
    L0 = theta.shape[-2]
    sign = torch.ones((2, L0, 1), dtype=torch.float32, device=theta.device)
    sign[0, L0 - 1] = -1.0
    return ur * sign, ui * sign


def parity_masks(L0: int, L1: int, trailing: int, device):
    """(even, odd) fp32 masks of shape (L0, L1) + (1,) * trailing."""
    i0 = torch.arange(L0, device=device)[:, None]
    i1 = torch.arange(L1, device=device)[None, :]
    even = ((i0 + i1) % 2 == 0).to(torch.float32)
    even = even.reshape((L0, L1) + (1,) * trailing)
    return even, 1.0 - even


# ---------------------------------------------------------------------------
# the operator's math, one source for both layouts
# ---------------------------------------------------------------------------

def hop_planes(ur0, ui0, ur1, ui1, s0r, s0i, s1r, s1i, roll):
    """Wilson hop H psi on packed planes; returns the four result planes.
    ``roll(x, shift, axis)`` shifts along lattice axis 1 (x0) or 2 (x1) of
    (chain, L0, L1) planes; roll(x, -1, axis) is x(n + 1). Per direction
    one complex combine, one complex multiply and one two-plane roll, from
    the rank-one projectors p0m = (d, -d), p0p = (e, e), p1m = (w, -i w),
    p1p = (v, i v)."""
    # forward 0: u0 * psi(n + e0), projector (1 - g0): (d, -d), d = t0 - t1
    t0r, t0i = roll(s0r, -1, 1), roll(s0i, -1, 1)
    t1r, t1i = roll(s1r, -1, 1), roll(s1i, -1, 1)
    dr, di = t0r - t1r, t0i - t1i
    mr = ur0 * dr - ui0 * di
    mi = ur0 * di + ui0 * dr
    h0r, h0i, h1r, h1i = mr, mi, -mr, -mi

    # backward 0: (conj(u0) psi)(n - e0), projector (1 + g0): (e, e)
    er, ei = s0r + s1r, s0i + s1i
    mr = ur0 * er + ui0 * ei
    mi = ur0 * ei - ui0 * er
    rr, ri = roll(mr, 1, 1), roll(mi, 1, 1)
    h0r = h0r + rr
    h0i = h0i + ri
    h1r = h1r + rr
    h1i = h1i + ri

    # forward 1: u1 * psi(n + e1), projector (1 - g1): (w, -i w),
    # w = t0 + i t1
    t0r, t0i = roll(s0r, -1, 2), roll(s0i, -1, 2)
    t1r, t1i = roll(s1r, -1, 2), roll(s1i, -1, 2)
    wr, wi = t0r - t1i, t0i + t1r
    mr = ur1 * wr - ui1 * wi
    mi = ur1 * wi + ui1 * wr
    h0r = h0r + mr
    h0i = h0i + mi
    h1r = h1r + mi           # -i m = (Im m, -Re m)
    h1i = h1i + (-mr)

    # backward 1: (conj(u1) psi)(n - e1), projector (1 + g1): (v, i v),
    # v = s0 - i s1
    vr, vi = s0r + s1i, s0i - s1r
    mr = ur1 * vr + ui1 * vi
    mi = ur1 * vi - ui1 * vr
    rr, ri = roll(mr, 1, 2), roll(mi, 1, 2)
    h0r = h0r + rr
    h0i = h0i + ri
    h1r = h1r + (-ri)        # i r = (-Im r, Re r)
    h1i = h1i + rr
    return h0r, h0i, h1r, h1i


def normal_op_planes(hop, s, mass: float, eo: bool, even, odd):
    """D^dag D, or the even-odd Schur Dhat^dag Dhat, of four packed planes
    ``s`` from a hop closure; ``even``/``odd`` broadcast against the planes
    (unused when eo is False)."""
    a = mass + 2.0
    if eo:
        b = 0.25 / a

        def dhat(s):
            h = hop(s)
            h = hop(tuple(odd * c for c in h))
            return tuple(a * si - b * even * hi for si, hi in zip(s, h))
    else:
        def dhat(s):
            h = hop(s)
            return tuple(a * si - 0.5 * hi for si, hi in zip(s, h))

    def dhat_dag(s):
        # g5 D g5: g5 negates the second spinor component's planes
        r = dhat((s[0], s[1], -s[2], -s[3]))
        return (r[0], r[1], -r[2], -r[3])

    return dhat_dag(dhat(s))


def _roll_cf(x, shift, axis):
    return torch.roll(x, shift, dims=axis)


def _roll_cl(x, shift, axis):
    return torch.roll(x, shift, dims=axis - 1)   # (L0, L1, B) planes


def _masks_for(L0: int, L1: int, trailing: int, p4) -> tuple:
    """The twins' parity masks: fp32 (so b / 4a is rounded to fp32, as the
    kernels take it), bf16 for bf16 planes (the mixed CG's inner twin keeps
    its vectors bf16, as the JAX package's _plane_mdagm does)."""
    dtype = torch.bfloat16 if p4.dtype == torch.bfloat16 else torch.float32
    return tuple(m.to(dtype) for m in parity_masks(L0, L1, trailing,
                                                   p4.device))


def mdagm_plain(ur, ui, p4, mass: float, eo: bool) -> torch.Tensor:
    """K9's twin: links (B, 2, L0, L1), planes (B, 4, L0, L1)."""
    _build.PLAIN_CALLS["K9"] += 1
    even, odd = _masks_for(p4.shape[-2], p4.shape[-1], 0, p4)

    def hop(s):
        return hop_planes(ur[:, 0], ui[:, 0], ur[:, 1], ui[:, 1], *s,
                          roll=_roll_cf)

    m = normal_op_planes(hop, tuple(p4[:, k] for k in range(4)), mass, eo,
                         even, odd)
    return torch.stack(m, dim=1)


def mdagm_cl_plain(urt, uit, p4t, mass: float, eo: bool) -> torch.Tensor:
    """K10's twin: links (2, L0, L1, B), planes (4, L0, L1, B)."""
    _build.PLAIN_CALLS["K10"] += 1
    even, odd = _masks_for(p4t.shape[1], p4t.shape[2], 1, p4t)

    def hop(s):
        return hop_planes(urt[0], uit[0], urt[1], uit[1], *s, roll=_roll_cl)

    m = normal_op_planes(hop, tuple(p4t[k] for k in range(4)), mass, eo,
                         even, odd)
    return torch.stack(m, dim=0)


def _chain_dims(chains_last: bool):
    """(reduction dims, broadcast of a (B,) vector) of a packed layout."""
    if chains_last:
        return (0, 1, 2), (lambda a: a[None, None, None, :])
    return (1, 2, 3), (lambda a: a[:, None, None, None])


def cg_update_plain(p, mp, x, r, rsq, stop, counters, it: int,
                    chains_last: bool) -> None:
    """One iteration's update of K11's twin, in place, after mp = M p (the
    kernel's update repeats it op for op). Per chain, active = rsq > stop;
      alpha = active ? rsq / max(<p, mp>, 1e-30) : 0,
      x += alpha p,  r -= alpha mp,  rsq_new = <r, r>,
      beta = active ? rsq_new / max(rsq, 1e-30) : 0,
      p = r + beta p,  rsq = active ? rsq_new : rsq.
    counters (int32 (2,)): [0] the iterations, it + 1, in which a chain
    was active, [1] those after which one still is (maxima over chains)."""
    _build.PLAIN_CALLS["K11"] += 1
    dims, bc = _chain_dims(chains_last)
    active = rsq > stop
    denom = (p * mp).sum(dim=dims)
    alpha = torch.where(active, rsq / torch.clamp_min(denom, 1e-30), 0.0)
    x.add_(bc(alpha) * p)
    r.sub_(bc(alpha) * mp)
    rsq_new = (r * r).sum(dim=dims)
    beta = torch.where(active, rsq_new / torch.clamp_min(rsq, 1e-30), 0.0)
    p.copy_(r + bc(beta) * p)
    live = active & (rsq_new > stop)
    rsq.copy_(torch.where(active, rsq_new, rsq))
    step = torch.tensor([it + 1, it + 1], dtype=counters.dtype,
                        device=counters.device)
    flags = torch.stack((active.any(), live.any()))
    counters.copy_(torch.where(flags, torch.maximum(counters, step),
                               counters))


def cg_planes_plain(ur, ui, b4, x4, mass: float, tol: float, maxiter: int,
                    eo: bool, chains_last: bool):
    """K11's twin on packed planes of any float dtype (links and planes in
    one layout, x4 the start or None): JAX's while_loop, iterating while
    any chain has rsq > tol |b|^2 and at most maxiter times, each iteration
    the operator's twin and ``cg_update_plain`` (a chain that stops is
    frozen by alpha = beta = 0, a NaN rsq stops it). Returns (x, iters,
    rsq, bsq), iters JAX's ``k``."""
    op = mdagm_cl_plain if chains_last else mdagm_plain
    dims, _ = _chain_dims(chains_last)
    x = torch.zeros_like(b4) if x4 is None else x4.clone()
    bsq = (b4 * b4).sum(dim=dims)
    stop = tol * bsq
    r = b4 - op(ur, ui, x, mass, eo)
    p = r.clone()
    rsq = (r * r).sum(dim=dims)
    counters = torch.zeros(2, dtype=torch.int32, device=b4.device)
    k = 0
    while k < maxiter and bool((rsq > stop).any()):
        mp = op(ur, ui, p, mass, eo)
        cg_update_plain(p, mp, x, r, rsq, stop, counters, k, chains_last)
        k += 1
    return x, k, rsq, bsq


# ---------------------------------------------------------------------------
# wrappers: the twin on the CPU, the kernel on the card
# ---------------------------------------------------------------------------

def check_sides(L0: int, L1: int) -> None:
    """The kernels' envelope: even sides of at least 4 (the checkerboard
    parity must tile). Raises ValueError naming it."""
    if L0 % 2 or L1 % 2 or L0 < 4 or L1 < 4:
        raise ValueError(f"the fermion kernels take even sides >= 4, got "
                         f"L0={L0}, L1={L1}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _device_index_of(device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _check_planes(what: str, ur, ui, p4, chains_last: bool) -> tuple:
    """(B, L0, L1) of consistent link and spinor planes."""
    if p4.ndim != 4 or ur.ndim != 4:
        raise ValueError(f"{what}: planes must be rank 4, got "
                         f"{tuple(p4.shape)} and {tuple(ur.shape)}")
    if chains_last:
        (_, L0, L1, B), want = p4.shape, (2,) + tuple(p4.shape[1:])
        ok = p4.shape[0] == 4
    else:
        (B, _, L0, L1), want = p4.shape, (p4.shape[0], 2) + tuple(
            p4.shape[2:])
        ok = p4.shape[1] == 4
    if not ok or tuple(ur.shape) != want or tuple(ui.shape) != want:
        raise ValueError(f"{what}: links {tuple(ur.shape)}, "
                         f"{tuple(ui.shape)} do not match planes "
                         f"{tuple(p4.shape)}")
    check_sides(L0, L1)
    return B, L0, L1


def _out(what: str, out, p4):
    if out is None:
        return torch.empty_like(p4)
    if out.shape != p4.shape or out.dtype != p4.dtype \
            or out.device != p4.device or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous tensor like the "
                         f"planes")
    return out


def _ab(mass: float) -> tuple[float, float]:
    """(a, b) = (m + 2, 1 / (4 a)) of the kernels' entries, in double as
    ``normal_op_planes`` forms them (ctypes rounds each to fp32, as a torch
    op rounds a Python scalar)."""
    a = mass + 2.0
    return a, 0.25 / a


def fermion_band_plan(L: int, B: int, n_sm: int,
                      tile: int = 1) -> tuple[int, tuple[int, ...]]:
    """The bands a group of K9 / K10 work is split into: (C, row0), CTA r
    of the C owning rows [row0[r], row0[r + 1]) of the L rows, a group being
    a chain (K9, ``tile`` 1) or a tile of ``tile`` chains (K10), so
    ceil(B / tile) x C CTAs make the grid. C is a power of two up to
    MAX_BANDS, doubled while the grid is under the card's ``n_sm`` SMs and
    the bands keep HALO_ROWS rows: a band computes its four halo rows a
    side again, so thinner bands cost more than the SMs they fill (the
    H100 times of every plan, PERF.md section 6). Bands differ by at most
    one row."""
    groups = -(-B // tile)
    C = 1
    while groups * C < n_sm and 2 * C <= min(MAX_BANDS, L // HALO_ROWS):
        C *= 2
    return C, tuple(r * L // C for r in range(C + 1))


@lru_cache(maxsize=None)
def _band_bytes(L0: int, L1: int, C: int, rows: int, tile: int) -> int:
    return _build.library("fermion").fermion_smem_bytes(L0, L1, C, rows,
                                                        tile)


def operator_plan(cl: bool, B: int, L0: int, L1: int, device, plan=None,
                  tile: int | None = None):
    """(C, row0, tile, scratch floats) of a K9 (``cl`` False) or K10
    launch: the band plan ``plan`` (C, row0), by default
    ``fermion_band_plan``'s, K10's chain tile (``K10_TILE`` by default; 1
    for K9), and the device scratch the bands take where one does not fit
    in shared memory (0 where it does), as the kernels' own count
    ``fermion_smem_bytes`` says. Raises for a plan the kernels do not
    take. ``plan`` and ``tile`` other than the defaults are for timing and
    tests."""
    index = _device_index_of(device)
    tile = (K10_TILE if tile is None else int(tile)) if cl else 1
    if plan is None:
        plan = fermion_band_plan(L0, B, _build.sm_count(index), tile)
    C, row0 = int(plan[0]), tuple(int(r) for r in plan[1])
    rows = [b - a for a, b in zip(row0, row0[1:])]
    need = -1
    if len(row0) == C + 1 and row0[0] == 0 and row0[-1] == L0 \
            and min(rows) >= 1:
        need = _band_bytes(L0, L1, C, max(rows), tile)
    if need < 0:
        raise ValueError(f"the fermion kernels do not take the band plan "
                         f"{plan} with tile {tile} at L0={L0}, L1={L1}")
    fits = need <= _build.smem_limit(index)
    return C, row0, tile, 0 if fits else -(-B // tile) * C * need // 4


class _Launch:
    """A kernel entry with its arguments bound after one validation: a call
    launches the kernel (one ctypes call), checks the launch and counts it
    (a CUDA graph of bound launches times the card alone). ``keep`` holds
    the tensors behind the bound pointers, so a launch made again later
    never writes freed memory."""
    __slots__ = ("name", "fn", "lib", "args", "stream", "keep")

    def __init__(self, name: str, fn, lib, args: tuple, stream: int,
                 keep: tuple):
        self.name, self.fn, self.lib = name, fn, lib
        self.args, self.stream, self.keep = args, stream, keep

    def __call__(self, *mid) -> None:
        rc = self.fn(*self.args, *mid, self.stream)
        if rc:
            _build.check(rc, self.name, self.lib)
        _build.LAUNCHES[self.name] += 1


def operator_launch(cl: bool, ur, ui, p4, mass: float, eo: bool, out,
                    scratch, plan=None, tile: int | None = None):
    """(K9 or K10 launch of p4 -> out, out) after refusing what the kernel
    does not take; allocates out, and the scratch ``operator_plan`` asks
    for, when not given. ``plan``, ``tile``: see ``operator_plan``."""
    name = "K10" if cl else "K9"
    what = "K10 mdagm_cl" if cl else "K9 mdagm"
    B, L0, L1 = _check_planes(what, ur, ui, p4, cl)
    _build.require_fp32_contiguous(what, ur, ui, p4)
    out = _out(what, out, p4)
    C, row0, tile, n_scratch = operator_plan(cl, B, L0, L1, p4.device, plan,
                                             tile)
    if n_scratch and (scratch is None or scratch.numel() < n_scratch):
        scratch = torch.empty(n_scratch, dtype=torch.float32,
                              device=p4.device)
    lib = _build.library("fermion")
    args = (ur.data_ptr(), ui.data_ptr(), p4.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if n_scratch else None, B, L0, L1,
            *_ab(mass), int(eo), C, _build.int_array(row0))
    fn = lib.k10_mdagm_cl if cl else lib.k9_mdagm
    if cl:
        args += (tile,)
    return _Launch(name, fn, lib, args, _build.stream_handle(p4),
                   (ur, ui, p4, out, scratch)), out


def mdagm(ur, ui, p4, mass: float, eo: bool, out=None, scratch=None,
          plan=None):
    """Normal operator of chains-first planes p4 (B, 4, L0, L1) with links
    (B, 2, L0, L1) through K9 (its twin on the CPU), into ``out`` if
    given. ``scratch``: the bands' device buffer where they do not fit in
    shared memory (``operator_plan``), allocated here when needed and not
    given; ``plan``: another band plan (timing and tests)."""
    _check_planes("K9 mdagm", ur, ui, p4, False)
    if _on_cpu(p4):
        res = mdagm_plain(ur, ui, p4, mass, eo)
        return res if out is None else out.copy_(res)
    launch, out = operator_launch(False, ur, ui, p4, mass, eo, out, scratch,
                                  plan)
    launch()
    return out


def mdagm_cl(urt, uit, p4t, mass: float, eo: bool, out=None, scratch=None,
             plan=None, tile: int | None = None):
    """Normal operator of chains-last planes p4t (4, L0, L1, B) with links
    (2, L0, L1, B) through K10 (its twin on the CPU), into ``out`` if
    given, in one launch. ``scratch``, ``plan``: as for ``mdagm``;
    ``tile``: another chain tile (timing and tests)."""
    _check_planes("K10 mdagm_cl", urt, uit, p4t, True)
    if _on_cpu(p4t):
        res = mdagm_cl_plain(urt, uit, p4t, mass, eo)
        return res if out is None else out.copy_(res)
    launch, out = operator_launch(True, urt, uit, p4t, mass, eo, out,
                                  scratch, plan, tile)
    launch()
    return out


# ---------------------------------------------------------------------------
# the operator on complex fields, and the CG
# ---------------------------------------------------------------------------

LAYOUTS = ("auto", "cf", "cl")


def resolve_layout(layout: str, L0: int, L1: int) -> str:
    """'cf' (K9's planes) or 'cl' (K10's), for the operator and K11's
    solve. 'auto' is K10 up to 8^2 sites and K9 above:
    on an H100 with 128 chains K10 took 6.9 us against K9's 7.9 at 8^2,
    and K9 was faster at 16^2, 32^2 and 64^2 (PERF.md section 6, the
    'auto' layout rule), where the JAX package picks
    chains-last below 32 sites a side for its TPU's lanes."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    if layout != "auto":
        return layout
    return "cl" if L0 * L1 <= 64 else "cf"


class _PackedOperator:
    """The links of one gauge field on packed planes of one layout, made
    once (per solve), and the packing to and from complex fields."""

    def __init__(self, theta: torch.Tensor, layout: str):
        check_sides(theta.shape[-2], theta.shape[-1])
        self.chains_last = layout == "cl"
        ur, ui = link_planes(theta)
        if self.chains_last:
            ur, ui = (t.permute(1, 2, 3, 0).contiguous() for t in (ur, ui))
        self.ur, self.ui = ur, ui

    def pack(self, psi):
        p4 = pack_spinor(psi)
        return (p4.permute(1, 2, 3, 0) if self.chains_last else p4) \
            .contiguous()

    def unpack(self, p4):
        return unpack_spinor(p4.permute(3, 0, 1, 2) if self.chains_last
                             else p4)


def fused_mdagm(theta: torch.Tensor, psi: torch.Tensor, mass: float, *,
                eo: bool = True, layout: str = "cf") -> torch.Tensor:
    """The normal operator of complex fields through K9 ('cf') or K10
    ('cl'), the counterpart of ``pallas_mdagm``: theta (B, 2, L0, L1) or
    (2, L0, L1), psi (B, L0, L1, 2) or (L0, L1, 2)."""
    squeeze = psi.ndim == 3
    if squeeze:
        theta, psi = theta[None], psi[None]
    layout = resolve_layout(layout, theta.shape[-2], theta.shape[-1])
    op = _PackedOperator(theta, layout)
    fn = mdagm_cl if op.chains_last else mdagm
    res = op.unpack(fn(op.ur, op.ui, op.pack(psi), mass, eo))
    return res[0] if squeeze else res


# ---------------------------------------------------------------------------
# K11: the whole CG solve
# ---------------------------------------------------------------------------

class CGPlan(NamedTuple):
    """A K11 launch's geometry: C bands a chain (CTA r of a cluster owning
    rows [row0[r], row0[r + 1])), ``threads`` threads a CTA, and the device
    scratch the bands take where they do not fit in shared memory (0 where
    they do)."""
    C: int
    row0: tuple
    threads: int
    scratch: int


@lru_cache(maxsize=None)
def _cg_bytes(L0: int, L1: int, C: int, rows: int, eo: bool,
              in_smem: bool, bf16: bool = False) -> int:
    return _build.library("fermion").cg_smem_bytes(L0, L1, C, rows, int(eo),
                                                   int(in_smem),
                                                   2 if bf16 else 4)


def _even_bands(L: int, C: int) -> tuple:
    return tuple(r * L // C for r in range(C + 1))


def cg_plan(eo: bool, B: int, L0: int, L1: int, device,
            plan=None, bf16: bool = False) -> CGPlan:
    """K11's plan for B chains of L0 x L1 sites, in either layout: C bands
    of rows a chain, a CTA each, and a device scratch for the bands where
    they do not fit in shared memory, as the kernel's own count
    ``cg_smem_bytes`` says. By default the first of C = 1, 2, 4, 8 whose
    band fits in shared memory (one CTA a chain needs no cluster barrier or
    halo copy; on an H100 C = 1 and 2 tied at path A, 4 and 8 were 1.6x
    slower), else 8 bands in scratch (fewer where bands would have under 4
    rows). ``threads``: the power of two covering a band's sites of one
    parity, 32 to 1024. ``bf16``: the bf16 instance, whose region takes
    half the bytes. ``plan`` (C, row0) other than the default is for
    timing and tests. Raises for what the kernel does not take."""
    check_sides(L0, L1)
    limit = _build.smem_limit(_device_index_of(torch.device(device)))

    def need(C, row0):
        """(largest band, bytes of a CTA with its band in shared memory)."""
        rows = [hi - lo for lo, hi in zip(row0, row0[1:])]
        n = -1
        if len(row0) == C + 1 and row0[0] == 0 and row0[-1] == L0 \
                and min(rows) >= 1:
            n = _cg_bytes(L0, L1, C, max(rows), eo, True, bf16)
        if n < 0:
            raise ValueError(f"K11 takes no band plan {(C, row0)} at "
                             f"L0={L0}, L1={L1}")
        return max(rows), n

    if plan is not None:
        C, row0 = int(plan[0]), tuple(int(r) for r in plan[1])
    else:
        fit = [C for C in (1, 2, 4, 8)
               if C <= L0 and need(C, _even_bands(L0, C))[1] <= limit]
        C = MAX_BANDS
        while C > 1 and L0 // C < HALO_ROWS:
            C //= 2
        C = fit[0] if fit else C
        row0 = _even_bands(L0, C)
    R, n = need(C, row0)
    threads = 32
    while threads < min(R * (L1 // 2), CG_MAX_THREADS):
        threads *= 2
    band = 0 if n <= limit else (n - _cg_bytes(L0, L1, C, R, eo, False,
                                                bf16)) // 4
    return CGPlan(C, row0, threads, B * C * band)


def cg_launch(cl: bool, ur, ui, b4, x4, mass: float, eo: bool, tol: float,
              maxiter: int, x, rel, counters, scratch=None,
              plan=None) -> _Launch:
    """K11's launch of a whole solve of packed planes b4 from x4 (None:
    zero) into x, rel (B,) and counters (int32 (3,), zero before: see
    csrc/fermion.cu, k11_cg_solve), after refusing what the kernel does not
    take; allocates the scratch ``cg_plan`` asks for when not given.
    fp32 planes launch K11, bf16 planes (links, b4, x4 and x) its bf16
    instance K11_bf16 (rel stays fp32). ``plan``: see ``cg_plan``."""
    bf16 = b4.dtype == torch.bfloat16
    what = "K11_bf16 cg_solve" if bf16 else "K11 cg_solve"
    B, L0, L1 = _check_planes(what, ur, ui, b4, cl)
    planes = (ur, ui, b4, x) + (() if x4 is None else (x4,))
    _build.require_contiguous(what, b4.dtype, *planes)
    _build.require_fp32_contiguous(what, rel)
    for t in (x,) + (() if x4 is None else (x4,)):
        if t.shape != b4.shape:
            raise ValueError(f"{what}: x and x0 must have b's shape")
    if rel.shape != (B,) or counters.shape != (3,) \
            or counters.dtype != torch.int32 or counters.device != b4.device:
        raise ValueError(f"{what}: rel must be (B,), counters int32 (3,) "
                         f"on the planes' device")
    pl = cg_plan(eo, B, L0, L1, b4.device, plan, bf16)
    if pl.scratch and (scratch is None or scratch.numel() < pl.scratch):
        scratch = torch.empty(pl.scratch, dtype=torch.float32,
                              device=b4.device)
    lib = _build.library("fermion")
    args = (ur.data_ptr(), ui.data_ptr(), b4.data_ptr(),
            None if x4 is None else x4.data_ptr(), x.data_ptr(),
            rel.data_ptr(), counters.data_ptr(),
            scratch.data_ptr() if pl.scratch else None, B, L0, L1,
            *_ab(mass), int(eo), float(tol), int(maxiter), pl.C,
            _build.int_array(pl.row0), pl.threads, int(cl))
    return _Launch("K11_bf16" if bf16 else "K11",
                   lib.k11_cg_solve_bf16 if bf16 else lib.k11_cg_solve, lib,
                   args, _build.stream_handle(b4),
                   (ur, ui, b4, x4, x, rel, counters, scratch))


class CGResult(NamedTuple):
    """A CG solve: the solution (b's shape), the iterations in which any
    chain was active (a Python int, JAX's ``k``; the mixed CG's, operator
    applications, as JAX counts them), each chain's final |r|^2 / |b|^2,
    the iterations run (``iters``: the fused CG, on the card and off, and
    the torch one stop at the first iteration after which no chain is
    active), and the solve's reads of the device's state to the host (the
    fused CG one, the mixed one its refinement cycles and one, the torch
    one an iteration and one)."""
    x: torch.Tensor
    iters: int
    rsq: torch.Tensor
    launched: int
    reads: int = 1


_ODD_SITES = ("an eo solve takes b and x0 that vanish on the odd sites (the "
              "Schur system lives on the even ones)")


def _packed(theta, b, x0, layout):
    """(links and packing, b's planes, x0's or None, squeeze) of a solve."""
    squeeze = b.ndim == 3
    if squeeze:
        theta, b = theta[None], b[None]
        x0 = None if x0 is None else x0[None]
    op = _PackedOperator(theta, resolve_layout(layout, theta.shape[-2],
                                               theta.shape[-1]))
    return op, op.pack(b), None if x0 is None else op.pack(x0), squeeze


def _result(op, x, iters: int, rel, squeeze: bool) -> CGResult:
    sol = op.unpack(x)
    if squeeze:
        sol, rel = sol[0], rel[0]
    return CGResult(sol, iters, rel, iters)


@torch.no_grad()
def cg_solve_fused(theta: torch.Tensor, b: torch.Tensor, mass: float,
                   x0: torch.Tensor | None = None, *, tol: float = 1e-8,
                   maxiter: int = 1000, eo: bool = True,
                   layout: str = "auto") -> CGResult:
    """Batched CG for the normal operator (eo: the Schur system, b and x0
    zero on the odd sites) on packed planes through K11 (its twin
    ``cg_solve_fused_plain`` on the CPU), with ``fermion.cg_solve``'s
    semantics: per-chain freezing of converged chains, tol on |r|^2 /
    |b|^2. Complex in and out, either rank; ``layout`` ('auto', 'cf', 'cl')
    the planes' layout. On the card: one launch, and one read of the
    counters (the solve's one synchronization), which also carry the
    kernel's finding of an odd site that is not zero."""
    op, b4, x4, squeeze = _packed(theta, b, x0, layout)
    if _on_cpu(b4):
        if eo:
            _, odd = parity_masks(theta.shape[-2], theta.shape[-1],
                                  int(op.chains_last), b4.device)
            if any(bool((t * odd).ne(0).any()) for t in (b4, x4)
                   if t is not None):
                raise ValueError(_ODD_SITES)
        x, iters, rsq, bsq = cg_planes_plain(op.ur, op.ui, b4, x4, mass,
                                             tol, maxiter, eo,
                                             op.chains_last)
        return _result(op, x, iters, rsq / torch.clamp_min(bsq, 1e-30),
                       squeeze)
    B = b4.shape[-1] if op.chains_last else b4.shape[0]
    x = torch.empty_like(b4)
    rel = torch.empty(B, dtype=torch.float32, device=b4.device)
    counters = torch.zeros(3, dtype=torch.int32, device=b4.device)
    cg_launch(op.chains_last, op.ur, op.ui, b4, x4, mass, eo, tol, maxiter,
              x, rel, counters)()
    iters, _, odd = counters.tolist()
    if odd:
        raise ValueError(_ODD_SITES)
    return _result(op, x, iters, rel, squeeze)


@torch.no_grad()
def cg_solve_fused_plain(theta: torch.Tensor, b: torch.Tensor, mass: float,
                         x0: torch.Tensor | None = None, *, tol: float = 1e-8,
                         maxiter: int = 1000, eo: bool = True,
                         layout: str = "auto") -> CGResult:
    """K11's plain twin on any device (``cg_planes_plain`` on the packed
    planes of ``layout``): what runs on the CPU, and the yardstick the
    kernel is held against on the card."""
    op, b4, x4, squeeze = _packed(theta, b, x0, layout)
    x, iters, rsq, bsq = cg_planes_plain(op.ur, op.ui, b4, x4, mass, tol,
                                         maxiter, eo, op.chains_last)
    return _result(op, x, iters, rsq / torch.clamp_min(bsq, 1e-30), squeeze)


# ---------------------------------------------------------------------------
# the mixed-precision CG: fp32 refinement around K11's bf16 instance
# ---------------------------------------------------------------------------

# bf16 stagnates near relative residual ~1e-2..1e-3; each refinement cycle
# targets an rsq reduction of 1e-4 within <= 48 sweeps (the JAX package's
# _MIXED_INNER_TOL, _MIXED_INNER_MAX)
MIXED_INNER_TOL = 1e-4
MIXED_INNER_MAX = 48


def _dot32(u, v, dims):
    """Per-chain sum of u v over ``dims``, accumulated in fp32 whatever the
    planes' dtype (the JAX mixed CG's ``dot``)."""
    return (u * v).sum(dim=dims, dtype=torch.float32)


def cg_planes_bf16_plain(ur16, ui16, r16, mass: float, tol: float,
                         maxiter: int, eo: bool, chains_last: bool):
    """K11_bf16's twin: the JAX mixed CG's inner loop (``inner`` in
    ``_cg_solve_mixed``) for A d = r16 from d = 0 on bf16 links and planes
    of one layout: bf16 vectors and operator (the K9 / K10 twins in bf16),
    alpha and beta rounded to bf16, fp32 dots; while any chain has irsq >
    tol irsq_0 and at most maxiter sweeps. Returns (d bf16, sweeps)."""
    op = mdagm_cl_plain if chains_last else mdagm_plain
    dims, bc = _chain_dims(chains_last)
    d = torch.zeros_like(r16)
    rr, p = r16.clone(), r16.clone()
    irsq = _dot32(rr, rr, dims)
    istop = tol * irsq
    k = 0
    while k < maxiter and bool((irsq > istop).any()):
        _build.PLAIN_CALLS["K11_bf16"] += 1
        active = irsq > istop
        mp = op(ur16, ui16, p, mass, eo)
        denom = _dot32(p, mp, dims)
        alpha = torch.where(active, irsq / torch.clamp_min(denom, 1e-30), 0.0)
        al = bc(alpha).to(torch.bfloat16)
        d = d + al * p
        rr = rr - al * mp
        irsq_new = _dot32(rr, rr, dims)
        beta = torch.where(active, irsq_new / torch.clamp_min(irsq, 1e-30),
                           0.0)
        p = rr + bc(beta).to(torch.bfloat16) * p
        irsq = torch.where(active, irsq_new, irsq)
        k += 1
    return d, k


class _InnerBF16:
    """The inner solve of one mixed solve, A d = r from d = 0 on bf16: on
    the card one bound K11_bf16 launch (r copied into its bf16 b, the
    sweeps to a device counter, no host read), on the CPU its twin. A call
    returns (d bf16, sweeps as a 0-d int64 tensor, odd-site flag)."""

    def __init__(self, cl: bool, ur, ui, like, mass: float, eo: bool):
        self.cl, self.mass, self.eo = cl, mass, eo
        self.ur16, self.ui16 = ur.to(torch.bfloat16), ui.to(torch.bfloat16)
        self.launch = None
        if like.device.type == "cuda":
            B = like.shape[-1] if cl else like.shape[0]
            self.r16 = torch.empty_like(like, dtype=torch.bfloat16)
            self.d16 = torch.empty_like(self.r16)
            rel = torch.empty(B, dtype=torch.float32, device=like.device)
            self.counters = torch.zeros(3, dtype=torch.int32,
                                        device=like.device)
            self.launch = cg_launch(cl, self.ur16, self.ui16, self.r16, None,
                                    mass, eo, MIXED_INNER_TOL,
                                    MIXED_INNER_MAX, self.d16, rel,
                                    self.counters)

    def __call__(self, r):
        if self.launch is None:
            d, k = cg_planes_bf16_plain(self.ur16, self.ui16,
                                        r.to(torch.bfloat16), self.mass,
                                        MIXED_INNER_TOL, MIXED_INNER_MAX,
                                        self.eo, self.cl)
            return d, torch.tensor(k), torch.tensor(0)
        self.r16.copy_(r)
        self.counters.zero_()
        self.launch()
        return (self.d16, self.counters[0].to(torch.int64),
                self.counters[2].to(torch.int64))


@torch.no_grad()
def cg_solve_mixed(theta: torch.Tensor, b: torch.Tensor, mass: float,
                   x0: torch.Tensor | None = None, *, tol: float = 1e-8,
                   maxiter: int = 1000, eo: bool = True,
                   layout: str = "auto") -> CGResult:
    """The mixed-precision CG, the counterpart of ``_cg_solve_mixed``: an
    fp32 refinement loop (defect correction) around a bf16 inner solve.
    Each cycle takes the fp32 true residual r = b - A x (K9 'cf' / K10
    'cl'), solves A d = r on bf16 storage to an rsq reduction of
    MIXED_INNER_TOL in at most MIXED_INNER_MAX sweeps (K11_bf16), and adds
    d to x on the chains still above tol (converged chains freeze). On the
    CPU the twins run. The loop reads the device once a cycle (whether a
    chain is still above tol, the iterations so far, K11's odd-site flag)
    and once before the first; ``iters`` counts operator applications as
    JAX does, sweeps + 1 a cycle. Complex in and out, either rank; eo's b
    and x0 must vanish on the odd sites, as for ``cg_solve_fused``."""
    op, b4, x4, squeeze = _packed(theta, b, x0, layout)
    cl = op.chains_last
    if eo and _on_cpu(b4):
        _, odd = parity_masks(theta.shape[-2], theta.shape[-1], int(cl),
                              b4.device)
        if any(bool((t * odd).ne(0).any()) for t in (b4, x4)
               if t is not None):
            raise ValueError(_ODD_SITES)
    apply = mdagm_cl if cl else mdagm
    inner = _InnerBF16(cl, op.ur, op.ui, b4, mass, eo)
    dims, bc = _chain_dims(cl)
    bsq = (b4 * b4).sum(dim=dims)
    stop = tol * bsq
    x = torch.zeros_like(b4) if x4 is None else x4.clone()
    r = b4 - apply(op.ur, op.ui, x, mass, eo)
    rsq = (r * r).sum(dim=dims)
    k = torch.zeros((), dtype=torch.int64, device=b4.device)
    odd = torch.zeros_like(k)
    reads = 0
    while True:
        go, iters, bad = torch.stack(((rsq > stop).any().to(k.dtype), k,
                                      odd)).tolist()
        reads += 1
        if bad:
            raise ValueError(_ODD_SITES)
        if not go or iters >= maxiter:
            break
        active = rsq > stop
        d, ki, flag = inner(r)
        x = x + bc(active.to(x.dtype)) * d.to(x.dtype)
        r = b4 - apply(op.ur, op.ui, x, mass, eo)
        rsq = torch.where(active, (r * r).sum(dim=dims), rsq)
        k = k + ki.to(k.device) + 1
        odd = odd | flag.to(k.device)
    res = _result(op, x, iters, rsq / torch.clamp_min(bsq, 1e-30), squeeze)
    return res._replace(reads=reads)
