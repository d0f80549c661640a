"""K6, the fused coupling-layer forward, its plain twin, the kernels' band
plan and support envelope, and the launch path K6/K7/K8 share.

Replaces the TPU kernel ``fthmc_tpu/ops/pallas_coupling.py::_ncp_kernel``
(``pallas_link_coupling_forward``, driven by ``pallas_flow_forward``).
CUDA source: ``csrc/coupling_fwd.cu`` (with ``csrc/coupling_common.cuh``):
a thread-block cluster per chain, each CTA a band of rows (``band_plan``),
the conv chain's activations kept in the bands' shared memory with halo
rows exchanged between neighbours, the last conv computed on the active
stripe alone (``stripe_items``). Bound on the card: the conv flops the
layer's outputs depend on (the last conv on the active stripe, the one
before on its one-site halo: 285 MFLOP per launch at the flagship's widths,
16^2 and 64 chains; the kernel runs 361, the dense chain 481); the bytes
it must move are ~100x smaller. The energy flows of FT-HMC (y = f(z)
before and after a trajectory) run through it.

The launch path is made once per (layer, shape, dtype, device): the full
envelope check, the ctypes arguments (widths, band plan, pointers) and the
layer's convs packed in the kernels' staging order (``pack_conv``) are
cached (``launch_args``) for as long as the layer's tensors live and stay
as they were, so a new input of any kind is checked again. Every K6/K7
launch goes through ``forward_call``, which counts it: the wrappers (one
output buffer a call), the flow forward of the energies and the FT force
(one workspace a flow, raw pointers), and adds the conv multiply-adds
the launch runs (``launch_macs``) to ``_build.CONV_MACS``.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from functools import lru_cache

import torch

from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.models.coupling import (CouplingOut,
                                             link_coupling_forward)
from fthmc_tpu_torch.models.masks import layer_mask_params
from fthmc_tpu_torch.ops import _build

__all__ = ["coupling_forward", "coupling_forward_plain",
           "kernel_flow_forward", "kernel_fits", "band_plan", "smem_bytes",
           "launch_args", "forward_call", "pack_conv", "stripe_items",
           "launch_macs"]

ACT_CODES = {"relu": 0, "silu": 1, "swish": 1, "leaky_relu": 2, "tanh": 3}
MAX_BANDS = 8            # CTAs a chain's cluster (csrc/coupling_common.cuh)
KS = 4                   # sites, and output channels, of a conv thread item


def band_plan(L: int, B: int, n_sm: int) -> tuple[int, tuple[int, ...]]:
    """The cluster one chain runs on: (C, row0), CTA r of the C owning rows
    [row0[r], row0[r + 1]) of the lattice for every channel, so B x C CTAs
    make the grid. C is a power of two up to MAX_BANDS: bands of 8 rows
    (an item for each of a CTA's threads in a 32-channel conv at 16^2),
    then twice the bands while B x C is under half the card's ``n_sm`` SMs
    and the bands keep 2 rows; bands differ by at most one row (L = 20 at
    C = 8: 2 and 3 rows in turn). The H100 times of K6-K8 under every plan
    at the paths' shapes: PERF.md section 6."""
    C = 1
    while 2 * C <= min(MAX_BANDS, L // 8):
        C *= 2
    while B * C < n_sm // 2 and 2 * C <= min(MAX_BANDS, L // 2):
        C *= 2
    return C, tuple(r * L // C for r in range(C + 1))


sm_count = _build.sm_count


def stripe_items(r0: int, R: int, L: int, mu: int,
                 off: int) -> tuple[int, int, int, int, int, int]:
    """The thread items of K6/K7's last conv in the band of own rows
    [r0, r0 + R), which lie on the layer's active stripe (the kernels'
    ``items_of`` under CONV_TO_STRIPE, csrc/coupling_common.cuh): (nrows,
    r_first, r_step, ngroups, j_first, step), an item being 4 output
    channels x 4 sites of own row r_first + k r_step (k < nrows), sites
    j0 + s step from j0 = j_first + 4 g step (g < ngroups). mu = 1: the
    band's active rows, consecutive sites; mu = 0: every row, its L / 4
    active sites 4 at a time at stride 4 (a site at or past L repeats the
    item's first: its sums are computed, not stored)."""
    o = off % 4
    if mu == 1:
        first = (o - r0) % 4
        return ((R - 1 - first) // 4 + 1 if first < R else 0, first, 4,
                L // KS, 0, 1)
    return R, 0, 1, -(-(L // 4) // KS), o, 4


@lru_cache(maxsize=None)
def launch_macs(widths: tuple[int, ...], L: int, B: int,
                row0: tuple[int, ...], mu: int, off: int) -> tuple[int, int]:
    """Conv multiply-adds one launch runs, (K6 or K7, K8), for B chains
    of L^2 sites under the band plan's ``row0`` on layer (mu, off), each
    conv's outputs padded to a multiple of 4 as the kernels' items are:
    every conv dense but two. K6/K7's last runs on ``stripe_items``' sites;
    K8's first transposed conv sums, at each site, the taps whose input
    site is on the active stripe (3 of 9 where any is, for 3 sites in 4)."""
    pad = lambda c: -(-c // KS) * KS
    n = len(widths) - 1
    fwd = sum(L * L * widths[li] * 9 * pad(widths[li + 1])
              for li in range(n - 1))
    bwd = sum(L * L * widths[li + 1] * 9 * pad(widths[li])
              for li in range(n - 1))
    sites = 0
    for a, b in zip(row0, row0[1:]):
        nrows, _, _, ngroups, _, _ = stripe_items(a, b - a, L, mu, off)
        sites += nrows * ngroups * KS
    fwd += sites * widths[n - 1] * 9 * pad(widths[n])
    # the rows (mu = 1) or columns (mu = 0) c whose one tap row or column
    # reaching the stripe, (off + 1 - c) mod 4, is a tap (3 taps a site)
    reach = sum(1 for c in range(L) if (off + 1 - c) % 4 < 3)
    bwd += 3 * L * reach * widths[n] * pad(widths[n - 1])
    return B * fwd, B * bwd


@lru_cache(maxsize=None)
def band_layout(widths: tuple[int, ...], L: int, rows: int,
                limit: int) -> tuple[int, int]:
    """(bytes of dynamic shared memory, floats of device scratch) of one
    K6/K7/K8 CTA with bands of at most ``rows`` rows under a shared-memory
    limit of ``limit`` bytes, as the kernels' own ``choose_layout`` reckons
    it (csrc/coupling_common.cuh): band planes in shared memory where they
    fit, else in the scratch. Bytes -1 for a conditioner the kernels do not
    take (more than their MAX_CONVS convs); bytes over ``limit`` where no
    layout fits."""
    lib = _build.library("coupling_fwd")
    w = _build.int_array(widths)
    n = len(widths) - 1
    return (lib.ft_smem_bytes(n, w, L, rows, limit),
            lib.ft_band_floats(n, w, L, rows, limit))


def smem_bytes(widths: tuple[int, ...], L: int, rows: int,
               limit: int) -> int:
    """Dynamic shared memory of one K6/K7/K8 CTA (``band_layout``)."""
    return band_layout(tuple(widths), L, rows, limit)[0]


def _conv_widths(spec: FlowSpec) -> list[int]:
    M = spec.n_mixture
    out = 2 * M + 1 if spec.coupling == "rncp" else M + 1
    return [2, *spec.hidden_sizes, out]


def kernel_fits(spec: FlowSpec, L: int, B: int) -> bool:
    """The kernels' envelope in the spec and shape alone: ncp/rncp with fp32
    3x3 convs and a ported activation, L a multiple of 4 (the closed-form
    stripe masks), any chain count B (a cluster per chain). This covers the
    JAX package's envelope (L <= 8 or B <= 128, for L a multiple of 4) and
    the flagship's 16^2 and 64^2 shapes. On the card a launch also needs
    one CTA's weights within the device's shared memory;
    ``check_kernel_call`` asks the kernels' library for that and refuses a
    conditioner too wide or too deep. The CPU's plain twins take any."""
    return (spec.coupling in ("ncp", "rncp") and spec.conv_dtype == "float32"
            and spec.kernel_size == 3 and spec.activation in ACT_CODES
            and L % 4 == 0 and L >= 4 and B >= 1)


def pack_conv(w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """One conv in the kernels' staging order (csrc/coupling_common.cuh,
    Net): for the routine's input channel c, tap t = 3 dy + dx and output
    channel o, element (c * 9 + t) * cpad + o, cpad = outputs rounded up to
    4, then cpad biases, zeros past the outputs. Forward (K6/K7) with its
    bias: w (Cout, Cin, 3, 3) as is; the transposed conv of K8 (b None):
    inputs Cout, outputs Cin, element w[c][o][8 - t], zero bias."""
    if b is None:
        w = w.flip(2, 3).transpose(0, 1)
        b = w.new_zeros(w.shape[0])
    rout, rin = w.shape[:2]
    cpad = -(-rout // 4) * 4
    out = w.new_zeros((rin * 9 + 1, cpad))
    out[:rin * 9, :rout] = w.permute(1, 2, 3, 0).reshape(rin * 9, rout)
    out[rin * 9, :rout] = b
    return out.reshape(-1)


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None \
        else torch.cuda.current_device()


def check_kernel_call(what: str, layer, x: torch.Tensor, spec: FlowSpec,
                      plan: tuple[int, tuple[int, ...]] | None = None):
    """Refuse, loudly, what the kernels do not take under the band plan
    ``plan`` (C, row0), by default ``band_plan``'s; returns the plan."""
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
    dev = _device_index(x)
    if plan is None:
        plan = band_plan(L, B, sm_count(dev))
    rows = max(b - a for a, b in zip(plan[1], plan[1][1:]))
    limit = _build.smem_limit(dev)
    need = smem_bytes(tuple(widths), L, rows, limit)
    if not 0 < need <= limit:
        raise ValueError(f"{what}: conv widths {widths} at L={L} need "
                         f"{need} bytes of shared memory a CTA (-1: too "
                         f"many convs); the card allows {limit}")
    return plan


@dataclass(frozen=True)
class LaunchArgs:
    """The ctypes arguments of one layer's K6/K7/K8 launches at one shape,
    and where the wrappers put their outputs in one buffer: fx (B, 2, L, L)
    first, then K7's residuals (each a multiple of 16 floats, so each starts
    16-byte aligned for the kernels' float4 stores), logJ (B,) last."""
    B: int
    L: int
    n: int
    conv_widths: tuple      # ``widths`` as a tuple (``launch_macs``' key)
    plan: tuple             # ``row0`` as a tuple
    widths: object          # int[n + 1]
    w_fwd: object           # void*[n], the convs packed forward
    w_bwd: object           # void*[n], the convs packed transposed
    packed: tuple           # the packed tensors, kept alive
    rncp: int
    M: int
    s_clip: float
    act: int
    C: int
    row0: object            # int[C + 1]
    limit: int
    scratch: int            # floats of device scratch for all the CTAs
    res_shapes: tuple
    split: tuple            # floats of fx, each residual, logJ


# layer tensors' ids, x's shape, dtype, device, spec, plan ->
# (LaunchArgs, the tensors' state when it was made, weakrefs to them)
_LAUNCH_ARGS: dict = {}
_LAUNCH_ARGS_MAX = 4096


def launch_args(what: str, layer, x: torch.Tensor, spec: FlowSpec,
                plan: tuple[int, tuple[int, ...]] | None = None) -> LaunchArgs:
    """The launch arguments of ``layer`` at x's shape under the band plan
    ``plan`` (C, row0), by default ``band_plan``'s; made (after the full
    ``check_kernel_call``) the first time these tensors meet this shape,
    dtype and device, and made again when one of them has changed since:
    its pointer, version (an in-place update), shape, dtype, device or
    contiguity. An entry is keyed on the tensors themselves and dropped as
    soon as one of them is freed, so a later tensor at a freed address (the
    next flow of the same spec) never finds it. A write through ``.data``
    bumps no version and is not seen: give the kernels new tensors instead.
    x's contiguity is checked every call."""
    tensors = [t for p in layer for t in (p["w"], p["b"])]
    key = (tuple(map(id, tensors)), x.shape, x.dtype, x.device, spec, plan)
    state = tuple([(t.data_ptr(), t._version, t.shape, t.dtype, t.device,
                    t.is_contiguous()) for t in tensors])
    hit = _LAUNCH_ARGS.get(key)
    if hit is not None and hit[1] == state:
        if not x.is_contiguous():
            raise ValueError(f"{what}: kernels take contiguous tensors")
        return hit[0]
    C, row0 = check_kernel_call(what, layer, x, spec, plan)
    B, _, L, _ = x.shape
    widths = _conv_widths(spec)
    rows = max(b - a for a, b in zip(row0, row0[1:]))
    limit = _build.smem_limit(_device_index(x))
    floats = band_layout(tuple(widths), L, rows, limit)[1]
    with torch.no_grad():
        fwd = [pack_conv(p["w"], p["b"]) for p in layer]
        bwd = [pack_conv(p["w"], None) for p in layer]
    args = LaunchArgs(
        B=B, L=L, n=len(layer), conv_widths=tuple(widths), plan=tuple(row0),
        widths=_build.int_array(widths),
        w_fwd=_build.ptr_array(fwd), w_bwd=_build.ptr_array(bwd),
        packed=(*fwd, *bwd),
        rncp=int(spec.coupling == "rncp"), M=spec.n_mixture,
        s_clip=float(spec.s_clip) if spec.s_clip is not None else 0.0,
        act=ACT_CODES[spec.activation], C=C,
        row0=_build.int_array(row0), limit=limit, scratch=B * C * floats,
        res_shapes=tuple(torch.Size((B, c, L, L)) for c in widths[1:]),
        split=(2 * B * L * L, *(B * c * L * L for c in widths[1:]), B))

    def drop(_ref, key=key):
        _LAUNCH_ARGS.pop(key, None)
    if len(_LAUNCH_ARGS) >= _LAUNCH_ARGS_MAX:
        _LAUNCH_ARGS.clear()
    _LAUNCH_ARGS[key] = (args, state,
                         tuple(weakref.ref(t, drop) for t in tensors))
    return args


def scratch_for(a: LaunchArgs, x: torch.Tensor):
    """Device scratch of the band planes where they do not fit in shared
    memory (a tensor to keep alive over the launch, and its pointer), or
    (None, None)."""
    if a.scratch == 0:
        return None, None
    s = torch.empty(a.scratch, dtype=x.dtype, device=x.device)
    return s, s.data_ptr()


def forward_call(a: LaunchArgs, x: int, fx: int, logj: int, res,
                 scratch, mu: int, off: int, stream: int) -> None:
    """One launch of the coupling forward entry on device pointers, counted
    with the conv multiply-adds it runs: K6 (``res`` None) or K7 (``res``
    a C array of the residual outputs). Every K6 and K7 launch of the port
    goes through here."""
    lib = _build.library("coupling_fwd")
    rc = lib.ft_coupling_forward(x, fx, logj, res, scratch, a.B, a.L, a.n,
                                 a.widths, a.w_fwd, a.rncp, a.M, a.s_clip,
                                 a.act, mu, off, a.C, a.row0, a.limit, stream)
    _build.check(rc, "ft_coupling_forward", lib)
    name = "K6" if res is None else "K7"
    _build.LAUNCHES[name] += 1
    _build.CONV_MACS[name] += launch_macs(a.conv_widths, a.L, a.B, a.plan,
                                          mu, off)[0]


def launch_forward(a: LaunchArgs, x: torch.Tensor, mu: int, off: int,
                   residuals: bool):
    """The forward entry into one new buffer (``LaunchArgs``): K6, or K7
    with ``residuals``. Returns (fx, logJ, residuals or ())."""
    split = a.split if residuals else (a.split[0], a.B)
    parts = torch.empty(sum(split), dtype=x.dtype, device=x.device) \
        .split(split)
    res = tuple(p.view(s) for p, s in zip(parts[1:-1], a.res_shapes))
    _scratch, scratch = scratch_for(a, x)
    forward_call(a, x.data_ptr(), parts[0].data_ptr(), parts[-1].data_ptr(),
                 _build.ptr_array(res) if residuals else None, scratch, mu,
                 off, _build.stream_handle(x))
    return parts[0].view(x.shape), parts[-1], res


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
    a = launch_args("K6 coupling forward", layer, x, spec)
    fx, logj, _ = launch_forward(a, x, mu, off, False)
    return CouplingOut(fx, logj)


def kernel_flow_forward(params, x: torch.Tensor, spec: FlowSpec):
    """Whole flow forward through K6, one launch per layer (the plain twin
    on the CPU): x (B, 2, L, L) -> (y, logdet (B,)). Not differentiable."""
    if x.device.type == "cuda" and params:
        return _flow_forward_cuda(params, x, spec)
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, layer in enumerate(params):
        mu, off = layer_mask_params(i)
        x, logJ = coupling_forward(layer, x, mu, off, spec)
        logdet = logdet + logJ
    return x, logdet


def _flow_forward_cuda(params, x: torch.Tensor, spec: FlowSpec):
    """kernel_flow_forward on the card through one workspace: two fields
    the layers write in turn, the band scratch (both 16-byte aligned) and
    every layer's logJ, so a launch costs the host the layer's cached
    arguments and one ctypes call. logdet adds the layers' logJ in their
    order, as the CPU path does."""
    args = [launch_args("K6 coupling forward", layer, x, spec)
            for layer in params]
    n, B, field = len(params), args[0].B, args[0].split[0]
    scratch = args[0].scratch        # the same for every layer
    lj0 = 2 * field + scratch
    ws = torch.empty(lj0 + n * B, dtype=x.dtype, device=x.device)
    base = ws.data_ptr()
    sp = base + 4 * 2 * field if scratch else None
    stream = _build.stream_handle(x)
    src = x.data_ptr()
    for i in range(n):
        mu, off = layer_mask_params(i)
        dst = base + 4 * field * (i & 1)
        forward_call(args[i], src, dst, base + 4 * (lj0 + B * i), None, sp,
                     mu, off, stream)
        src = dst
    last = (n - 1) & 1
    logj = ws[lj0:].view(n, B)
    logdet = torch.zeros(B, dtype=x.dtype, device=x.device)
    for i in range(n):
        logdet = logdet + logj[i]
    return ws[field * last:field * (last + 1)].view(x.shape), logdet
