"""The CUDA kernels on the card, against their plain twins, at small shapes
and at the shapes the sampling paths give them.

Marked ``cuda``: each test skips without a card. This file, like the card
suite's other files (``tests/test_torch_card_*.py``, the paths, training
and the entry points), imports only torch, numpy and the port, so the
suite also runs on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py tests/test_torch_card_*.py

fp32 bounds: sum-order roundoff through the conv chain (fx wrapped 1e-4,
logJ 1e-4 relative, gx 2e-3 * max|ref| as the JAX package's own fp32
kernel tests use); the trajectory kernels K2-K5 repeat their twins'
arithmetic op for op, so x and v within 1e-4 (wrapped) and 1e-4 x max|v|,
dH within ``dh_tolerance`` (sum order), and the accept equal except where
u lies within that bound of exp(-dH)."""
import math

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch.config import FlowSpec, HMCConfig
from fthmc_tpu_torch.models.flow import init_flow_params
from fthmc_tpu_torch.ops import _build, rng
from fthmc_tpu_torch.ops import lattice_kernels as lk
from fthmc_tpu_torch.ops._build import smem_limit
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_kernels import (band_layout, band_plan,
                                                  coupling_forward,
                                                  coupling_forward_plain,
                                                  smem_bytes)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (coupling_bwd,
                                                      coupling_bwd_plain,
                                                      coupling_fwd_res,
                                                      coupling_fwd_res_plain)
from fthmc_tpu_torch.ops.lattice_kernels import force, force_plain
from fthmc_tpu_torch.weights import load_flow_npz

pytestmark = pytest.mark.cuda

SPECS = [FlowSpec(n_layers=2, coupling="ncp", n_mixture=3,
                  hidden_sizes=(8,), activation="tanh"),
         FlowSpec(n_layers=2, coupling="rncp", n_mixture=8,
                  hidden_sizes=(32, 32), s_clip=3.0),
         # one conv: the last of K6/K7 and the first transposed of K8 at once
         FlowSpec(n_layers=2, coupling="rncp", n_mixture=4, hidden_sizes=(),
                  s_clip=3.0)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the flagship FT-HMC configuration: chains, L, beta, tau, Omelyan steps
FT_B, FT_L, FT_BETA, FT_TAU, FT_NSTEP = 64, 16, 6.0, 0.5, 8


@pytest.fixture(scope="module")
def flagship(card):
    """The exported flagship flow on the card and z0 = f^-1(0) at the
    flagship's shape: (params, spec, z0)."""
    from fthmc_tpu_torch.models.flow import flow_reverse
    params, spec = load_flow_npz(device=card)
    z0, _ = flow_reverse(params, torch.zeros((FT_B, 2, FT_L, FT_L),
                                             device=card), spec)
    return params, spec, z0


def _wrapped(a, b):
    return float((torch.remainder(a - b + math.pi, 2 * math.pi)
                  - math.pi).abs().max())


def near_equilibrium(g, B, L, beta, dev):
    """Links with Gaussian angles of variance 1 / (4 beta), so a plaquette
    (four links) has about the variance of beta's equilibrium: trajectories
    from here are accepted or rejected as the main path's are."""
    return torch.randn((B, 2, L, L), generator=g, device=dev) / \
        math.sqrt(4 * beta)


def _counted(fn):
    """(fn(), launches, plain twin calls), the launch counters set to 0
    just before it and read just after."""
    _build.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)


def _expect(**counts) -> dict:
    """Every kernel's launches: ``counts``, the rest 0."""
    return {**dict.fromkeys(_build.KERNELS, 0), **counts}


def _ft_launches(n_force: int, n_layers: int, ntraj: int) -> dict:
    """An FT-HMC run's launches: K1, K7 and K8 a force (K7/K8 a layer), K6
    a layer an energy flow (two a trajectory and the start's charge)."""
    return {"K1": n_force * ntraj, "K6": n_layers * (2 * ntraj + 1),
            "K7": n_force * n_layers * ntraj,
            "K8": n_force * n_layers * ntraj}


# The plain-HMC headline, fthmc_tpu/bench.py:42-76: 64^2, beta=6, tau=1,
# 25 steps (dt=0.04), 1024 chains, cold start; its beta, dt and steps
HEADLINE_CFG = HMCConfig(beta=6.0, L=64, tau=1.0, nstep=25, n_chains=1024,
                         randinit=False, seed=0)
HEADLINE = (HEADLINE_CFG.beta, HEADLINE_CFG.dt, HEADLINE_CFG.nstep)


# one shape for each band plan (coupling_kernels.band_plan on 132 SMs):
# (64, 16) 2 bands of 8 rows, the flagship; (128, 16) path C's; (32, 16) 4
# of 4 rows; (2, 64) 8 of 8 rows; (3, 20) 8 ragged bands of 2 and 3 rows;
# (4, 8) 4 of 2 rows
GRID = [(4, 8), (3, 20), (64, 16), (128, 16), (32, 16), (2, 64)]
# the exported flows on every layer at the shapes the paths give them: the
# flagship flow at the flagship's 16^2 x 64, path C's 16^2 x 128 and 64^2
# x 8 (8-row bands); the sampler's flows at 8^2 x 4096 (the 16-layer ncp)
# and 8^2 x 512 (the flagship's width)
EXPORTED = [("flow8x8_b3_rncp24_ftb6", 64, 16),
            ("flow8x8_b3_rncp24_ftb6", 128, 16),
            ("flow8x8_b3_rncp24_ftb6", 8, 64),
            ("flow8x8_b2_16l_long", 4096, 8), ("flow8x8_b3_rncp24", 512, 8)]


@pytest.mark.parametrize("spec,B,L", [(spec, B, L) for spec in SPECS
                                      for B, L in GRID] + EXPORTED)
def test_kernels_match_plain_twins(card, spec, B, L):
    from fthmc_tpu_torch.models.masks import layer_mask_params
    g = torch.Generator(device=card).manual_seed(0)
    if isinstance(spec, str):
        # an exported flow: every layer with its own (mu, off)
        params, spec = load_flow_npz(device=card, name=spec)
        layers = [(params[li], *layer_mask_params(li))
                  for li in range(len(params))]
    else:
        # every (mu, off) a flow's layers take, layer mu's weights for mu
        params = init_flow_params(spec, torch.Generator().manual_seed(1),
                                  device=card)
        layers = [(params[m], m, o) for o in range(4) for m in (0, 1)]
    x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1) * math.pi
    gy = torch.randn((B, 2, L, L), generator=g, device=card)
    gl = torch.randn((B,), generator=g, device=card)
    before = dict(_build.LAUNCHES)
    with full_fp32():
        f = force(x, 2.0)
        assert float((f - force_plain(x, 2.0)).abs().max()) < 1e-5
        for layer, mu, off in layers:
            fx, lj = coupling_forward(layer, x, mu, off, spec)
            fx_p, lj_p = coupling_forward_plain(layer, x, mu, off, spec)
            assert _wrapped(fx, fx_p) < 1e-4
            assert float((lj - lj_p).abs().max()) < \
                1e-4 * max(1.0, float(lj_p.abs().max()))
            fx7, lj7, res = coupling_fwd_res(layer, x, mu, off, spec)
            fx7_p, lj7_p, res_p = coupling_fwd_res_plain(layer, x, mu, off,
                                                         spec)
            assert _wrapped(fx7, fx7_p) < 1e-4
            assert float((lj7 - lj7_p).abs().max()) < \
                1e-4 * max(1.0, float(lj7_p.abs().max()))
            assert torch.equal(lj7, lj)
            for r, r_p in zip(res, res_p):
                assert float((r - r_p).abs().max()) < \
                    1e-4 * max(1.0, float(r_p.abs().max()))
            gx = coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
            gx_p = coupling_bwd_plain(layer, x, res_p, gy, gl, mu, off, spec)
            torch.cuda.synchronize()
            assert float((gx - gx_p).abs().max()) < \
                2e-3 * max(1.0, float(gx_p.abs().max()))
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    n = len(layers)
    assert launched == {"K1": 1, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                        "K6": n, "K7": n, "K8": n, "K9": 0, "K10": 0,
                        "K11": 0, "K11_bf16": 0, "K12": 0}


@pytest.mark.parametrize("B,L", [(64, 16), (3, 20), (4, 8)])
@pytest.mark.parametrize("mu", [0, 1])
def test_k8_reads_the_last_residual_on_the_stripe_only(card, B, L, mu):
    """K7 stores its last residual as 0 off the active stripe, and K8 never
    reads it there: with NaN in its place, the same gx bit for bit."""
    from fthmc_tpu_torch.models.coupling import _masks
    spec = SPECS[1]
    params, x, gy, gl = _layer_inputs(card, spec, B, L, seed=5)
    for off in range(4):
        layer = params[mu]
        active = _masks((L, L), mu, off, x.dtype, card)[1] > 0
        with full_fp32():
            _, _, res = coupling_fwd_res(layer, x, mu, off, spec)
            nan = res[-1].masked_fill(~active, float("nan"))
            gx = coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
            gx_nan = coupling_bwd(layer, x, (*res[:-1], nan), gy, gl, mu,
                                  off, spec)
        torch.cuda.synchronize()
        assert bool((res[-1][:, :, ~active] == 0).all())
        assert torch.equal(gx, gx_nan)


def test_shared_memory_envelope(card):
    limit = smem_limit(card.index or 0)
    # one flagship CTA (8-row band at 16^2): a 32x32 conv's weights + bias,
    # 32 reduction floats, two 32-channel activation buffers of 10 x 24
    # planes and K8's 10 x 16 plaquette cotangents, as the kernels'
    # smem_layout says; and a 4-row band's
    flagship = (2, 32, 32, 17)
    assert smem_bytes(flagship, 16, 8, limit) == \
        4 * (9216 + 32 + 32 + 2 * 32 * 10 * 24 + 10 * 16)
    assert smem_bytes(flagship, 16, 4, limit) == \
        4 * (9216 + 32 + 32 + 2 * 32 * 6 * 24 + 6 * 16)
    assert band_layout(flagship, 16, 8, limit)[1] == 0      # no scratch
    # 64^2, 8-row bands: the planes still fit
    assert smem_bytes(flagship, 64, 8, limit) == \
        4 * (9216 + 32 + 32 + 2 * 32 * 10 * 72 + 10 * 64)
    assert band_layout(flagship, 64, 8, limit)[1] == 0
    # 128^2: the planes go to device scratch
    assert smem_bytes(flagship, 128, 16, limit) == 4 * (9216 + 32 + 32)
    assert band_layout(flagship, 128, 16, limit)[1] == \
        2 * 32 * 18 * 136 + 18 * 128
    assert smem_bytes(tuple([2] + [4] * 8 + [3]), 8, 2, limit) == -1
    # past the limit even with one weight buffer and the planes in scratch
    wide = FlowSpec(n_layers=1, hidden_sizes=(128, 128))
    assert smem_bytes((2, 128, 128, 3), 16, 4, limit) > limit
    params = init_flow_params(wide, torch.Generator().manual_seed(1),
                              device=card)
    z = torch.zeros((2, 2, 16, 16), device=card)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        coupling_forward(params[0], z, 0, 0, wide)
    # 'auto' on the card is the kernels: a run they do not take raises
    # instead of falling back to the autograd force
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.zeros(2, device=card)
    with pytest.raises(ValueError):
        th.fthmc_step(params, wide, gen, z, q, 2.0, 0.1, 2)
    with pytest.raises(ValueError):
        th.fthmc_step(params, wide, gen, z.double(), q, 2.0, 0.1, 2)
    assert dict(_build.LAUNCHES) == before


def _layer_inputs(card, spec, B, L, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    params = init_flow_params(spec, torch.Generator().manual_seed(seed + 1),
                              device=card)
    x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1) * math.pi
    gy = torch.randn((B, 2, L, L), generator=g, device=card)
    gl = torch.randn((B,), generator=g, device=card)
    return params, x, gy, gl


@pytest.mark.parametrize("B,L", [(64, 16), (3, 20)])
def test_two_launches_are_bit_equal(card, B, L):
    """The kernels sum in a fixed order (no float atomics): a second launch
    on the same input gives the same bits, and K6's logJ is K7's."""
    spec = SPECS[1]
    params, x, gy, gl = _layer_inputs(card, spec, B, L)
    for li, layer in enumerate(params):
        mu, off = li % 2, li
        with full_fp32():
            runs = []
            for _ in range(2):
                fx6, lj6 = coupling_forward(layer, x, mu, off, spec)
                fx7, lj7, res = coupling_fwd_res(layer, x, mu, off, spec)
                gx = coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
                runs.append((fx6, lj6, fx7, lj7, *res, gx))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        assert torch.equal(runs[0][1], runs[0][3])
        assert torch.equal(runs[0][0], runs[0][2])


# (spec, B, L) of the lean launch paths: the planes in shared memory, and
# (48 channels at 64^2, an odd chain count) in device scratch
LEAN_CASES = {
    "smem": (FlowSpec(n_layers=4, coupling="rncp", n_mixture=8,
                      hidden_sizes=(32, 32), s_clip=3.0), 6, 20),
    "scratch": (FlowSpec(n_layers=3, coupling="rncp", n_mixture=4,
                         hidden_sizes=(48, 48), s_clip=3.0,
                         activation="tanh"), 3, 64)}


@pytest.mark.parametrize("case", sorted(LEAN_CASES))
def test_force_launch_path_equals_the_wrappers(card, case):
    """flow_vjp_kernel's lean launch path (one workspace, raw pointers) and
    the per-layer wrappers run the same kernels on the same inputs: equal
    bits, and one K7 and one K8 launch a layer."""
    from fthmc_tpu_torch.models.masks import layer_mask_params
    from fthmc_tpu_torch.ops.coupling_vjp_kernels import flow_vjp_kernel
    spec, B, L = LEAN_CASES[case]
    params, x, gy, _ = _layer_inputs(card, spec, B, L, seed=7)
    before = dict(_build.LAUNCHES)
    with full_fp32():
        got = flow_vjp_kernel(params, spec, x, lambda y: y * gy)
        xs, res, y = [], [], x
        for i, layer in enumerate(params):
            mu, off = layer_mask_params(i)
            xs.append(y)
            y, _, r = coupling_fwd_res(layer, y, mu, off, spec)
            res.append(r)
        g = y * gy
        gl = torch.full((B,), -1.0, device=card)
        for i in range(len(params) - 1, -1, -1):
            mu, off = layer_mask_params(i)
            g = coupling_bwd(params[i], xs[i], res[i], g, gl, mu, off, spec)
    torch.cuda.synchronize()
    assert torch.equal(got, g)
    assert _build.LAUNCHES["K7"] - before["K7"] == 2 * spec.n_layers
    assert _build.LAUNCHES["K8"] - before["K8"] == 2 * spec.n_layers


def test_stream_handle_is_the_current_stream(card):
    x = torch.zeros(1, device=card)
    assert _build.stream_handle(x) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_handle(x) == side.cuda_stream


def test_next_flow_of_a_spec_gets_its_own_weights(card):
    """A flow freed and the next flow of the same spec made at the same
    shape (its tensors may take the freed addresses): K6, K7, K8, the flow
    forward and the force run on the new flow's weights, as its twins do."""
    import gc
    from fthmc_tpu_torch.models.masks import layer_mask_params
    from fthmc_tpu_torch.ops.coupling_kernels import kernel_flow_forward
    from fthmc_tpu_torch.ops.coupling_vjp_kernels import flow_vjp_kernel
    spec = SPECS[1]
    B, L = 16, 16
    first, x, gy, gl = _layer_inputs(card, spec, B, L, seed=4)
    with full_fp32():
        for i, layer in enumerate(first):
            mu, off = layer_mask_params(i)
            _, _, res = coupling_fwd_res(layer, x, mu, off, spec)
            coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
        kernel_flow_forward(first, x, spec)
        flow_vjp_kernel(first, spec, x, lambda y: y * gy)
    del first, layer, res
    gc.collect()
    torch.cuda.synchronize()
    params = init_flow_params(spec, torch.Generator().manual_seed(9),
                              device=card)
    with full_fp32():
        y, logdet = kernel_flow_forward(params, x, spec)
        y_p, ld_p = x, torch.zeros(B, device=card)
        for i, layer in enumerate(params):
            mu, off = layer_mask_params(i)
            fx, lj = coupling_forward(layer, x, mu, off, spec)
            fx_p, lj_p = coupling_forward_plain(layer, x, mu, off, spec)
            fx7, _, res = coupling_fwd_res(layer, x, mu, off, spec)
            _, _, res_p = coupling_fwd_res_plain(layer, x, mu, off, spec)
            gx = coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
            gx_p = coupling_bwd_plain(layer, x, res_p, gy, gl, mu, off, spec)
            torch.cuda.synchronize()
            assert _wrapped(fx, fx_p) < 1e-4 and _wrapped(fx7, fx_p) < 1e-4
            assert float((lj - lj_p).abs().max()) < \
                1e-4 * max(1.0, float(lj_p.abs().max()))
            for r, r_p in zip(res, res_p):
                assert float((r - r_p).abs().max()) < \
                    1e-4 * max(1.0, float(r_p.abs().max()))
            assert float((gx - gx_p).abs().max()) < \
                2e-3 * max(1.0, float(gx_p.abs().max()))
            y_p, lj_p = coupling_forward_plain(layer, y_p, mu, off, spec)
            ld_p = ld_p + lj_p
        assert _wrapped(y, y_p) < 1e-4
        assert float((logdet - ld_p).abs().max()) < \
            1e-4 * max(1.0, float(ld_p.abs().max()))
        # the whole chain on the new flow against its twins' chain (CPU)
        got = flow_vjp_kernel(params, spec, x, lambda y: y * gy)
        cpu = [[{k: v.cpu() for k, v in c.items()} for c in layer]
               for layer in params]
        want = flow_vjp_kernel(cpu, spec, x.cpu(), lambda y: y * gy.cpu())
    assert float((got.cpu() - want).abs().max()) < \
        2e-3 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("case", sorted(LEAN_CASES))
def test_flow_forward_launch_path_equals_the_wrappers(card, case):
    """kernel_flow_forward's lean launch path (one workspace, raw pointers)
    and the per-layer K6 wrapper: equal bits, logdet summed in the layers'
    order, and one K6 launch a layer."""
    from fthmc_tpu_torch.models.masks import layer_mask_params
    from fthmc_tpu_torch.ops.coupling_kernels import kernel_flow_forward
    spec, B, L = LEAN_CASES[case]
    params, x, _, _ = _layer_inputs(card, spec, B, L, seed=8)
    before = _build.LAUNCHES["K6"]
    with full_fp32():
        y, logdet = kernel_flow_forward(params, x, spec)
        assert _build.LAUNCHES["K6"] - before == spec.n_layers
        ref, ld = x, torch.zeros(B, device=card)
        for i, layer in enumerate(params):
            mu, off = layer_mask_params(i)
            ref, lj = coupling_forward(layer, ref, mu, off, spec)
            ld = ld + lj
    torch.cuda.synchronize()
    assert torch.equal(y, ref) and torch.equal(logdet, ld)


def test_band_planes_in_device_scratch_match_twins(card):
    """A conditioner whose band planes do not fit in shared memory (48
    channels, 8-row bands of 64^2) keeps them in device scratch: the same
    results as the twins."""
    spec = FlowSpec(n_layers=2, coupling="rncp", n_mixture=4,
                    hidden_sizes=(48, 48), s_clip=3.0, activation="tanh")
    B, L = 2, 64
    C, row0 = band_plan(L, B, torch.cuda.get_device_properties(card)
                        .multi_processor_count)
    assert (C, row0[1]) == (8, 8)
    assert band_layout((2, 48, 48, 9), L, 8, smem_limit(card.index or 0))[1] \
        > 0
    params, x, gy, gl = _layer_inputs(card, spec, B, L, seed=3)
    with full_fp32():
        for mu, off in ((0, 1), (1, 2)):
            layer = params[mu]
            fx, lj = coupling_forward(layer, x, mu, off, spec)
            fx_p, lj_p = coupling_forward_plain(layer, x, mu, off, spec)
            fx7, lj7, res = coupling_fwd_res(layer, x, mu, off, spec)
            _, _, res_p = coupling_fwd_res_plain(layer, x, mu, off, spec)
            gx = coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
            gx_p = coupling_bwd_plain(layer, x, res_p, gy, gl, mu, off, spec)
            torch.cuda.synchronize()
            assert _wrapped(fx, fx_p) < 1e-4 and _wrapped(fx7, fx_p) < 1e-4
            assert float((lj - lj_p).abs().max()) < \
                1e-4 * max(1.0, float(lj_p.abs().max()))
            assert torch.equal(lj, lj7)
            for r, r_p in zip(res, res_p):
                assert float((r - r_p).abs().max()) < \
                    1e-4 * max(1.0, float(r_p.abs().max()))
            assert float((gx - gx_p).abs().max()) < \
                2e-3 * max(1.0, float(gx_p.abs().max()))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    spec = SPECS[1]
    params = init_flow_params(spec, torch.Generator().manual_seed(1),
                              device=card)
    x = torch.zeros((2, 2, 8, 8), device=card)
    with pytest.raises(TypeError):
        force(x.double(), 1.0)
    with pytest.raises(ValueError):
        force(x.transpose(2, 3), 1.0)
    with pytest.raises(ValueError):   # L not a multiple of 4
        coupling_forward(params[0], torch.zeros((2, 2, 6, 6), device=card),
                         0, 0, spec)
    cpu_layer = [{k: v.cpu() for k, v in c.items()} for c in params[0]]
    with pytest.raises(ValueError):   # weights on another device
        coupling_fwd_res(cpu_layer, x, 0, 0, spec)


def test_fthmc_step_kernel_backend_matches_autograd(card):
    spec = SPECS[1]
    params = init_flow_params(spec, torch.Generator().manual_seed(2),
                              device=card)
    z = (torch.rand((8, 2, 8, 8), generator=torch.Generator(
        device=card).manual_seed(3), device=card) * 2 - 1) * math.pi
    q = torch.zeros(8, device=card)
    out = {}
    for backend in ("kernel", "autograd"):
        gen = torch.Generator(device=card).manual_seed(4)
        out[backend] = th.fthmc_step(params, spec, gen, z, q, 2.0, 0.05, 4,
                                     integrator="omelyan",
                                     force_backend=backend)
    mk, ma = out["kernel"][3], out["autograd"][3]
    assert float((mk.dh - ma.dh).abs().max()) < 1e-3
    assert _wrapped(out["kernel"][0], out["autograd"][0]) < 1e-3


def _close_traj(got, ref, x0, v0, u, beta, dt, nstep):
    """K4/K5 output against the twin's: dH within dh_tolerance, the accept
    equal except where u is within that of exp(-dH), x' (wrapped) where it
    is equal."""
    tol = lk.dh_tolerance(x0, v0, beta, dt, nstep)
    (xk, dhk, acck), (xp, dhp, accp) = got, ref
    assert bool(((dhk - dhp).abs() <= tol).all())
    same = acck == accp
    border = (u - torch.exp(-dhp)).abs() <= tol * torch.exp(-dhp)
    assert bool((same | border).all())
    assert _wrapped(xk[same], xp[same]) < 1e-4


def _traj_inputs(card, B, L, physics, seed):
    """(x, v, u, K4's seed, beta, dt) of a trajectory kernel case: 'hot'
    uniform links at beta = 2, dt = 0.1; 'headline' near-equilibrium links
    at the headline's beta and dt."""
    g = torch.Generator(device=card).manual_seed(seed)
    if physics == "hot":
        beta, dt = 2.0, 0.1
        x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1) \
            * math.pi
    else:
        beta, dt, _ = HEADLINE
        x = near_equilibrium(g, B, L, beta, card)
    v = torch.randn((B, 2, L, L), generator=g, device=card)
    u = torch.rand((B,), generator=g, device=card)
    seed = torch.tensor([12345], dtype=torch.int32, device=card)
    return x, v, u, seed, beta, dt


# the hot cases; then the headline (64^2 x 1024), K2-K5 above what one CTA
# holds (128^2 and 256^2 at 16 chains, bands in a cluster) and the shapes
# of a launch of the headline's sites (128^2 x 256, 256^2 x 64), all at the
# headline's beta, dt and steps
@pytest.mark.parametrize("B,L,nstep,physics", [
    (8, 8, 6, "hot"), (12, 20, 10, "hot"), (4, 64, 3, "hot"),
    (4, 128, 3, "hot"), (2, 256, 2, "hot"), (1024, 64, 25, "headline"),
    (16, 128, 25, "headline"), (16, 256, 25, "headline"),
    (256, 128, 25, "headline"), (64, 256, 25, "headline")])
def test_trajectory_kernels_match_plain_twins(card, B, L, nstep, physics):
    """K2, K4 and K5 under the default plan and, at the hot shapes up to
    64^2 and at the headline's, under every plan of L (traj_plans); K3
    likewise (its plans of chain tiles, traj_plans(L, K3_TILES)), bit-equal
    to its twin."""
    x, v, u, seed, beta, dt = _traj_inputs(card, B, L, physics, 0)
    sweep = L <= 64 or physics == "headline"
    plans = [None] + (lk.traj_plans(L) if sweep else [])
    plans3 = [None] + (lk.traj_plans(L, lk.K3_TILES) if sweep else [])
    before = dict(_build.LAUNCHES)
    ref2 = lk.leapfrog_plain(x, v, beta, dt, nstep)
    ref5 = lk.hmc_traj_hostrng_plain(x, v, u, beta, dt, nstep)
    ref4 = lk.hmc_traj_plain(x, seed, beta, dt, nstep)
    v4, u4 = rng.momenta(seed, B, L), rng.accept_uniforms(seed, B)
    runs = [lk.leapfrog(x, v, beta, dt, nstep, plan=p) for p in plans]
    for got in runs:
        torch.cuda.synchronize()
        assert _wrapped(got[0], ref2[0]) < 1e-4
        assert float((got[1] - ref2[1]).abs().max()) < \
            1e-4 * float(ref2[1].abs().max())
    ref3 = lk.leapfrog_cl_plain(x, v, beta, dt, nstep)
    for p in plans3:
        got = lk.leapfrog_cl(x, v, beta, dt, nstep, plan=p)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref3)), p
    for p in plans:
        _close_traj(lk.hmc_traj_hostrng(x, v, u, beta, dt, nstep, plan=p),
                    ref5, x, v, u, beta, dt, nstep)
        _close_traj(lk.hmc_traj(x, seed, beta, dt, nstep, plan=p), ref4, x,
                    v4, u4, beta, dt, nstep)
    # K2-K5 are deterministic: two launches bit-equal
    k4 = lk.hmc_traj(x, seed, beta, dt, nstep)
    assert all(torch.equal(a, b) for a, b in
               zip(k4, lk.hmc_traj(x, seed, beta, dt, nstep)))
    k5 = lk.hmc_traj_hostrng(x, v, u, beta, dt, nstep)
    assert all(torch.equal(a, b) for a, b in
               zip(k5, lk.hmc_traj_hostrng(x, v, u, beta, dt, nstep)))
    k2 = lk.leapfrog(x, v, beta, dt, nstep)
    assert all(torch.equal(a, b) for a, b in
               zip(k2, lk.leapfrog(x, v, beta, dt, nstep)))
    k3 = lk.leapfrog_cl(x, v, beta, dt, nstep)
    assert all(torch.equal(a, b) for a, b in
               zip(k3, lk.leapfrog_cl(x, v, beta, dt, nstep)))
    n = len(plans)
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert launched == {"K1": 0, "K2": n + 2, "K3": len(plans3) + 2,
                        "K4": n + 2, "K5": n + 2, "K6": 0, "K7": 0, "K8": 0,
                        "K9": 0, "K10": 0, "K11": 0, "K11_bf16": 0,
                        "K12": 0}


# K3 at ragged chain counts (a tile's last chains past B); then at the
# headline's beta, dt and steps from near-equilibrium links: 32^2, 8^2 and
# 48^2 at 1024 chains, a chain count no tile divides, 64^2 x 16, and 16^2
# and 64^2 at 1024 chains, each under every plan of chain tiles
@pytest.mark.parametrize("B,L,physics", [
    (1, 8, "hot"), (3, 16, "hot"), (13, 32, "hot"), (130, 8, "hot"),
    (16, 64, "hot"), (5, 48, "hot"), (1024, 32, "headline"),
    (1024, 8, "headline"), (1024, 48, "headline"), (1000, 16, "headline"),
    (16, 64, "headline"), (1024, 16, "headline"), (1024, 64, "headline")])
def test_k3_takes_any_chain_count(card, B, L, physics):
    """K3 bit-equal to its twin (at the headline's physics under every plan
    of chain tiles too), two launches bit-equal."""
    if physics == "hot":
        g = torch.Generator(device=card).manual_seed(B + L)
        x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1) \
            * math.pi
        v = torch.randn((B, 2, L, L), generator=g, device=card)
        args, plans = (2.0, 0.1, 5), [None]
    else:
        x, v, _, _, _, _ = _traj_inputs(card, B, L, physics, B + L)
        args, plans = HEADLINE, [None] + lk.traj_plans(L, lk.K3_TILES)
    ref = lk.leapfrog_cl_plain(x, v, *args)
    for p in plans:
        got = lk.leapfrog_cl(x, v, *args, plan=p)
        again = lk.leapfrog_cl(x, v, *args, plan=p)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), p
        assert all(torch.equal(a, b) for a, b in zip(got, again)), p


# K1 at the shapes the paths give it (FT 16^2 x 64, path A 64^2 x 64, path
# B 16^2 x 128, the headline's 'xla' step 64^2 x 1024, an odd 20^2 x 3 with
# a ragged band) and 2^2
@pytest.mark.parametrize("B,L", [(64, 16), (64, 64), (128, 16), (1024, 64),
                                 (3, 20), (5, 2)])
def test_k1_matches_its_twin_under_every_plan(card, B, L):
    """K1 under its default plan and every plan of force_plans(L) against
    its twin, within 1e-4 x max(1, max|F|) (PERF.md's tolerance; the kernel
    repeats the twin op for op); two launches bit-equal; one launch a
    call."""
    g = torch.Generator(device=card).manual_seed(L)
    x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1) * math.pi
    ref = lk.force_plain(x, 6.0)
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    plans = [None] + lk.force_plans(L)
    before = _build.LAUNCHES["K1"]
    for p in plans:
        got = lk.force(x, 6.0, plan=p)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= tol, p
    assert torch.equal(lk.force(x, 6.0), lk.force(x, 6.0))
    assert _build.LAUNCHES["K1"] - before == len(plans) + 2


@pytest.mark.parametrize("L", [2, 3, 8, 16, 20, 64, 256, 1024])
def test_force_smem_count_is_the_librarys(card, L):
    """The Python count of a K1 CTA's shared memory (which the CPU tests
    hold against the H100's limit) is the library's own, for every plan."""
    for plan in lk.force_plans(L):
        assert lk._force_bytes(L, plan) == lk.force_smem_bytes_of(L, plan)


@pytest.mark.parametrize("L", [2, 3, 8, 20, 64, 128, 256])
def test_traj_smem_count_is_the_libraries(card, L):
    """The Python count of a band CTA's shared memory (which the CPU tests
    hold against the H100's limit) is the libraries' own, for every plan."""
    for plan in lk.traj_plans(L):
        for kernel, name in (("K2", "leapfrog"), ("K4", "hmc_traj"),
                             ("K5", "hmc_traj"), ("K12", "hmc_traj")):
            assert lk._band_bytes(name, kernel, L, plan) == \
                lk.traj_smem_bytes_of(L, plan, kernel)
    for plan in lk.traj_plans(L, lk.K3_TILES):
        assert lk._band_bytes("leapfrog", "K3", L, plan) == \
            lk.traj_smem_bytes_of(L, plan, "K3")


def test_trajectory_kernels_refuse_what_they_do_not_take(card):
    x = torch.zeros((4, 2, 8, 8), device=card)
    seed = torch.zeros(1, dtype=torch.int32, device=card)
    big = torch.zeros((1, 2, 257, 257), device=card)  # over the plans' reach
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="L <= 256"):
        lk.leapfrog(big, big, 1.0, 0.1, 1)
    with pytest.raises(ValueError, match="L <= 256"):
        lk.hmc_traj(big, seed, 1.0, 0.1, 1)
    with pytest.raises(ValueError, match="L <= 256"):
        lk.hmc_traj_hostrng(big, big, torch.zeros(1, device=card), 1.0, 0.1,
                            1)
    bad = lk.TrajPlan(1, (0, 8), 8, 4)   # runs of 4 rows: half of 8 rows
    with pytest.raises(ValueError, match="plan"):
        lk.leapfrog(x, x, 1.0, 0.1, 1, plan=bad)
    with pytest.raises(ValueError, match="L <= 256"):   # K3's reach
        lk.leapfrog_cl(big, big, 1.0, 0.1, 1)
    one = torch.zeros(1, device=card)
    huge = torch.zeros((1, 2, 1025, 1025), device=card)
    with pytest.raises(ValueError, match="L <= 1024"):   # K12's reach
        lk.hmc_epilogue(huge, huge, huge, huge, one, one, 1.0)
    with pytest.raises(ValueError, match="band plans"):   # none above 256
        lk.hmc_epilogue(big, big, big, big, one, one, 1.0,
                        plan=lk.TrajPlan(1, (0, 257), 257, 1))
    with pytest.raises(TypeError):
        lk.hmc_epilogue(*(x.double(),) * 4, *(x[:, 0, 0, 0].double(),) * 2,
                        1.0)
    # a tile of 8 chains needs threads in multiples of 64 at 8^2
    with pytest.raises(ValueError, match="plan"):
        lk.leapfrog_cl(x, x, 1.0, 0.1, 1,
                       plan=lk.TrajPlan(1, (0, 8), 32, 8, 8))
    with pytest.raises(TypeError):
        lk.leapfrog_cl(x.double(), x.double(), 1.0, 0.1, 1)
    with pytest.raises(ValueError, match="L <= 1024"):   # K1's envelope
        lk.force(torch.zeros((1, 2, 1025, 1025), device=card), 1.0)
    with pytest.raises(ValueError, match="plan"):
        lk.force(x, 1.0, plan=lk.ForcePlan(8, 8, 4))   # 2 runs a column
    with pytest.raises(TypeError):
        lk.leapfrog(x.double(), x.double(), 1.0, 0.1, 1)
    with pytest.raises(ValueError):
        lk.hmc_traj(x, seed.cpu(), 1.0, 0.1, 1)
    q = torch.zeros(4, device=card)
    gen = torch.Generator(device=card).manual_seed(0)
    with pytest.raises(ValueError):   # fp64 on the card: no kernel
        th.hmc_step(gen, x.double(), q.double(), 1.0, 0.1, 1)
    for backend in ("pallas", "pallas_cl", "fused", "fused_hostrng"):
        with pytest.raises(ValueError):
            th.hmc_step(gen, x, q, 1.0, 0.1, 1, backend=backend,
                        integrator="omelyan")
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("backend,kernel", [
    ("auto", "K2"), ("auto", "K3"), ("pallas", "K2"), ("pallas_cl", "K3"),
    ("fused", "K4"), ("fused_hostrng", "K5"), ("xla", "K1")])
def test_run_hmc_launches_only_its_kernel(card, backend, kernel):
    """Each backend's trajectory kernel, and after K2, K3 or the K1 loop one
    K12 a trajectory (the fused kernels end the step themselves)."""
    # 'auto' is K3 up to 16^2 and K2 above (hmc.AUTO_K3_MAX_L)
    L = 32 if (backend, kernel) == ("auto", "K2") else 8
    cfg = HMCConfig(beta=2.0, L=L, tau=1.0, nstep=5, ntraj=6, n_chains=8,
                    randinit=True)
    _build.reset_counts()
    x, hist = th.run_hmc(cfg, backend=backend)
    torch.cuda.synchronize()
    per_traj = cfg.nstep if kernel == "K1" else 1
    epilogues = 0 if kernel in ("K4", "K5") else cfg.ntraj
    assert _build.LAUNCHES[kernel] == cfg.ntraj * per_traj
    assert _build.LAUNCHES["K12"] == epilogues
    assert sum(_build.LAUNCHES.values()) == cfg.ntraj * per_traj + epilogues
    assert not any(_build.PLAIN_CALLS.values())
    assert x.is_cuda and bool(torch.isfinite(hist.dh).all())


# ---------------------------------------------------------------------------
# K12, the plain step's epilogue (csrc/hmc_traj.cu), against its twin in
# float64. Its dH is held within lk.epilogue_dh_tolerance (2^-19 of dH's
# magnitudes: the plaquettes' fp32 roundings and the sums' order), and
# that bound catches a kernel that is not fp32 throughout: the twin with
# its cos P rounded to bfloat16 breaks it on most chains at 64^2. The
# plaquette's bound is 2^-19 of sum(|sin P0| + |sin P1|) + V, over V. The
# charge is an integer for any field (the plaquettes of a periodic lattice
# sum to 0 before the wrap), and K12's is held to the twin's within the
# benchmark's obs_gap limit, 0.01, where no plaquette lies within 1e-4 of
# the wrap's edge at +-pi.
# ---------------------------------------------------------------------------

def _epilogue_bounds(x, x1, v1, v0, beta):
    """Per chain in float64: (dH bound, plaquette bound, and the charge's
    margin, the least distance of either field's plaquettes from the wrap's
    edge at +-pi)."""
    x, x1, v1, v0 = (t.double().cpu() for t in (x, x1, v1, v0))
    p0, p1 = lk._plaq_of(x), lk._plaq_of(torch.remainder(x1 + math.pi,
                                                         2 * math.pi)
                                         - math.pi)
    V = x.shape[-1] ** 2
    sin_abs = (p0.sin().abs() + p1.sin().abs()).sum((1, 2))
    plaq = 2.0 ** -19 * (sin_abs + V) / V
    edge = torch.minimum(*(
        (math.pi - (torch.remainder(p + math.pi, 2 * math.pi)
                    - math.pi).abs()).amin((1, 2)) for p in (p0, p1)))
    return lk.epilogue_dh_tolerance(x, x1, v1, v0, beta), plaq, edge


def _bf16_cos_dh(x, x1, v1, v0, beta):
    """The control: the twin's dH in float64 with each cos P rounded to
    bfloat16, the nearest precision below fp32 of a card's fast paths."""
    x, x1, v1, v0 = (t.double().cpu() for t in (x, x1, v1, v0))
    c0, c1 = (lk._plaq_of(f).cos().bfloat16().double()
              for f in (x, torch.remainder(x1 + math.pi, 2 * math.pi)
                        - math.pi))
    return (-beta * (c1 - c0).sum((1, 2))
            + 0.5 * ((v1 - v0) * (v1 + v0)).sum((1, 2, 3)))


def _decided(u, dh_ref, dh_gap):
    """Chains whose decision no dH within ``dh_gap`` of the twin's can
    change: log u further than that (and 1e-6 for expf's rounding) from
    -dH; u = 0 always accepts."""
    return (u == 0) | ((torch.log(u) + dh_ref).abs() > dh_gap + 1e-6)


def _check_epilogue(got, ref, u, bounds):
    """K12's (x_new, rows) against the fp64 twin's: dH within its bound,
    exp(-dH) within what that bound allows; the accept equal wherever the
    dH gap cannot flip it (``_decided``); where the accept is equal,
    x_new equal (wrapped) to 1e-5, and exactly the start where both
    reject, the plaquette within its bound and the charge and dq within
    0.01 away from the wrap's edge. Returns the count of decided chains and
    of accepts."""
    dh_b, plaq_b, edge = bounds
    (xk, rk), (xp, rp) = (got[0].double().cpu(), got[1].double().cpu()), ref
    u = u.double().cpu()
    assert bool(((rk[0] - rp[0]).abs() <= dh_b).all()), \
        float(((rk[0] - rp[0]).abs() / dh_b).max())
    assert bool(((rk[1] - rp[1]).abs()
                 <= rp[1] * (torch.expm1(dh_b) + 1e-6)).all())
    decided = _decided(u, rp[0], (rk[0] - rp[0]).abs())
    assert torch.equal(rk[2][decided], rp[2][decided])
    same = rk[2] == rp[2]
    if bool(same.any()):
        assert _wrapped(xk[same], xp[same]) < 1e-5
    assert bool(((rk[3] - rp[3]).abs()[same] <= plaq_b[same]).all())
    far = same & (edge > 1e-4)
    for row in (4, 5):
        assert bool(((rk[row] - rp[row]).abs()[far] <= 0.01).all())
    return int(decided.sum()), int(rk[2].sum())


def _epilogue_inputs(card, B, L, inputs):
    """(x, x1, v1, v0, q_old, beta, generator) of a K12 case. 'synthetic': a
    hot start and a trajectory's end of small moves and whole turns of 2
    pi; 'k2' and 'k1': near-equilibrium links and the end of a headline
    trajectory from them through K2 or the K1 loop ('xla'), q_old 0."""
    g = torch.Generator(device=card).manual_seed(B * 1000 + L)
    if inputs == "synthetic":
        x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1) * 3.0
        step = 1.0 / L   # dH of order 1 at every L
        x1 = (x + step * torch.randn(x.shape, generator=g, device=card)
              + 2 * math.pi * torch.randint(-1, 2, x.shape, generator=g,
                                            device=card))
        v0 = torch.randn(x.shape, generator=g, device=card)
        v1 = v0 + step * torch.randn(x.shape, generator=g, device=card)
        q_old = torch.randint(-3, 4, (B,), generator=g, device=card).float()
        return x, x1, v1, v0, q_old, 2.0, g
    beta, dt, nstep = HEADLINE
    x = near_equilibrium(g, B, L, beta, card)
    v0 = torch.randn(x.shape, generator=g, device=card)
    if inputs == "k2":
        x1, v1 = lk.leapfrog(x, v0, beta, dt, nstep)
    else:
        x1, v1 = th.run_leapfrog(x, v0, beta, dt, nstep, backend="xla",
                                 device=card)
    return x, x1, v1, v0, torch.zeros(B, device=card), beta, g


# the synthetic cases; then after a headline trajectory: K2's at the
# headline and at a launch of its sites (128^2 x 256, 256^2 x 64), the K1
# loop's above the band plans' reach (K12's wide kernel)
@pytest.mark.parametrize("B,L,inputs", [
    *((B, L, "synthetic") for B, L in (
        (1, 8), (3, 16), (13, 32), (5, 48), (1024, 64), (4, 128), (2, 256),
        (3, 300), (2, 512), (1, 1024))),
    (1024, 64, "k2"), (256, 128, "k2"), (64, 256, "k2"), (4, 512, "k1"),
    (64, 512, "k1"), (16, 1024, "k1")])
def test_k12_matches_its_twin_in_fp64(card, B, L, inputs):
    """K12 under its default plan (and, up to 64^2 and after K2's
    trajectories, every plan of traj_plans(L); above 256 its wide kernel)
    against its twin run in float64 on the same fp32 inputs, with u = 0
    (every chain accepts), u = 1 - 2^-24 (every chain of dH > 0 rejects)
    and random u; one launch a call, two launches bit-equal. At 64^2 the
    bfloat16-cos control breaks the dH bound on most synthetic chains.
    After a trajectory no plaquette lies near the wrap's edge, so the
    charge is held on every chain whose accept agrees."""
    x, x1, v1, v0, q_old, beta, g = _epilogue_inputs(card, B, L, inputs)
    bounds = _epilogue_bounds(x, x1, v1, v0, beta)
    if inputs != "synthetic":
        assert bool((bounds[2] > 1e-4).all())
    sweep = L <= 64 or inputs == "k2"
    plans = [None] + (lk.traj_plans(L) if sweep else [])
    before = _build.LAUNCHES["K12"]
    accepts = {}
    for mode in ("zero", "one", "random"):
        u = {"zero": torch.zeros(B, device=card),
             "one": torch.full((B,), 1 - 2.0 ** -24, device=card),
             "random": torch.rand((B,), generator=g, device=card)}[mode]
        ref = lk.hmc_epilogue_plain(
            *(t.double().cpu() for t in (x, x1, v1, v0, u, q_old)), beta)
        for p in plans:
            got = lk.hmc_epilogue(x, x1, v1, v0, u, q_old, beta, plan=p)
            torch.cuda.synchronize()
            rejected = got[1][2] == 0
            assert torch.equal(got[0][rejected], x[rejected])
            decided, accepts[mode] = _check_epilogue(got, ref, u, bounds)
        if mode == "zero":
            assert decided == B and accepts[mode] == B
    if B >= 13 and inputs == "synthetic":   # both outcomes of the decision
        assert 0 < accepts["one"] < B and 0 < accepts["random"] < B
    if L == 64 and inputs == "synthetic":
        miss = (_bf16_cos_dh(x, x1, v1, v0, beta) - ref[1][0]).abs() \
            > bounds[0]
        assert float(miss.double().mean()) > 0.5
    a = lk.hmc_epilogue(x, x1, v1, v0, u, q_old, beta)
    b = lk.hmc_epilogue(x, x1, v1, v0, u, q_old, beta)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert _build.LAUNCHES["K12"] - before == 3 * len(plans) + 2


def _hold_k12_to_its_twin(monkeypatch) -> list:
    """Replaces lk.hmc_epilogue by K12 followed by its fp64 twin on the same
    inputs; each call appends (decided chains, dH within its bound and the
    decided accepts equal, the largest plaquette or charge gap where the
    accepts agree) to the list returned."""
    real = lk.hmc_epilogue
    seen = []

    def both(x, x1, v1, v0, u, q_old, beta):
        got = real(x, x1, v1, v0, u, q_old, beta)
        ref = lk.hmc_epilogue_plain(
            *(t.double().cpu() for t in (x, x1, v1, v0, u, q_old)), beta)
        dh_b = _epilogue_bounds(x, x1, v1, v0, beta)[0]
        rk, rp = got[1].double().cpu(), ref[1]
        gap = (rk[0] - rp[0]).abs()
        decided = _decided(u.double().cpu(), rp[0], gap)
        same = rk[2] == rp[2]
        seen.append((int(decided.sum()), bool((gap <= dh_b).all())
                     and bool(torch.equal(rk[2][decided], rp[2][decided])),
                     float((rk[3:5] - rp[3:5]).abs()[:, same].max())))
        return got

    monkeypatch.setattr(lk, "hmc_epilogue", both)
    return seen


def _check_followed(seen, cfg):
    """Every trajectory's K12 held: dH within its bound, decisions equal
    away from the threshold (95% of them decided), plaquette and charge
    within 1e-3 (a tenth of the benchmark's obs_gap limit)."""
    assert len(seen) == cfg.ntraj
    assert sum(n for n, _, _ in seen) >= 0.95 * cfg.ntraj * cfg.n_chains
    assert all(equal for _, equal, _ in seen)
    assert max(gap for _, _, gap in seen) < 1e-3


def test_run_hmc_k12_follows_its_twin(card, monkeypatch):
    """40 trajectories of run_hmc ('auto': K2 and K12) at 64^2 x 64 chains,
    beta = 6, from the cold start: every K12 launch held against its fp64
    twin on the same inputs, so both see one generator state
    (_check_followed)."""
    seen = _hold_k12_to_its_twin(monkeypatch)
    cfg = HMCConfig(beta=6.0, L=64, tau=1.0, nstep=25, ntraj=40,
                    n_chains=64)
    _build.reset_counts()
    x, hist = th.run_hmc(cfg, backend="auto")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K2"] == _build.LAUNCHES["K12"] == cfg.ntraj
    _check_followed(seen, cfg)
    assert 0.5 < float(hist.acc.mean()) < 1.0


@pytest.mark.parametrize("integrator", ["leapfrog", "omelyan"])
def test_run_hmc_k12_follows_its_twin_above_the_band_reach(card, monkeypatch,
                                                           integrator):
    """run_hmc on 'xla' (the K1 loop) at 512^2, above the band plans' reach
    of 256, where K12 runs its wide kernel: 6 trajectories of 40 steps and
    4 chains, beta = 6, from the cold start, each K12 launch held against
    its fp64 twin (_check_followed); only K1 and K12 launch, K12 once a
    trajectory. (At 10 steps every omelyan trajectory from the cold start
    reads dH ~ +12 and is rejected, in fp64 on the CPU too.)"""
    seen = _hold_k12_to_its_twin(monkeypatch)
    cfg = HMCConfig(beta=6.0, L=512, tau=0.5, nstep=40, ntraj=6,
                    n_chains=4)
    _build.reset_counts()
    x, hist = th.run_hmc(cfg, backend="xla", integrator=integrator)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K12"] == cfg.ntraj
    assert _build.LAUNCHES["K1"] > 0
    assert sum(_build.LAUNCHES.values()) == \
        _build.LAUNCHES["K1"] + _build.LAUNCHES["K12"]
    plain = dict(_build.PLAIN_CALLS)
    assert plain.pop("K12") == cfg.ntraj   # the check's own twin
    assert not any(plain.values())
    _check_followed(seen, cfg)
    assert float(hist.acc.mean()) > 0


@pytest.mark.parametrize("B,L,physics", [(16, 16, "small"),
                                         (1024, 64, "headline")])
def test_fused_hostrng_follows_xla(card, B, L, physics):
    """'fused_hostrng' (K5) takes the draws 'xla' takes: one step from the
    same generator state gives the same dH within dh_tolerance and the same
    x' where the accept agrees; at 16^2 from links in [-1, 1], and at the
    headline from near-equilibrium links."""
    g = torch.Generator(device=card).manual_seed(3)
    if physics == "small":
        x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1)
        beta, dt, nstep = 2.0, 0.1, 8
    else:
        beta, dt, nstep = HEADLINE
        x = near_equilibrium(g, B, L, beta, card)
    q = torch.zeros(B, device=card)
    out = {b: th.hmc_step(torch.Generator(device=card).manual_seed(9), x, q,
                          beta, dt, nstep, backend=b)
           for b in ("xla", "fused_hostrng")}
    gen = torch.Generator(device=card).manual_seed(9)
    v0 = torch.randn(x.shape, generator=gen, device=card)
    u = torch.rand((B,), generator=gen, device=card)
    (xa, _, ma), (xb, _, mb) = out["xla"], out["fused_hostrng"]
    _close_traj((xb, mb.dh, mb.acc), (xa, ma.dh, ma.acc), x, v0, u, beta,
                dt, nstep)


# ---------------------------------------------------------------------------
# K9, K10, K11 (csrc/fermion.cu). K9 and K10 repeat their twins' arithmetic
# op for op (explicit _rn intrinsics), so they are held to 1e-6 x max|ref|;
# K11, the whole CG solve, sums in another order than torch's, so its
# solutions are held to its twin's and the torch CG's within 1e-3
# relative in norm (two fp32 CGs stopped at a relative residual of 3e-5 on
# operators of condition up to ~30; 1e-4 where the twin runs the same
# iterations at 16^2), iters within 1.
# ---------------------------------------------------------------------------


def _fermion_fields(card, B, L0, L1, eo, seed=0):
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    g = torch.Generator(device=card).manual_seed(seed)
    theta = (torch.rand((B, 2, L0, L1), generator=g, device=card) * 2 - 1) \
        * math.pi
    psi = torch.complex(torch.randn((B, L0, L1, 2), generator=g, device=card),
                        torch.randn((B, L0, L1, 2), generator=g, device=card))
    if eo:
        even, _ = fk.parity_masks(L0, L1, 1, card)
        psi = psi * even
    return theta, psi


def _band_plans(L):
    """None (the wrappers' own plan) and every plan of C = 1, 2, 4, 8 even
    bands of at least 2 rows."""
    return [None] + [(C, tuple(r * L // C for r in range(C + 1)))
                     for C in (1, 2, 4, 8) if L // C >= 2]


# small and odd shapes, then the paths': 64^2 x 64 (A), 16^2 x 128 (B, C)
@pytest.mark.parametrize("B,L0,L1", [(4, 8, 8), (3, 8, 12), (2, 64, 64),
                                     (2, 96, 96), (128, 16, 16),
                                     (64, 64, 64)])
@pytest.mark.parametrize("eo", [False, True])
def test_fermion_operators_match_plain_twins(card, B, L0, L1, eo):
    """K9 and K10 against their twins on the same planes under every band
    plan, K10 also under every chain tile (4 to 32 chains; B = 3 leaves a
    ragged tile): bands in shared memory, and in device scratch where one
    does not fit (K9's one band of 96 rows, K10's wide tiles at 96^2 and
    at 16^2 with one band). Two launches bit-equal; each operator one
    launch."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    theta, psi = _fermion_fields(card, B, L0, L1, eo)
    ur, ui = fk.link_planes(theta)
    p4 = fk.pack_spinor(psi).contiguous()
    ref = fk.mdagm_plain(ur, ui, p4, 0.1, eo)
    tol = 1e-6 * float(ref.abs().max())
    t = (lambda a: a.permute(1, 2, 3, 0).contiguous())  # noqa: E731
    urt, uit, p4t, ref_t = t(ur), t(ui), t(p4), t(ref)
    for plan in _band_plans(L0):
        before = dict(_build.LAUNCHES)
        runs = [fk.mdagm(ur, ui, p4, 0.1, eo, plan=plan) for _ in range(2)]
        torch.cuda.synchronize()
        assert float((runs[0] - ref).abs().max()) <= tol, plan
        assert torch.equal(runs[0], runs[1])
        assert _build.LAUNCHES["K9"] == before["K9"] + 2
        for tile in (None, 4, 8, 16, 32):
            before = _build.LAUNCHES["K10"]
            runs = [fk.mdagm_cl(urt, uit, p4t, 0.1, eo, plan=plan, tile=tile)
                    for _ in range(2)]
            torch.cuda.synchronize()
            assert float((runs[0] - ref_t).abs().max()) <= tol, (plan, tile)
            assert torch.equal(runs[0], runs[1])
            assert _build.LAUNCHES["K10"] == before + 2


def test_fermion_operators_are_one_kernel_launch(card):
    """One CUDA kernel an operator, K9 or K10, at the paths' shapes, eo and
    not: three calls are three launches by the wrapper's own counter, and
    the profiler's per-name totals (``key_averages``, not the raw event
    list, which drops a record now and then) name no kernel but
    ``op_kernel`` (no intermediate passes, no copies)."""
    from torch.profiler import ProfilerActivity, profile
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    t = (lambda a: a.permute(1, 2, 3, 0).contiguous())  # noqa: E731
    for B, L, cl in ((64, 64, False), (128, 16, True), (128, 16, False)):
        theta, psi = _fermion_fields(card, B, L, L, True)
        ur, ui = fk.link_planes(theta)
        p4 = fk.pack_spinor(psi).contiguous()
        if cl:
            ur, ui, p4 = t(ur), t(ui), t(p4)
        name = "K10" if cl else "K9"
        for eo in (False, True):
            launch, _ = fk.operator_launch(cl, ur, ui, p4, 0.1, eo, None,
                                           None)
            # a first session warms the profiler up, and is not read
            with profile(activities=[ProfilerActivity.CUDA]):
                launch()
                torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    launch()
                torch.cuda.synchronize()
            counted = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
            assert counted == {**dict.fromkeys(_build.KERNELS, 0), name: 3}
            kernels = {e.key for e in prof.key_averages()
                       if e.device_type.name == "CUDA"}
            assert kernels and all("op_kernel" in k for k in kernels), \
                kernels


def test_fermion_band_bytes_are_the_layout(card):
    """fermion_smem_bytes, the one count of a K9 / K10 CTA's band: S and T
    (4 planes of rows + 8 rows), the links (4 planes of rows + 7), of L1 x
    tile floats, and 4 floats for the load's mbarrier; -1 for what the
    kernels do not take."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    for L0, L1, C, rows, tile in ((64, 64, 2, 32, 1), (16, 16, 8, 2, 8),
                                  (96, 96, 1, 96, 1), (20, 12, 8, 3, 32)):
        assert fk._band_bytes(L0, L1, C, rows, tile) == \
            4 * ((8 * (rows + 8) + 4 * (rows + 7)) * L1 * tile + 4)
    for bad in ((7, 8, 1, 7, 1), (8, 8, 2, 3, 1), (8, 8, 16, 1, 1),
                (8, 8, 2, 4, 3), (8, 8, 1, 9, 1)):
        assert fk._band_bytes(*bad) == -1


@pytest.mark.parametrize("layout", ["cf", "cl"])
def test_fused_cg_kernels_match_twins(card, layout):
    """The fused CG on the card: one K11 launch a solve and no operator
    launch, no twin; the solution of the torch CG."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    from fthmc_tpu_torch import fermion as tf
    theta, _ = _fermion_fields(card, 8, 16, 16, True, seed=3)
    phi, _ = tf.pf_refresh(torch.Generator(device=card).manual_seed(4),
                           theta, 0.1, eo=True)
    _build.reset_counts()
    got = fk.cg_solve_fused(theta, phi, 0.1, tol=1e-9, maxiter=500, eo=True,
                            layout=layout)
    assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0) | {"K11": 1}
    assert not any(_build.PLAIN_CALLS.values())
    assert got.launched == got.iters
    ref = tf.cg_solve(theta, phi, 0.1, tol=1e-9, maxiter=500, eo=True,
                      backend="xla")
    rel = float((got.x - ref.x).abs().norm() / ref.x.abs().norm())
    assert rel < 1e-4 and abs(got.iters - ref.iters) <= 1
    assert float(got.rsq.max()) <= 1e-9


# K11's card tests: mass 0.3 on links of small angles (an ordered field,
# as at beta = 6), where fp32 CGs reach tol 1e-9 in some 100 iterations
# at every size; and the paths' own field, near-equilibrium links at
# beta = 6 and m = 0.1 (paths A-G's mass)
CG_MASS = 0.3
PATH_MASS = 0.1


def _solve_inputs(card, B, L, eo, seed, field="ordered"):
    """(links, a right-hand side phi = D^dag chi (eo: Dhat^dag of an even
    chi), the mass): 'ordered' links of N(0, 0.35^2) angles at CG_MASS,
    'paths' near-equilibrium links at beta = 6 and PATH_MASS, phi from
    the heatbath's generator seeded 3."""
    from fthmc_tpu_torch import fermion as tf
    g = torch.Generator(device=card).manual_seed(seed)
    if field == "ordered":
        theta = 0.35 * torch.randn((B, 2, L, L), generator=g, device=card)
        mass, pf_seed = CG_MASS, seed + 1
    else:
        theta = near_equilibrium(g, B, L, 6.0, card)
        mass, pf_seed = PATH_MASS, 3
    phi, _ = tf.pf_refresh(torch.Generator(device=card).manual_seed(pf_seed),
                           theta, mass, eo=eo)
    return theta, phi, mass


# the paths' shapes (A 64^2 x 64 chains-first; B 16^2 x 128 chains-last; C
# 16^2 x 128 chains-first) and the scratch plans (128^2, 256^2) on the
# ordered field; the paths' shapes, 128^2 and 256^2 (4 chains) in both
# layouts on the paths' field
CG_SHAPES = [*((B, L, layout, "ordered") for B, L, layout in (
    (64, 64, "cf"), (128, 16, "cl"), (128, 16, "cf"), (4, 128, "cf"),
    (4, 128, "cl"), (2, 256, "cf"), (3, 256, "cl"))),
    *((B, L, layout, "paths") for B, L in ((64, 64), (128, 16), (4, 128),
                                          (4, 256))
      for layout in ("cf", "cl"))]


@pytest.mark.parametrize("B,L,layout,field", CG_SHAPES)
@pytest.mark.parametrize("eo", [True, False])
def test_k11_matches_its_twin(card, B, L, layout, field, eo):
    """K11 against cg_solve_fused_plain and the torch CG, cold and warm
    (from a 15-iteration solve; 20 on the paths' field), and capped by
    maxiter: x within 1e-3 relative and max|x - x_twin| within 1e-3
    max|x_twin|, iters within 1 (equal under the cap), every rsq <= tol;
    two launches bit-equal; one K11 launch a solve, no operator launch."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    from fthmc_tpu_torch import fermion as tf
    theta, phi, mass = _solve_inputs(card, B, L, eo, 11, field)
    kw = dict(tol=1e-9, maxiter=2000, eo=eo, layout=layout)
    warm = fk.cg_solve_fused(theta, phi, mass, tol=1e-9,
                             maxiter=15 if field == "ordered" else 20, eo=eo,
                             layout=layout).x
    for x0 in (None, warm):
        _build.reset_counts()
        runs = [fk.cg_solve_fused(theta, phi, mass, x0, **kw)
                for _ in (0, 1)]
        assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0) | {
            "K11": 2}
        assert torch.equal(runs[0].x, runs[1].x)
        assert torch.equal(runs[0].rsq, runs[1].rsq)
        got = runs[0]
        twin = fk.cg_solve_fused_plain(theta, phi, mass, x0, **kw)
        xla = tf.cg_solve(theta, phi, mass, x0, tol=1e-9, maxiter=2000,
                          eo=eo, backend="xla")
        for ref in (twin, xla):
            rel = float((got.x - ref.x).abs().norm() / ref.x.abs().norm())
            assert rel < 1e-3 and abs(got.iters - ref.iters) <= 1, \
                (rel, got.iters, ref.iters)
            assert float(ref.rsq.max()) <= 1e-9
        assert float((got.x - twin.x).abs().max()) <= \
            1e-3 * float(twin.x.abs().max())
        assert float(got.rsq.max()) <= 1e-9 and got.launched == got.iters
    capped = fk.cg_solve_fused(theta, phi, mass, tol=1e-9, maxiter=7, eo=eo,
                               layout=layout)
    twin = fk.cg_solve_fused_plain(theta, phi, mass, tol=1e-9, maxiter=7,
                                   eo=eo, layout=layout)
    assert capped.iters == twin.iters == 7
    rel = float((capped.x - twin.x).abs().norm() / twin.x.abs().norm())
    assert rel < 1e-4


def _cg_plans(L):
    return [(C, tuple(r * L // C for r in range(C + 1)))
            for C in (1, 2, 4, 8) if L // C >= 2]


def _plan_solve(theta, phi, mass, eo, layout, plan, tol, maxiter):
    """K11's solve of phi under band plan ``plan`` through cg_launch:
    (x, iters)."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    op = fk._PackedOperator(theta, layout)
    b4 = op.pack(phi)
    B = b4.shape[-1] if op.chains_last else b4.shape[0]
    x = torch.empty_like(b4)
    rel = torch.empty(B, device=b4.device)
    counters = torch.zeros(3, dtype=torch.int32, device=b4.device)
    fk.cg_launch(op.chains_last, op.ur, op.ui, b4, None, mass, eo, tol,
                 maxiter, x, rel, counters, None, plan)()
    iters, _, odd = counters.tolist()
    assert not odd
    return op.unpack(x), iters


# 5 chains on the ordered field, eo and not; the paths' shapes (A, B and
# C) on the paths' field, eo, solves of 40 iterations (tol 0)
@pytest.mark.parametrize("B,L,layout,field,eo", [
    *((5, L, layout, "ordered", eo) for L, layout in (
        (16, "cf"), (16, "cl"), (8, "cl"), (12, "cf"), (4, "cl"))
      for eo in (True, False)),
    (64, 64, "cf", "paths", True), (128, 16, "cl", "paths", True),
    (128, 16, "cf", "paths", True)])
@pytest.mark.parametrize("where", ["smem", "scratch"])
def test_k11_every_plan_matches_its_twin(card, monkeypatch, B, L, layout,
                                         field, eo, where):
    """K11 under every plan of C = 1, 2, 4, 8 bands of >= 2 rows (the halo
    copied from up to three bands a side, wrapping), in shared memory and
    in device scratch (the limit stubbed to 0): the twin's solution within
    1e-4 and iters within 1 at tol 1e-10 (ordered), within 1e-3 after 40
    iterations (the paths' field)."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    theta, phi, mass = _solve_inputs(card, B, L, eo, 12, field)
    tol, maxiter, limit = ((1e-10, 500, 1e-4) if field == "ordered"
                           else (0.0, 40, 1e-3))
    twin = fk.cg_solve_fused_plain(theta, phi, mass, tol=tol,
                                   maxiter=maxiter, eo=eo, layout=layout)
    if where == "scratch":
        monkeypatch.setattr(fk._build, "smem_limit", lambda index: 0)
    for plan in [None] + _cg_plans(L):
        x, iters = _plan_solve(theta, phi, mass, eo, layout, plan, tol,
                               maxiter)
        rel = float((x - twin.x).abs().norm() / twin.x.abs().norm())
        assert rel < limit and abs(iters - twin.iters) <= 1, \
            (plan, rel, iters, twin.iters)


def test_k11_freezes_chains_and_refuses_odd_sites(card):
    """A chain whose b is zero never runs and one whose b holds a NaN stops
    at once (NaN > stop is false), the others' solves unchanged; an eo b
    not zero on an odd site is refused after the launch (the kernel's
    flag), with no second launch."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    theta, phi, _ = _solve_inputs(card, 4, 16, True, 13)
    ref = fk.cg_solve_fused(theta, phi, CG_MASS, tol=1e-9, maxiter=500)
    bad = phi.clone()
    bad[1] = 0
    bad[2, 0, 0, 0] = float("nan")
    got = fk.cg_solve_fused(theta, bad, CG_MASS, tol=1e-9, maxiter=500)
    twin = fk.cg_solve_fused_plain(theta, bad, CG_MASS, tol=1e-9, maxiter=500)
    assert got.iters == twin.iters <= ref.iters
    for c in (0, 3):
        assert torch.equal(got.x[c], ref.x[c])
        assert torch.equal(got.rsq[c], ref.rsq[c])
    assert bool((got.x[1] == 0).all())
    odd = phi.clone()
    odd[:, 0, 1, 0] = 1.0
    before = _build.LAUNCHES["K11"]
    with pytest.raises(ValueError, match="odd sites"):
        fk.cg_solve_fused(theta, odd, CG_MASS, tol=1e-9, maxiter=500)
    assert _build.LAUNCHES["K11"] == before + 1


def test_k11_smem_bytes_are_the_layout(card):
    """cg_smem_bytes, the one count of a K11 CTA: the band region (eo: links
    both parities, p and x, r even, the intermediates both: 20 half planes
    of the band's rows and 8 of the own rows; not eo 24 and 24) and the
    reduction area (two slots of 32 warp sums and of the CTA's sum, 16 ints
    of halo table); -1 for what the kernel does not take."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    for L0, L1, C, rows in ((64, 64, 1, 64), (16, 16, 4, 4),
                            (256, 256, 8, 32), (20, 12, 8, 3)):
        for eo in (True, False):
            H = 4 if C > 1 else 0
            rs = L1 // 2
            hs, os_ = (rows + 2 * H) * rs, rows * rs
            band = 20 * hs + 8 * os_ if eo else 24 * hs + 24 * os_
            red = 64 + 2 + 16
            assert fk._cg_bytes(L0, L1, C, rows, eo, True) == 4 * (band + red)
            assert fk._cg_bytes(L0, L1, C, rows, eo, False) == 4 * red
    for bad in ((7, 8, 1, 7), (8, 8, 2, 3), (8, 8, 16, 1), (8, 8, 1, 9),
                (8, 8, 0, 8)):
        assert fk._cg_bytes(*bad, True, True) == -1
    # path A's chain in one CTA: 224 KB of the H100's 227
    assert fk._cg_bytes(64, 64, 1, 64, True, True) <= smem_limit(0)


def test_fermion_kernels_refuse_what_they_do_not_take(card):
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    from fthmc_tpu_torch import fermion as tf
    theta, psi = _fermion_fields(card, 2, 8, 8, False)
    ur, ui = fk.link_planes(theta)
    p4 = fk.pack_spinor(psi).contiguous()
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError):
        fk.mdagm(ur.double(), ui.double(), p4.double(), 0.1, True)
    with pytest.raises(ValueError, match="even sides"):
        th7, ps7 = _fermion_fields(card, 2, 8, 7, False)
        tf.cg_solve(th7, ps7, 0.1, tol=1e-8, maxiter=10)   # 'auto': fused
    assert dict(_build.LAUNCHES) == before


# ---------------------------------------------------------------------------
# flow training and flow sampling on the card
# ---------------------------------------------------------------------------

SAMPLE_SPEC = FlowSpec(n_layers=2, coupling="ncp", n_mixture=2,
                       hidden_sizes=(8, 8))


def test_flow_sampling_runs_k6_once_a_layer_a_block(card):
    """run_ensemble on the card, on latents and uniforms drawn on the CPU,
    launches K6 once a layer a block (no plain twin) and accepts what the
    CPU's plain twins accept (but where fp32 roundoff puts a uniform on the
    other side of the bound), the proposals' logq and logp within 1e-4."""
    from fthmc_tpu_torch import sampling as ts
    g = torch.Generator().manual_seed(3)
    params = init_flow_params(SAMPLE_SPEC, g, device="cpu")
    n, batch, nblocks = 16, 8, 3
    z0 = torch.rand((n, 2, 8, 8), generator=g) * 2 * math.pi - math.pi
    blocks = [(torch.rand((batch * n, 2, 8, 8), generator=g) * 2 * math.pi
               - math.pi, torch.rand((batch, n), generator=g))
              for _ in range(nblocks)]
    ref, _ = ts.run_ensemble(params, SAMPLE_SPEC, 2.0, z0, blocks)
    cparams = [[{k: v.to(card) for k, v in c.items()} for c in net]
               for net in params]
    _build.reset_counts()
    got, _ = ts.run_ensemble(cparams, SAMPLE_SPEC, 2.0, z0.to(card),
                             [(z.to(card), u.to(card)) for z, u in blocks])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K6"] == SAMPLE_SPEC.n_layers * (nblocks + 1)
    assert not any(_build.PLAIN_CALLS.values())
    same = (got["acc"].cpu() == ref["acc"]).float().mean()
    assert float(same) >= 0.98
    z = blocks[0][0]
    for a, b in zip(ts.propose(params, SAMPLE_SPEC, z, 2.0)[1:3],
                    ts.propose(cparams, SAMPLE_SPEC, z.to(card), 2.0)[1:3]):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * max(
            1.0, float(a.abs().max()))


def test_graphed_accept_pass_is_the_loop(card):
    """The sampler's accept pass replayed from its CUDA graph gives the
    loop's result on every block (the same kernels)."""
    from fthmc_tpu_torch import sampling as ts
    g = torch.Generator(card).manual_seed(4)
    held = ts._GraphedHeld()
    w0 = torch.randn(64, generator=g, device=card)
    for _ in range(3):
        w = torch.randn((64, 64), generator=g, device=card)
        u = torch.rand((64, 64), generator=g, device=card)
        src = held(w0, w, u)
        assert torch.equal(src, ts._held(w0, w, u))
        assert 0 < int((src >= 0).sum()) < src.numel()
        w0 = w[-1]


def test_flow_sampling_refuses_what_k6_does_not_take(card):
    """No fallback to the plain flow on the card: a shape K6 does not take
    (L not a multiple of 4) raises before any launch."""
    from fthmc_tpu_torch.sampling import make_mcmc_ensemble
    params = init_flow_params(SAMPLE_SPEC, torch.Generator(card), device=card)
    _build.reset_counts()
    with pytest.raises(ValueError, match="K6"):
        make_mcmc_ensemble(params, SAMPLE_SPEC, beta=2.0, L=6, batch_size=2,
                           num_samples=3, generator=torch.Generator(card),
                           device=card)
    assert not any(_build.LAUNCHES.values())


# (spec, batch, beta, force weights, ferm_mass): a small rncp; the
# flagship's width (24-layer rncp, batch 512); the reference training
# configuration's flow (16-layer ncp, hidden (8, 8)) with the spline
# coupling, and fermion-aware (ferm_mass 0.1, force_weight 0.5)
GRAD_CASES = {
    "small": (FlowSpec(n_layers=3, coupling="rncp", n_mixture=4,
                       hidden_sizes=(16, 16), s_clip=3.0), 64, 2.5,
              (0.0, 0.3), 0.0),
    "flagship": (FlowSpec(n_layers=24, coupling="rncp", n_mixture=8,
                          hidden_sizes=(32, 32), s_clip=3.0), 512, 2.0,
                 (0.0,), 0.0),
    "spline": (FlowSpec(n_layers=16, coupling="spline", n_knots=8,
                        hidden_sizes=(8, 8), s_clip=3.0), 64, 2.0, (0.0,),
               0.0),
    "ferm": (FlowSpec(n_layers=16, n_mixture=2, hidden_sizes=(8, 8)), 64,
             2.0, (0.5,), 0.1)}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_training_gradients_on_the_card_match_the_cpu(card, case):
    """loss_and_grads on the card against the CPU on the same z and
    parameters, with TF32 switched on around the call: the backward must
    run its convs in full fp32 (1e-4 relative in norm)."""
    from fthmc_tpu_torch import train as tt
    spec, batch, beta, weights, ferm_mass = GRAD_CASES[case]
    g = torch.Generator().manual_seed(5)
    params = init_flow_params(spec, g, device="cpu")
    z = torch.rand((batch, 2, 8, 8), generator=g) * 2 * math.pi - math.pi
    cparams = [[{k: v.to(card) for k, v in c.items()} for c in net]
               for net in params]
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for fw in weights:
            l0, _, g0 = tt.loss_and_grads(params, spec, z, beta,
                                          force_weight=fw,
                                          ferm_mass=ferm_mass)
            l1, _, g1 = tt.loss_and_grads(cparams, spec, z.to(card), beta,
                                          force_weight=fw,
                                          ferm_mass=ferm_mass)
            assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
            a, b = (torch.cat([t.flatten() for t in gg]) for gg in (g0, g1))
            assert float((b.cpu() - a).norm() / a.norm()) <= 1e-4
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@pytest.mark.parametrize("with_force,force_weight", [(False, 0.0),
                                                     (True, 0.2)])
def test_train_era_graph_replays_the_eager_steps(card, with_force,
                                                 force_weight):
    """On the card an era is one captured step replayed: from the same
    state and generator it gives the eager loop's parameters, moments,
    scheduler scalars and metrics (the same kernels; 1e-6 for fp32 reduction
    order in the capture), and leaves the caller's state untouched."""
    from fthmc_tpu_torch import train as tt
    from fthmc_tpu_torch.config import SchedulerConfig, TrainConfig
    cfg = TrainConfig(L=8, beta=3.0, beta_init=2.0, n_era=2, n_epoch=4,
                      batch_size=16, flow=SAMPLE_SPEC, grad_clip=0.5)
    sched = SchedulerConfig(patience=1)
    state = tt.init_train_state(None, cfg, device=card)
    before = [t.clone() for t in tt._state_tensors(state)]
    betas = tt.anneal_betas(cfg, 0, device=card)
    gen_state = state.generator.get_state()
    got, hg = tt.train_era(state, cfg.flow, 16, 8, cfg.beta, 1.0, 1e-3, 4,
                           sched=sched, with_force=with_force, betas=betas,
                           grad_clip=0.5, force_weight=force_weight)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tt._state_tensors(state)))
    state.generator.set_state(gen_state)

    def step(st, zs, beta_e):
        return tt._era_step(st, cfg.flow, zs, beta_e, 1.0, 1e-3, sched,
                            with_force, 0.01, 0.5, force_weight)

    ref, dtypes, he = tt._eager_era(
        step, state, tt._Draws(state, 8, 16, 2 if with_force else 1), betas)
    for a, b in zip(tt._state_tensors(got), tt._state_tensors(ref)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    he = he.cpu().numpy()
    assert list(hg) == list(dtypes)
    for i, k in enumerate(dtypes):
        np.testing.assert_allclose(hg[k], he[i], rtol=1e-5, atol=1e-5)
    assert int(got.step) == 4


def test_train_era_reads_the_host_once(card):
    """An era synchronises with the host once, at its end: CUDA's sync
    debug mode warns at every synchronising call."""
    import warnings
    from fthmc_tpu_torch import train as tt
    from fthmc_tpu_torch.config import SchedulerConfig, TrainConfig
    cfg = TrainConfig(L=8, beta=3.0, beta_init=2.0, n_era=2, n_epoch=5,
                      batch_size=16, flow=SAMPLE_SPEC, grad_clip=1.0)
    state = tt.init_train_state(None, cfg, device=card)
    state, _ = tt.train_era(state, cfg.flow, 16, 8, cfg.beta, 1.0, 1e-3, 5,
                            sched=SchedulerConfig(), grad_clip=1.0)
    betas = tt.anneal_betas(cfg, 1, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            state, host = tt.train_era(state, cfg.flow, 16, 8, cfg.beta, 1.0,
                                       1e-3, 5, sched=SchedulerConfig(),
                                       betas=betas, grad_clip=1.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert host["beta"].shape == (5,) and int(state.step) == 10


# ---------------------------------------------------------------------------
# the rest of the dynamical sector: K11 on bf16, the mixed CG, the nested
# and Hasenbusch samplers, fermion-aware training
# ---------------------------------------------------------------------------

def _bf16_inputs(card, B, L, eo, layout, seed, field):
    """(bf16 link planes, bf16 planes of a heatbath right-hand side) in
    ``layout``, and the mass."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    theta, phi, mass = _solve_inputs(card, B, L, eo, seed, field)
    op = fk._PackedOperator(theta, layout)
    return (op.ur.bfloat16(), op.ui.bfloat16(), op.pack(phi).bfloat16(),
            mass)


# the ordered field; then path G's shape (64^2, chains-first), path E's
# (32^2 x 64) and path B's (16^2 x 128, chains-last) on the paths' field
@pytest.mark.parametrize("B,L,layout,field", [
    *((B, L, layout, "ordered") for B, L, layout in (
        (64, 64, "cf"), (128, 16, "cl"), (5, 16, "cf"), (5, 8, "cl"),
        (3, 128, "cf"), (3, 128, "cl"))),
    (64, 64, "cf", "paths"), (64, 32, "cf", "paths"),
    (128, 16, "cl", "paths")])
@pytest.mark.parametrize("eo", [True, False])
def test_k11_bf16_matches_its_twin(card, B, L, layout, field, eo):
    """K11_bf16 (one launch, d = 0 start, the mixed CG's inner tol and
    sweep cap) against cg_planes_bf16_plain on the same bf16 r: the sweeps
    within 2, d within 5e-2 relative in norm (bf16 rounds in other places:
    the kernel keeps alpha, beta and the hops in fp32); one K11_bf16 launch
    and no other; two launches bit-equal."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    ur, ui, r16, mass = _bf16_inputs(card, B, L, eo, layout, 21, field)
    cl = layout == "cl"
    d_ref, k_ref = fk.cg_planes_bf16_plain(ur, ui, r16, mass,
                                           fk.MIXED_INNER_TOL,
                                           fk.MIXED_INNER_MAX, eo, cl)
    outs = []
    _build.reset_counts()
    for _ in range(2):
        d = torch.empty_like(r16)
        rel = torch.empty(B, device=card)
        counters = torch.zeros(3, dtype=torch.int32, device=card)
        fk.cg_launch(cl, ur, ui, r16, None, mass, eo, fk.MIXED_INNER_TOL,
                     fk.MIXED_INNER_MAX, d, rel, counters)()
        outs.append((d, counters.tolist()))
    assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0) | {
        "K11_bf16": 2}
    (d, (k, _, odd)), (d2, _) = outs
    assert not odd and torch.equal(d, d2)
    err = float((d.float() - d_ref.float()).norm() / d_ref.float().norm())
    assert abs(k - k_ref) <= 2 and err < 5e-2, (k, k_ref, err)


def test_k11_bf16_smem_bytes_are_half_the_region(card):
    """cg_smem_bytes of the bf16 instance: the region's elements at 2 bytes
    (rounded up to a float), the reduction area unchanged."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    for L0, L1, C, rows in ((64, 64, 1, 64), (16, 16, 4, 4), (20, 12, 8, 3),
                            (128, 128, 4, 32)):
        for eo in (True, False):
            red = fk._cg_bytes(L0, L1, C, rows, eo, False)
            f32 = fk._cg_bytes(L0, L1, C, rows, eo, True) - red
            b16 = fk._cg_bytes(L0, L1, C, rows, eo, True, True) - red
            assert fk._cg_bytes(L0, L1, C, rows, eo, False, True) == red
            assert b16 == 4 * (-(-(f32 // 2) // 4))


# the ordered field, eo and not, cold, at the force's tolerance; paths G's
# and B's shapes on the paths' field, eo, at the force's and the
# Metropolis' tolerance, cold and from a warm start (a solve to 1e-4)
@pytest.mark.parametrize("B,L,layout,field,tol,start,eo", [
    *((B, L, layout, "ordered", 1e-9, "cold", eo)
      for B, L, layout in ((64, 64, "cf"), (128, 16, "cl"), (4, 128, "cf"))
      for eo in (True, False)),
    *((B, L, layout, "paths", tol, start, True)
      for B, L, layout in ((64, 64, "cf"), (128, 16, "cl"))
      for tol in (1e-9, 1e-12) for start in ("cold", "warm"))])
def test_mixed_solve_reaches_tol_in_fp32(card, B, L, layout, field, tol,
                                         start, eo):
    """cg_solve_mixed on the card: each chain's fp32 true residual,
    recomputed by K9 / K10, within tol of |b|^2; the solution within
    10 sqrt(tol) (ordered) or 1e-3 (the paths' field, two fp32 CGs'
    rule) of the fused fp32 CG's from the same start; the launches K9 /
    K10 (the residuals) reads times and K11_bf16 (the inner solves) reads
    - 1 times, nothing else."""
    from fthmc_tpu_torch.ops import fermion_kernels as fk
    theta, phi, mass = _solve_inputs(card, B, L, eo, 22, field)
    x0 = None if start == "cold" else fk.cg_solve_fused(
        theta, phi, mass, tol=1e-4, maxiter=2000, eo=eo, layout=layout).x
    _build.reset_counts()
    res = fk.cg_solve_mixed(theta, phi, mass, x0, tol=tol, maxiter=2000,
                            eo=eo, layout=layout)
    torch.cuda.synchronize()
    op_name = "K10" if layout == "cl" else "K9"
    assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0) | {
        op_name: res.reads, "K11_bf16": res.reads - 1}
    assert not any(_build.PLAIN_CALLS.values())
    op = fk._PackedOperator(theta, layout)
    b4, x4 = op.pack(phi), op.pack(res.x)
    apply = fk.mdagm_cl if layout == "cl" else fk.mdagm
    r = b4 - apply(op.ur, op.ui, x4, mass, eo)
    dims = (0, 1, 2) if layout == "cl" else (1, 2, 3)
    rel = (r * r).sum(dim=dims) / (b4 * b4).sum(dim=dims)
    assert float(rel.max()) <= tol, float(rel.max())
    ref = fk.cg_solve_fused(theta, phi, mass, x0, tol=tol, maxiter=2000,
                            eo=eo, layout=layout)
    err = float((res.x - ref.x).abs().norm() / ref.x.abs().norm())
    assert err < (10 * math.sqrt(tol) if field == "ordered" else 1e-3)


@pytest.mark.parametrize("flow,B,beta", [("fresh", 16, 2.0),
                                          ("flow8x8_b3_rncp24_ftb6", 64, 6.0)])
def test_flow_vjp_kernel_logdet_cotangent_on_the_card(card, flow, B, beta):
    """flow_vjp_kernel with gl = 0 (the nested FT fermion force's) and -1
    against autograd through the flow: 2e-3 x max|ref|, the kernel force
    chain's tolerance; and the whole kernel force chain (K6-K8 and K1,
    ft_force_kernel) against the autograd force within 2e-3 x max(1,
    max|ref|), finite: a fresh flow at 16^2 x 16 and the exported flagship
    flow at the flagship's 16^2 x 64, beta = 6."""
    from fthmc_tpu_torch import lattice as tl
    from fthmc_tpu_torch.models.flow import flow_forward
    from fthmc_tpu_torch.ops.coupling_vjp_kernels import (flow_vjp_kernel,
                                                          ft_force_kernel)
    if flow == "fresh":
        spec = SPECS[1]
        params = init_flow_params(spec, torch.Generator().manual_seed(6),
                                  device=card)
    else:
        params, spec = load_flow_npz(device=card, name=flow)
    g = torch.Generator(device=card).manual_seed(7)
    z = (torch.rand((B, 2, 16, 16), generator=g, device=card) * 2 - 1) \
        * math.pi
    with full_fp32():
        for gl in (0.0, -1.0):
            got = flow_vjp_kernel(params, spec, z,
                                  lambda y: tl.batch_force(y, beta),
                                  logdet_cotangent=gl)
            zz = z.clone().requires_grad_(True)
            y, logj = flow_forward(params, zz, spec)
            (want,) = torch.autograd.grad(
                (tl.batch_action(y, beta) + gl * logj).sum(), zz)
            assert float((got - want).abs().max()) <= 2e-3 * float(
                want.abs().max())
        f_k = ft_force_kernel(params, spec, z, beta)
        f_a = th.ft_force(params, spec, z, beta, device=card)
    assert bool(torch.isfinite(f_k).all())
    assert float((f_k - f_a).abs().max()) <= 2e-3 * max(
        1.0, float(f_a.abs().max()))


def _trajectory_counts(cfg, log):
    """The launches one trajectory of cfg must make, from
    force_evaluations and the solves the CGLog saw."""
    from fthmc_tpu_torch import schwinger as ts
    n = ts.force_evaluations(cfg)
    want = dict.fromkeys(_build.KERNELS, 0)
    want["K1"] = n.get("gauge", 0) + n.get("dyn", 0)
    solves = [e for s in log.solves.values() for e in s]
    if ts.fermion._CG_BACKEND == "mixed":
        op = "K10" if cfg.cg_layout == "cl" else "K9"
        want[op] = sum(e[2] for e in solves)
        want["K11_bf16"] = sum(e[2] - 1 for e in solves)
    else:
        want["K11"] = len(solves)
    return want


@pytest.mark.parametrize("kind", ["nested", "hasenbusch", "mixed"])
def test_dynamical_trajectory_launch_counts(card, kind):
    """One nested, one Hasenbusch and one mixed-CG trajectory on the card:
    the launches are exactly the trajectory's own count (K1 a gauge force,
    K11 a solve; the mixed CG K9 a cycle and one, K11_bf16 a cycle), no
    plain twin, finite results."""
    from fthmc_tpu_torch import fermion as tf
    from fthmc_tpu_torch import schwinger as ts
    base = dict(L=16, beta=3.0, mass=0.2, tau=0.4, n_chains=4, ntraj=1,
                cg_tol_force=1e-9, cg_tol_mh=1e-12, cg_maxiter=1000)
    cfg = {"nested": ts.SchwingerConfig(nstep=3, n_inner=3, **base),
           "hasenbusch": ts.SchwingerConfig(nstep=2, n_mid=2, n_inner=2,
                                            hasenbusch_dm=0.3, **base),
           "mixed": ts.SchwingerConfig(nstep=4, **base)}[kind]
    if kind == "mixed":
        tf.set_cg_backend("mixed")
    try:
        x0 = 0.3 * torch.randn((4, 2, 16, 16),
                               generator=torch.Generator(card).manual_seed(8),
                               device=card)
        log = tf.CGLog()
        _build.reset_counts()
        x, hist = ts.run_hmc_dyn(cfg, x0=x0, generator=torch.Generator(
            card).manual_seed(9), device=card, cg_log=log)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == _trajectory_counts(cfg, log)
    finally:
        tf.set_cg_backend("auto")
    assert not any(_build.PLAIN_CALLS.values())
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(
        hist.dh).all())


_CAPTURE_PROBE = """
import torch
from fthmc_tpu_torch import train as tt
from fthmc_tpu_torch.config import FlowSpec
spec = FlowSpec(n_layers=2, coupling="ncp", n_mixture=2, hidden_sizes=(4,))
from fthmc_tpu_torch.config import TrainConfig
cfg = TrainConfig(L=8, beta=2.0, batch_size=4, flow=spec)
state = tt.init_train_state(None, cfg, device="cuda")

def step(st, zs, beta_e):
    return tt._era_step(st, spec, zs, beta_e, 1.0, 1e-3, None, False, 0.01,
                        None, 0.5, 0.1)

tt._graph_era(step, state, tt._Draws(state, 8, 4, 1),
              torch.full((2,), 2.0, device="cuda"))
torch.cuda.synchronize()
"""


def test_ferm_mass_era_capture_rule(card):
    """Whether a ferm_mass > 0 step (slogdet's LU and its double backward)
    can be captured in a CUDA graph, found in a process of its own (a
    failed capture can leave the context unusable; nothing is caught):
    train.FERM_ERA_GRAPHED must say what the card does."""
    import os
    import subprocess
    import sys
    from fthmc_tpu_torch import train as tt
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _CAPTURE_PROBE], cwd=root,
                         capture_output=True, text=True, timeout=600)
    captured = run.returncode == 0
    print("ferm_mass capture:", captured, run.stderr[-2000:])
    assert captured == tt.FERM_ERA_GRAPHED, run.stderr[-2000:]


def test_ferm_mass_era_on_the_card_is_the_cpus(card):
    """A ferm_mass = 0.1, force_weight = 0.5 era of 3 steps through
    train_era on the card (graphed or eager, as FERM_ERA_GRAPHED says)
    against the CPU's eager era on the same latents and parameters: every
    state tensor within 1e-4 relative in norm, the metrics within 1e-4."""
    from fthmc_tpu_torch import train as tt
    from fthmc_tpu_torch.config import TrainConfig
    spec = FlowSpec(n_layers=2, coupling="ncp", n_mixture=2,
                    hidden_sizes=(4,))
    cfg = TrainConfig(L=8, beta=2.0, batch_size=8, flow=spec)
    state = tt.init_train_state(None, cfg, device=card)
    gen_state = state.generator.get_state()
    got, hg = tt.train_era(state, spec, 8, 8, 2.0, 1.0, 1e-3, 3,
                           force_weight=0.5, ferm_mass=0.1)
    state.generator.set_state(gen_state)
    draw = tt._Draws(state, 8, 8, 1)
    zs = [[z.cpu() for z in draw()] for _ in range(3)]
    cpu = tt._with_tensors(state, [t.cpu() for t in tt._state_tensors(state)])
    cpu = cpu._replace(generator=torch.Generator())
    it = iter(zs)

    def step(st, z, beta_e):
        return tt._era_step(st, spec, z, beta_e, 1.0, 1e-3, None, False, 0.01,
                            None, 0.5, 0.1)

    ref, dtypes, he = tt._eager_era(step, cpu, lambda: next(it),
                                    torch.full((3,), 2.0))
    for a, b in zip(tt._state_tensors(got), tt._state_tensors(ref)):
        a, b = a.cpu().double(), b.double()
        if torch.equal(a, b):            # the step count; best_loss inf
            continue
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())
    he = he.numpy()
    for i, k in enumerate(dtypes):
        np.testing.assert_allclose(hg[k], he[i], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the bf16 and spline flows, the flow backends, the probe and the runner
# ---------------------------------------------------------------------------

def _card_cpu_flows(spec, card, seed=0):
    params = init_flow_params(spec, torch.Generator().manual_seed(seed),
                              device="cpu")
    return params, [[{k: v.to(card) for k, v in c.items()} for c in net]
                    for net in params]


def test_spline_and_bf16_flows_on_the_card_are_the_cpus(card):
    """The torch flow on the card against the CPU port: a spline flow in
    fp32 (cuDNN's fp32 convs under full_fp32) to the fp32 bounds above;
    a bf16-conv flow within one bf16 rounding of a conv output (0.01 on
    the fields, 0.1 * max(1, |logdet|)), cuDNN and oneDNN summing in
    other orders."""
    from fthmc_tpu_torch.models.flow import flow_forward, flow_reverse
    z = torch.rand((8, 2, 16, 16), generator=torch.Generator().manual_seed(1)
                   ) * 2 * math.pi - math.pi
    for spec, tol in ((FlowSpec(n_layers=4, coupling="spline", n_knots=8,
                                hidden_sizes=(8, 8), s_clip=3.0), 1e-4),
                      (FlowSpec(n_layers=4, coupling="rncp", n_mixture=4,
                                hidden_sizes=(16,), s_clip=3.0,
                                conv_dtype="bfloat16"), 1e-2)):
        pc, pg = _card_cpu_flows(spec, card)
        with torch.no_grad(), full_fp32():
            yc, lc = flow_forward(pc, z, spec)
            yg, lg = flow_forward(pg, z.to(card), spec)
        assert _wrapped(yg.cpu(), yc) < tol
        assert float((lg.cpu() - lc).abs().max()) <= \
            10 * tol * max(1.0, float(lc.abs().max()))
        xg, _ = flow_reverse(pg, yg, spec)
        assert _wrapped(xg.cpu(), z) < 5e-4


def test_flow_backends_on_the_card(card):
    """Flow sampling on the card: 'auto' (K6) refuses a spline flow,
    'torch' samples it; for an ncp flow the two backends' proposals agree
    to fp32 roundoff (fields 1e-4 wrapped, logq 1e-4 relative)."""
    from fthmc_tpu_torch.sampling import make_mcmc_ensemble
    spline = FlowSpec(n_layers=2, coupling="spline", n_knots=4,
                      hidden_sizes=(4,))
    _, pg = _card_cpu_flows(spline, card)
    kw = dict(beta=2.0, L=8, batch_size=8, num_samples=33, n_chains=4,
              device=card)
    with pytest.raises(ValueError, match="flow_backend='torch'"):
        make_mcmc_ensemble(pg, spline, generator=torch.Generator(
            card).manual_seed(0), **kw)
    out = make_mcmc_ensemble(pg, spline, flow_backend="torch",
                             generator=torch.Generator(card).manual_seed(0),
                             **kw)
    assert out["acc"].shape == (33, 4) and np.isfinite(out["logq"]).all()
    from fthmc_tpu_torch.sampling import propose
    _, pn = _card_cpu_flows(SPECS[0], card)
    z = torch.rand((64, 2, 8, 8), device=card) * 2 * math.pi - math.pi
    _build.reset_counts()
    with full_fp32():
        a = propose(pn, SPECS[0], z, 2.0, "auto")
    assert _build.LAUNCHES["K6"] == SPECS[0].n_layers
    b = propose(pn, SPECS[0], z, 2.0, "torch")
    assert _build.LAUNCHES["K6"] == SPECS[0].n_layers
    assert _wrapped(a[0], b[0]) < 1e-4
    assert float((a[1] - b[1]).abs().max()) <= 1e-4 * max(
        1.0, float(b[1].abs().max()))


def test_plain_probe_launches_k1_a_force(card):
    """The plain mobility probe on the card: Omelyan 'xla' steps, one K1
    launch a force (2 nstep + 1 a trajectory), no plain twin."""
    from fthmc_tpu_torch.mobility import mobility_probe
    _build.reset_counts()
    st = mobility_probe(None, None, L=16, beta=6.0, n_chains=32, ntraj=8,
                        therm=4, tau=0.5, nstep=4, call_block=4,
                        sampler="plain", device=card)
    n_traj = 4 + 8                     # one therm block of 4, two timed
    assert _build.LAUNCHES["K1"] == n_traj * (2 * 4 + 1)
    assert not any(_build.PLAIN_CALLS.values())
    assert st["ntraj"] == 8 and st["s_per_traj"] > 0


def test_runner_default_sync_polls_the_card(card):
    """The default sync on a CUDA tensor waits for the work behind it by
    polling an event, and the runner resumes on the card bit for bit."""
    import tempfile
    from fthmc_tpu_torch.runner import _default_sync, run_resilient
    x = torch.randn((256, 256), device=card)
    y = x @ x
    _default_sync(y)
    assert torch.cuda.current_stream(card).query()
    cfg = HMCConfig(beta=2.0, L=8, tau=0.5, nstep=4, n_chains=4)

    def step(g, z, n):
        import dataclasses
        return th.run_hmc(dataclasses.replace(cfg, ntraj=n), x0=z,
                          generator=g, device=card)

    z0 = torch.zeros((4, 2, 8, 8), device=card)
    with tempfile.TemporaryDirectory() as d:
        sp = f"{d}/s.npz"
        run_resilient(step, z0, generator=torch.Generator(card).manual_seed(
            3), ntraj=4, block=2, state_path=sp, max_retries=0)
        zr, hr, _ = run_resilient(step, z0, generator=torch.Generator(
            card).manual_seed(8), ntraj=8, block=2, state_path=sp,
            max_retries=0)
    zw, hw, _ = run_resilient(step, z0, generator=torch.Generator(
        card).manual_seed(3), ntraj=8, block=2, max_retries=0)
    assert zr.device.type == "cuda" and torch.equal(zr, zw)
    for k in hw:
        np.testing.assert_array_equal(hr[k], hw[k])


def test_mesh_era_capture_rule(card):
    """Whether a data-parallel step, NCCL all-reduces included, can be
    captured in a CUDA graph and replayed to the eager era's losses, found
    by ``parallel.capture_probe`` at world size 1 in a process of its own
    (a failed capture can leave the context unusable; nothing is caught):
    train.MESH_ERA_GRAPHED must say what the card does."""
    import os
    import subprocess
    import sys
    from fthmc_tpu_torch import train as tt
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-m",
                          "fthmc_tpu_torch.parallel.capture_probe"],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    captured = run.returncode == 0
    print("mesh era capture:", captured, run.stderr[-2000:])
    assert captured == tt.MESH_ERA_GRAPHED, run.stderr[-2000:]


def test_parallel_drivers_at_world_size_1_on_nccl(card):
    """One NCCL rank: sharded_run_hmc ('auto', K3 at 8^2) equals run_hmc
    on the rank generator bit for bit with the same launches; the domain
    step's core equals hmc_step's 'xla' path on the same draws to fp32
    roundoff, every halo row through the all-gather; ft_force_sharded
    equals the autograd force."""
    import torch.distributed as dist
    from fthmc_tpu_torch import lattice
    from fthmc_tpu_torch.parallel import domain as pdom
    from fthmc_tpu_torch.parallel import domain_flow as pdflow
    from fthmc_tpu_torch.parallel import mesh as pm
    pm.initialize_multihost(num_processes=1, process_id=0,
                            store=dist.HashStore())
    try:
        mesh = pm.make_chain_mesh(device=card)
        cfg = HMCConfig(beta=2.0, L=8, tau=1.0, nstep=8, ntraj=5,
                        n_chains=16, randinit=True, seed=4)
        _build.reset_counts()
        xs, hs = pm.sharded_run_hmc(mesh, cfg)
        ls = dict(_build.LAUNCHES)
        g = torch.Generator(card).manual_seed(cfg.seed)
        x0 = lattice.hot_start(g, cfg.n_chains, cfg.L, device=card)
        _build.reset_counts()
        x1, h1 = th.run_hmc(cfg, x0=x0, generator=pm.rank_generator(g, 0),
                            device=card)
        assert dict(_build.LAUNCHES) == ls and ls["K3"] == cfg.ntraj
        assert torch.equal(xs, x1)
        assert all(torch.equal(a, b) for a, b in zip(hs, h1))
        rows = pdom.make_rows_mesh(device=card)
        v0 = torch.randn(x0.shape, generator=g, device=card)
        u = torch.rand((cfg.n_chains,), generator=g, device=card)
        q0 = lattice.topo_charge(x0)
        pm.reset_collectives()
        xd, _, md = pdom._domain_hmc_step_from(
            x0, q0, v0, u, beta=2.0, dt=0.125, nstep=8, mesh=rows)
        assert pm.COLLECTIVES["all_gather"] == 2 * 8 + 4
        x1, v1 = th.leapfrog(x0, v0, 0.125, 8,
                             lambda x: lattice.force(x, 2.0))
        x1 = lattice.wrap(x1)
        dh = (lattice.delta_action(x1, x0, 2.0)
              + th._kinetic_delta(v1, v0))
        assert float((md.dh - dh).abs().max()) < 1e-3
        same = md.acc.bool() == (u < torch.exp(-dh))
        assert _wrapped(xd[same], torch.where(
            md.acc.bool()[:, None, None, None], x1, x0)[same]) < 1e-4
        spec = SPECS[1]
        params = init_flow_params(spec, torch.Generator().manual_seed(1),
                                  device=card)
        with full_fp32():
            f_d = pdflow.ft_force_sharded(params, spec, x0, 2.0, 8, rows)
            f_a = th.ft_force(params, spec, x0, 2.0, device=card)
        assert float((f_d - f_a).abs().max()) <= 1e-4 * float(
            f_a.abs().max())
    finally:
        dist.destroy_process_group()
