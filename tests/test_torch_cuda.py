"""The CUDA kernels on the card, against their plain twins, at small shapes.

Marked ``cuda``: each test skips without a card. This file imports only
torch and the port, so it also runs on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

fp32 bounds: sum-order roundoff through the conv chain (fx wrapped 1e-4,
logJ 1e-4 relative, gx 2e-3 * max|ref| as the JAX package's own fp32
kernel tests use)."""
import math

import pytest
import torch

from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.models.flow import init_flow_params
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_kernels import (coupling_forward,
                                                  coupling_forward_plain,
                                                  smem_bytes, smem_limit)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (coupling_bwd,
                                                      coupling_bwd_plain,
                                                      coupling_fwd_res,
                                                      coupling_fwd_res_plain)
from fthmc_tpu_torch.ops.lattice_kernels import force, force_plain

pytestmark = pytest.mark.cuda

SPECS = [FlowSpec(n_layers=2, coupling="ncp", n_mixture=3,
                  hidden_sizes=(8,), activation="tanh"),
         FlowSpec(n_layers=2, coupling="rncp", n_mixture=8,
                  hidden_sizes=(32, 32), s_clip=3.0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _wrapped(a, b):
    return float((torch.remainder(a - b + math.pi, 2 * math.pi)
                  - math.pi).abs().max())


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("B,L", [(4, 8), (3, 20)])
def test_kernels_match_plain_twins(card, spec, B, L):
    g = torch.Generator(device=card).manual_seed(0)
    params = init_flow_params(spec, torch.Generator().manual_seed(1),
                              device=card)
    x = (torch.rand((B, 2, L, L), generator=g, device=card) * 2 - 1) * math.pi
    gy = torch.randn((B, 2, L, L), generator=g, device=card)
    gl = torch.randn((B,), generator=g, device=card)
    before = dict(_build.LAUNCHES)
    with full_fp32():
        f = force(x, 2.0)
        assert float((f - force_plain(x, 2.0)).abs().max()) < 1e-5
        # every (mu, off) a flow's layers take, layer mu's weights for mu
        for mu, off in [(m, o) for o in range(4) for m in (0, 1)]:
            layer = params[mu]
            fx, lj = coupling_forward(layer, x, mu, off, spec)
            fx_p, lj_p = coupling_forward_plain(layer, x, mu, off, spec)
            assert _wrapped(fx, fx_p) < 1e-4
            assert float((lj - lj_p).abs().max()) < \
                1e-4 * max(1.0, float(lj_p.abs().max()))
            fx7, lj7, res = coupling_fwd_res(layer, x, mu, off, spec)
            _, _, res_p = coupling_fwd_res_plain(layer, x, mu, off, spec)
            assert _wrapped(fx7, fx_p) < 1e-4
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
    assert launched == {"K1": 1, "K6": 8, "K7": 8, "K8": 8}


def test_shared_memory_envelope(card):
    # one flagship block: 32x32 conv weights + bias + a 32-channel 18^2
    # haloed tile + 256 reduction floats, as the kernels' smem_layout says
    assert smem_bytes((2, 32, 32, 17), 16) == 4 * (9216 + 32 + 10368 + 256)
    assert smem_bytes(tuple([2] + [4] * 8 + [3]), 8) == -1   # 9 convs
    assert smem_bytes((2, 32, 32, 17), 64) <= smem_limit(card.index or 0)
    wide = FlowSpec(n_layers=1, hidden_sizes=(128, 128))
    assert smem_bytes((2, 128, 128, 3), 16) > smem_limit(card.index or 0)
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
