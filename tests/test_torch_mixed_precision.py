"""FlowSpec.conv_dtype='bfloat16' and FlowSpec.s_clip in fthmc_tpu_torch: a
mirror of tests/test_mixed_precision.py on the JAX package's own parameters
(the conftest's params2, carried across as numpy) and inputs.

FT-HMC's <exp(-dH)> = 1 holds for any invertible map: bf16 convs change
which flow is applied, not detailed balance, so the bf16 flow passes the
exactness test while its fields differ slightly from fp32's. The fp32 side
of each comparison runs under ops/conv.full_fp32 (no TF32)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.models import coupling as jc
from fthmc_tpu.models import flow as jf
from fthmc_tpu.models.masks import plaq_masks as jplaq_masks
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
from fthmc_tpu_torch.models import coupling as C
from fthmc_tpu_torch.models.flow import (flow_forward, flow_reverse,
                                         init_flow_params)
from fthmc_tpu_torch.models.masks import plaq_masks
from fthmc_tpu_torch.models.spline import spline_forward
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.weights import flow_params_from_numpy

PI = math.pi
SPEC32 = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,), kernel_size=3)
BF16 = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,),
                conv_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes that share the cores, and OpenMP's parallel regions on
    these small tensors stall when the workers' threads outnumber them
    (a 1 s probe took 112 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def tparams(params2):
    """The conftest's JAX flow (2 ncp layers, hidden (4,)) in the port."""
    return flow_params_from_numpy(_np_tree(params2), SPEC32, device="cpu")


@pytest.fixture(scope="module")
def z8(x_batch):
    return torch.as_tensor(np.array(x_batch))


def _wrapped_max(a, b):
    return float(C.wrap_pi(a - b).abs().max())


def test_bf16_flow_close_to_fp32(tparams, z8):
    with torch.no_grad(), full_fp32():
        y32, ld32 = flow_forward(tparams, z8, SPEC32)
        y16, ld16 = flow_forward(tparams, z8, BF16)
    assert y16.dtype == torch.float32     # bf16 convs, fp32 results
    assert _wrapped_max(y16, y32) < 0.05
    assert float((ld16 - ld32).abs().max()) < 0.5


def test_bf16_conditioner_and_flow_match_jax(params2, tparams, x_batch, z8):
    """The port's bf16 conditioner and flow against the JAX package's on the
    same fp32 inputs. Both round the same operands to bf16 and round each
    conv's fp32 accumulation to bf16; the two CPU conv libraries sum in
    other orders, so a conv output may differ by one bf16 ulp (2^-8
    relative) where the accumulation lands near a rounding boundary. The
    conditioner is held to 2 bf16 ulps of its largest output (2^-7 x
    max|out|), the flow's fields to 0.01 and log-det to 0.1: five times
    tighter than the bf16-vs-fp32 bounds (0.05, 0.5) of the test above."""
    plaq = C.plaq_of_links(z8)
    frozen = torch.as_tensor(plaq_masks((8, 8), 0, 0)[0], dtype=torch.float32)
    with torch.no_grad():
        got = C.conditioner(tparams[0], frozen, plaq, BF16)
        y16, ld16 = flow_forward(tparams, z8, BF16)
    jspec = JSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,),
                  conv_dtype="bfloat16")
    jfrozen = jnp.asarray(jplaq_masks((8, 8), 0, 0)[0], jnp.float32)
    jplaq = jc._plaq_of_links(x_batch)
    s, t = jc._net_s_t(params2[0], jfrozen, jplaq, jspec)
    want = np.concatenate([np.asarray(s), np.asarray(t)[:, None]], axis=1)
    got_s, got_t = C.plaq_net_split(got, BF16)
    got = torch.cat([got_s, got_t[:, None]], dim=1).numpy()
    assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
    yj, ldj = jf.flow_forward(params2, x_batch, jspec)
    assert _wrapped_max(y16, torch.as_tensor(np.asarray(yj))) < 0.01
    assert float(np.abs(ld16.numpy() - np.asarray(ldj)).max()) < 0.1


def test_bf16_flow_roundtrip(tparams, z8):
    """Forward and reverse run the same bf16 convs, so the bf16 flow is
    inverted exactly (to the bisection's tolerance)."""
    with torch.no_grad():
        y, ld = flow_forward(tparams, z8, BF16)
    x2, ldr = flow_reverse(tparams, y, BF16)
    assert _wrapped_max(x2, z8) < 5e-4
    np.testing.assert_allclose(ld.numpy(), -ldr.numpy(), atol=5e-3)


def test_bf16_fthmc_exactness(tparams):
    """<exp(-dH)> = 1 with the bf16-conv flow: the JAX test's 16 chains at
    8^2, beta=1.5, 48 trajectories, through the autograd force (the kernels
    refuse bf16)."""
    lf = LeapfrogConfig(tau=0.5, nstep=8)
    _, hist = th.run_fthmc(tparams, BF16, lf, beta=1.5, ntraj=48,
                           z0=torch.zeros((16, 2, 8, 8)),
                           generator=torch.Generator().manual_seed(9),
                           force_backend="autograd", device="cpu")
    em = hist.exp_mdh[12:].numpy()
    assert np.all(np.isfinite(em))
    assert abs(em.mean() - 1.0) < 0.1
    assert float(hist.acc[12:].float().mean()) > 0.3
    with pytest.raises(ValueError, match="conv_dtype"):
        th.resolve_force_backend("kernel", BF16, (16, 2, 8, 8),
                                 torch.float32, "cpu")


def test_bf16_grads_finite(tparams):
    z = torch.as_tensor(np.random.default_rng(0).uniform(
        -PI, PI, (4, 2, 8, 8)).astype(np.float32))
    f = th.ft_force(tparams, BF16, z, 2.0, device="cpu")
    assert bool(torch.isfinite(f).all())
    # the gradient reaches the fp32 parameters through the casts
    w = tparams[0][0]["w"].detach().clone().requires_grad_(True)
    p = [[dict(c) for c in net] for net in tparams]
    p[0][0]["w"] = w
    _, ld = flow_forward(p, z, BF16)
    (g,) = torch.autograd.grad(ld.sum(), w)
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# s_clip: the FT-HMC integrability knob
# ---------------------------------------------------------------------------

def _blown_up(spec, seed=0):
    params = init_flow_params(spec, torch.Generator().manual_seed(seed),
                              device="cpu")
    params[0][-1] = {"w": torch.full_like(params[0][-1]["w"], 50.0),
                     "b": torch.full_like(params[0][-1]["b"], 50.0)}
    return params


def _links(seed=1):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -PI, PI, (2, 2, 8, 8)).astype(np.float32))


def test_s_clip_bounds_ncp_transform_slope():
    """With s_clip=c the transform's derivative lies in [e^-c, e^c]
    whatever the CNN emits: s passes through c tanh(s/c). The plaquette
    forward is plaq_coupling_forward."""
    c = 1.5
    spec = FlowSpec(n_layers=1, n_mixture=2, hidden_sizes=(4,), s_clip=c)
    params = _blown_up(spec)
    plaq = C.plaq_of_links(_links())
    frozen, active, _ = (torch.as_tensor(m, dtype=torch.float32)
                         for m in plaq_masks((8, 8), 0, 0))
    s, t = C.plaq_net_split(C.conditioner(params[0], frozen, plaq, spec),
                            spec)
    assert float(s.abs().max()) <= c + 1e-5
    out = C.plaq_coupling_forward(params[0], plaq, 0, 0, spec)
    assert float(out.logJ.abs().max()) <= c * float(active.sum()) + 1e-3


def test_s_clip_bounds_spline_logits():
    c, K = 1.0, 6
    spec = FlowSpec(n_layers=1, coupling="spline", n_knots=K,
                    hidden_sizes=(4,), s_clip=c)
    params = _blown_up(spec)
    plaq = C.plaq_of_links(_links())
    frozen = torch.as_tensor(plaq_masks((8, 8), 0, 0)[0], dtype=torch.float32)
    raw, t = C.plaq_net_split(C.conditioner(params[0], frozen, plaq, spec),
                              spec)
    assert raw.shape[1] == 3 * K
    assert float(raw.abs().max()) <= c + 1e-5
    # width and height logits in [-c, c]: the bin aspect stays below e^{2c}
    _, lj = spline_forward(plaq, raw, K)
    assert float(lj.abs().max()) < 2 * c + 3.0


def test_s_clip_noop_when_small():
    """c tanh(s/c) ~ s for |s| << c: a large s_clip leaves the flow as it
    is."""
    spec_off = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,))
    spec_on = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,),
                       s_clip=30.0)
    params = init_flow_params(spec_off, torch.Generator().manual_seed(3),
                              device="cpu")
    x = _links(4)
    with torch.no_grad(), full_fp32():
        y0, l0 = flow_forward(params, x, spec_off)
        y1, l1 = flow_forward(params, x, spec_on)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), atol=1e-4)
    np.testing.assert_allclose(l0.numpy(), l1.numpy(), atol=1e-3)
