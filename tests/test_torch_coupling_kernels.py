"""Plain twins of K6, K7 and K8 against fthmc_tpu's XLA coupling layer.

The JAX side is the plain reference (link_coupling_forward and jax.vjp of
it), never interpret-mode Pallas. Float64, bound 1e-10: the twins and the
reference do the same arithmetic in another order (roundoff ~1e-13); K8's
twin is a hand-derived chain rule held against JAX autodiff."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.models import coupling as jc
from fthmc_tpu.models import masks as jm
from fthmc_tpu.ops import conv as jconv
from fthmc_tpu_torch.config import FlowSpec as TSpec
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.coupling_kernels import (coupling_forward,
                                                  kernel_fits,
                                                  kernel_flow_forward)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (coupling_bwd,
                                                      coupling_fwd_res)
from fthmc_tpu_torch.weights import flow_params_from_numpy

TOL = 1e-10
PI = math.pi


def np_layer(kw, seed, s_bias=0.0):
    """One coupling layer's conv parameters (float64 numpy); ``s_bias`` is
    added to the log-scale channels' bias, +s_bias on the first half of
    the components and -s_bias on the rest."""
    rng = np.random.default_rng(seed)
    M = kw["n_mixture"]
    out = 2 * M + 1 if kw["coupling"] == "rncp" else M + 1
    sizes = (2, *kw["hidden_sizes"], out)
    net = []
    for ci, co in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / math.sqrt(9 * ci)
        net.append({"w": rng.uniform(-bound, bound, (co, ci, 3, 3)),
                    "b": rng.uniform(-bound, bound, (co,))})
    net[-1]["b"][:M] += np.where(np.arange(M) < M // 2 + 1, s_bias, -s_bias)
    return net


def case(kw, seed=0, s_bias=0.0, B=6, L=8):
    net = np_layer(kw, seed, s_bias)
    rng = np.random.default_rng(seed + 100)
    x = rng.uniform(-PI, PI, (B, 2, L, L))
    gy = rng.normal(size=x.shape)
    gl = rng.normal(size=(B,))
    tspec = TSpec(n_layers=1, **kw)
    tnet = flow_params_from_numpy([net], tspec, device="cpu",
                                  dtype=torch.float64)[0]
    return net, x, gy, gl, JSpec(n_layers=1, **kw), tspec, tnet


def wrapped_diff(a, b):
    return np.abs(np.remainder(np.asarray(a) - np.asarray(b) + PI, 2 * PI)
                  - PI).max()


SPECS = [
    dict(coupling="ncp", n_mixture=2, hidden_sizes=(8,), s_clip=None),
    dict(coupling="ncp", n_mixture=3, hidden_sizes=(8, 8), s_clip=3.0),
    dict(coupling="rncp", n_mixture=4, hidden_sizes=(4,), s_clip=3.0),
    dict(coupling="rncp", n_mixture=2, hidden_sizes=(8, 8), s_clip=None,
         activation="tanh"),
]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("mu,off", [(0, 1), (1, 2)])
def test_k6_plain_matches_link_coupling_forward(kw, mu, off):
    net, x, _, _, jspec, tspec, tnet = case(kw)
    with jax.enable_x64():
        out = jc.link_coupling_forward(jax.tree.map(jnp.asarray, net),
                                       jnp.asarray(x), mu, off, jspec)
        ref_x, ref_l = np.asarray(out.x), np.asarray(out.logJ)
    before = _build.PLAIN_CALLS["K6"]
    fx, lj = coupling_forward(tnet, torch.as_tensor(x), mu, off, tspec)
    assert _build.PLAIN_CALLS["K6"] == before + 1
    assert wrapped_diff(fx.numpy(), ref_x) < TOL
    np.testing.assert_allclose(lj.numpy(), ref_l, rtol=0, atol=TOL)


def _jax_preacts(net, x, mu, off, activation):
    L = x.shape[-1]
    frozen = jnp.asarray(jm.plaq_masks((L, L), mu, off)[0], x.dtype)
    h = jc.stack_cos_sin(frozen * jc._plaq_of_links(x))
    pre = []
    for p in net:
        h = jconv.circular_conv2d(
            h if not pre else jconv.ACTIVATIONS[activation](pre[-1]),
            p["w"], p["b"])
        pre.append(h)
    return pre


@pytest.mark.parametrize("kw", SPECS)
def test_k7_plain_matches_forward_and_conv_intermediates(kw):
    mu, off = 1, 3
    net, x, _, _, jspec, tspec, tnet = case(kw, seed=1)
    with jax.enable_x64():
        jnet = jax.tree.map(jnp.asarray, net)
        out = jc.link_coupling_forward(jnet, jnp.asarray(x), mu, off, jspec)
        ref_x, ref_l = np.asarray(out.x), np.asarray(out.logJ)
        ref_res = [np.asarray(r) for r in _jax_preacts(
            jnet, jnp.asarray(x), mu, off, tspec.activation)]
    fx, lj, res = coupling_fwd_res(tnet, torch.as_tensor(x), mu, off, tspec)
    assert wrapped_diff(fx.numpy(), ref_x) < TOL
    np.testing.assert_allclose(lj.numpy(), ref_l, rtol=0, atol=TOL)
    assert len(res) == len(ref_res)
    for r, rr in zip(res, ref_res):
        np.testing.assert_allclose(r.numpy(), rr, rtol=0, atol=TOL)


def _vjp_case(kw, mu, off, seed=2, s_bias=0.0):
    net, x, gy, gl, jspec, tspec, tnet = case(kw, seed=seed, s_bias=s_bias)
    with jax.enable_x64():
        jnet = jax.tree.map(jnp.asarray, net)
        out, vjp = jax.vjp(lambda xx: jc.link_coupling_forward(
            jnet, xx, mu, off, jspec), jnp.asarray(x))
        (ref,) = vjp(jc.CouplingOut(x=jnp.asarray(gy), logJ=jnp.asarray(gl)))
        ref = np.asarray(ref)
        raw = np.asarray(_jax_preacts(jnet, jnp.asarray(x), mu, off,
                                      tspec.activation)[-1])
    xt = torch.as_tensor(x)
    _, _, res = coupling_fwd_res(tnet, xt, mu, off, tspec)
    gx = coupling_bwd(tnet, xt, res, torch.as_tensor(gy),
                      torch.as_tensor(gl), mu, off, tspec)
    return gx.numpy(), ref, raw


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("mu,off", [(0, 0), (1, 2)])
def test_k8_plain_matches_jax_vjp(kw, mu, off):
    gx, ref, _ = _vjp_case(kw, mu, off)
    np.testing.assert_allclose(gx, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("coupling", ["ncp", "rncp"])
def test_k8_plain_hard_clip_gradient(coupling):
    """|s| > 30 on active sites: the value path's hard clip has zero
    gradient there, while logJ keeps its (detached-|s|) slope."""
    kw = dict(coupling=coupling, n_mixture=2, hidden_sizes=(4,),
              s_clip=None)
    gx, ref, raw = _vjp_case(kw, 0, 1, seed=3, s_bias=40.0)
    assert (np.abs(raw[:, :2]) > 30).mean() > 0.9
    np.testing.assert_allclose(gx, ref, rtol=0, atol=TOL)


FLAGSHIP = TSpec(n_layers=24, coupling="rncp", n_mixture=8,
                 hidden_sizes=(32, 32), s_clip=3.0)


def test_kernel_envelope():
    # the flagship's shapes and the JAX package's envelope (L <= 8 or
    # B <= 128) at L a multiple of 4
    assert kernel_fits(FLAGSHIP, 16, 64)
    for B in (1, 32, 128):
        assert kernel_fits(FLAGSHIP, 64, B)
    assert kernel_fits(FLAGSHIP, 8, 4096)
    small = TSpec(n_layers=1, n_mixture=6, hidden_sizes=(8, 8))
    for L in (4, 8, 12, 16, 20, 32, 64):
        assert kernel_fits(small, L, 128)
    assert kernel_fits(small, 8, 1024)
    # loudly outside: spline, bf16, L not a multiple of 4, other kernel
    # sizes and activations
    assert not kernel_fits(TSpec(n_layers=1, coupling="spline"), 8, 64)
    assert not kernel_fits(TSpec(n_layers=1, conv_dtype="bfloat16"), 8, 64)
    assert not kernel_fits(small, 6, 64)
    assert not kernel_fits(TSpec(n_layers=1, kernel_size=5), 8, 64)
    assert not kernel_fits(TSpec(n_layers=1, activation="gelu"), 8, 64)
    # width and depth are the card's shared memory to judge, at launch
    # (tests/test_torch_cuda.py); the plain twins take any
    assert kernel_fits(TSpec(n_layers=1, hidden_sizes=(128, 128)), 16, 64)


def test_kernel_wrappers_refuse_other_devices():
    kw = dict(coupling="rncp", n_mixture=2, hidden_sizes=(4,), s_clip=3.0)
    _, _, _, _, _, tspec, tnet = case(kw)
    meta = torch.empty((2, 2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        coupling_forward(tnet, meta, 0, 0, tspec)
    with pytest.raises(ValueError):
        coupling_fwd_res(tnet, meta, 0, 0, tspec)
    with pytest.raises(ValueError):
        coupling_bwd(tnet, meta, (), meta, meta[:, 0, 0, 0], 0, 0, tspec)


def test_kernel_flow_forward_plain_chain():
    """kernel_flow_forward on the CPU is the stack of K6 twins: it equals
    the differentiable flow."""
    from fthmc_tpu_torch.models.flow import flow_forward
    spec = TSpec(n_layers=3, coupling="rncp", n_mixture=2,
                 hidden_sizes=(4,), s_clip=3.0)
    tree = [np_layer(dict(coupling="rncp", n_mixture=2, hidden_sizes=(4,)),
                     s) for s in range(3)]
    params = flow_params_from_numpy(tree, spec, device="cpu",
                                    dtype=torch.float64)
    z = torch.as_tensor(np.random.default_rng(9).uniform(-PI, PI,
                                                         (4, 2, 8, 8)))
    y, ld = kernel_flow_forward(params, z, spec)
    y_ref, ld_ref = flow_forward(params, z, spec)
    assert wrapped_diff(y.numpy(), y_ref.detach().numpy()) < TOL
    np.testing.assert_allclose(ld.numpy(), ld_ref.detach().numpy(),
                               atol=TOL)
