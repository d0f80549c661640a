"""fthmc_tpu_torch flow (masks, conv chain, the dense-circulant conv, the
ncp/rncp/spline couplings and plaquette forwards, the stack) against
fthmc_tpu on the same float64 numpy parameters and fields.

Bound 1e-10: the forward maps are a few dozen fp64 operations per site
(roundoff ~1e-14). The bisection inverses take the same branch at every
halving in both packages, so they agree to the same order."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.models import coupling as jc
from fthmc_tpu.models import flow as jf
from fthmc_tpu.models import masks as jm
from fthmc_tpu.ops import conv as jconv
from fthmc_tpu_torch.config import FlowSpec as TSpec
from fthmc_tpu_torch.models import coupling as tc
from fthmc_tpu_torch.models import flow as tf
from fthmc_tpu_torch.models import masks as tm
from fthmc_tpu_torch.ops import conv as tconv
from fthmc_tpu_torch.weights import flow_params_from_numpy

TOL = 1e-10
PI = math.pi


def np_tree(kw, seed):
    """JAX-layout flow parameters as float64 numpy, torch-default scale."""
    rng = np.random.default_rng(seed)
    M = kw.get("n_mixture", 2)
    out = {"rncp": 2 * M + 1, "spline": 3 * kw.get("n_knots", 8) + 1}.get(
        kw.get("coupling"), M + 1)
    sizes = (2, *kw.get("hidden_sizes", (8, 8)), out)
    tree = []
    for _ in range(kw.get("n_layers", 24)):
        net = []
        for ci, co in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / math.sqrt(9 * ci)
            net.append({"w": rng.uniform(-bound, bound, (co, ci, 3, 3)),
                        "b": rng.uniform(-bound, bound, (co,))})
        tree.append(net)
    return tree


def both(kw, seed):
    """(jax spec, jax params, port spec, port params), float64."""
    tree = np_tree(kw, seed)
    tspec = TSpec(**kw)
    return (JSpec(**kw), jax.tree.map(jnp.asarray, tree), tspec,
            flow_params_from_numpy(tree, tspec, device="cpu",
                                   dtype=torch.float64))


def links(seed, B=4, L=8):
    return np.random.default_rng(seed).uniform(-PI, PI, (B, 2, L, L))


def wrapped_diff(a, b):
    return np.abs(np.remainder(np.asarray(a) - np.asarray(b) + PI, 2 * PI)
                  - PI).max()


@pytest.mark.parametrize("L", [4, 8, 12, 16])
def test_masks_equal_and_closed_form(L):
    for mu in (0, 1):
        for off in range(4):
            np.testing.assert_array_equal(
                tm.link_active_stripes((2, L, L), mu, off),
                jm.link_active_stripes((2, L, L), mu, off))
            frozen, active, passive = tm.plaq_masks((L, L), mu, off)
            for a, b in zip((frozen, active, passive),
                            jm.plaq_masks((L, L), mu, off)):
                np.testing.assert_array_equal(a, b)
            # the kernels' closed form: stripe = (coord - off) % 4
            i, j = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
            st = ((j if mu == 0 else i) - off) % 4
            np.testing.assert_array_equal(active, st == 0)
            np.testing.assert_array_equal(frozen, (st == 1) | (st == 2))
            np.testing.assert_array_equal(passive, st == 3)
            np.testing.assert_array_equal(
                tm.link_active_stripes((2, L, L), mu, off)[mu], st == 0)
    assert [tm.layer_mask_params(i) for i in range(10)] == \
        [jm.layer_mask_params(i) for i in range(10)]


@pytest.mark.parametrize("activation", ["silu", "relu", "tanh",
                                        "leaky_relu"])
def test_conv_net_apply_matches(activation):
    net = np_tree({"hidden_sizes": (6, 5), "n_layers": 1}, 0)[0]
    x = np.random.default_rng(1).normal(size=(3, 2, 8, 8))
    with jax.enable_x64():
        ref = np.asarray(jconv.conv_net_apply(
            jax.tree.map(jnp.asarray, net), jnp.asarray(x), activation))
    tnet = [{k: torch.as_tensor(v) for k, v in c.items()} for c in net]
    got = tconv.conv_net_apply(tnet, torch.as_tensor(x), activation)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_init_conv_net_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    for init in ("reference", "normal", "set_weights_bug"):
        net = tconv.init_conv_net(g, 2, (8, 8), 5, 3, init=init,
                                  device="cpu")
        assert [tuple(p["w"].shape) for p in net] == \
            [(8, 2, 3, 3), (8, 8, 3, 3), (5, 8, 3, 3)]
        assert [tuple(p["b"].shape) for p in net] == [(8,), (8,), (5,)]
    ref = tconv.init_conv_net(g, 2, (8,), 5, 3, init="reference",
                              device="cpu")
    assert float(ref[0]["w"].abs().max()) <= 1 / math.sqrt(18)
    assert float(ref[1]["w"].abs().max()) <= 1 / math.sqrt(72)
    bug = tconv.init_conv_net(g, 2, (8,), 5, 3, init="set_weights_bug",
                              device="cpu")
    assert bool((bug[0]["b"] == -1).all())
    with pytest.raises(ValueError):
        tconv.init_conv_net(g, 2, (8,), 5, 3, init="bogus", device="cpu")


COUPLINGS = [("ncp", 2, None), ("ncp", 3, 3.0), ("rncp", 2, None),
             ("rncp", 4, 3.0)]


@pytest.mark.parametrize("coupling,M,s_clip", COUPLINGS)
def test_link_coupling_forward_reverse_match(coupling, M, s_clip):
    kw = dict(n_layers=1, coupling=coupling, n_mixture=M,
              hidden_sizes=(8,), s_clip=s_clip)
    x = links(3)
    with jax.enable_x64():
        jspec, jp, tspec, tp = both(kw, 11)
        fj = jc.link_coupling_forward(jp[0], jnp.asarray(x), 1, 2, jspec)
        rj = jc.link_coupling_reverse(jp[0], fj.x, 1, 2, jspec)
        fj, rj = [tuple(np.asarray(a) for a in o) for o in (fj, rj)]
    ft = tc.link_coupling_forward(tp[0], torch.as_tensor(x), 1, 2, tspec)
    assert wrapped_diff(ft.x.numpy(), fj[0]) < TOL
    np.testing.assert_allclose(ft.logJ.numpy(), fj[1], rtol=0, atol=TOL)
    rt = tc.link_coupling_reverse(tp[0], torch.tensor(fj[0]), 1, 2, tspec)
    assert wrapped_diff(rt.x.numpy(), rj[0]) < TOL
    np.testing.assert_allclose(rt.logJ.numpy(), rj[1], rtol=0, atol=TOL)
    # and the reverse inverts the forward, logJ antisymmetric
    assert wrapped_diff(rt.x.numpy(), x) < 1e-5
    np.testing.assert_allclose(rt.logJ.numpy(), -ft.logJ.numpy(), atol=1e-5)


def test_flow_forward_reverse_logdet_match():
    kw = dict(n_layers=3, coupling="rncp", n_mixture=3, hidden_sizes=(8,),
              s_clip=3.0)
    z = links(5)
    with jax.enable_x64():
        jspec, jp, tspec, tp = both(kw, 12)
        yj, ldj = jf.flow_forward(jp, jnp.asarray(z), jspec)
        xj, lrj = jf.flow_reverse(jp, yj, jspec)
        yj, ldj, xj, lrj = map(np.asarray, (yj, ldj, xj, lrj))
    yt, ldt = tf.flow_forward(tp, torch.as_tensor(z), tspec)
    assert wrapped_diff(yt.detach().numpy(), yj) < TOL
    np.testing.assert_allclose(ldt.detach().numpy(), ldj, rtol=0, atol=TOL)
    xt, lrt = tf.flow_reverse(tp, torch.tensor(yj), tspec)
    assert wrapped_diff(xt.numpy(), xj) < TOL
    np.testing.assert_allclose(lrt.numpy(), lrj, rtol=0, atol=TOL)
    assert tf.count_parameters(tp) == jf.count_parameters(jp)


def test_remat_changes_nothing():
    kw = dict(n_layers=2, coupling="rncp", n_mixture=2, hidden_sizes=(4,),
              s_clip=3.0)
    _, _, tspec, tp = both(kw, 13)
    grads = []
    for remat in (True, False):
        z = torch.as_tensor(links(6)).requires_grad_(True)
        y, ld = tf.flow_forward(tp, z, tspec, remat=remat)
        (g,) = torch.autograd.grad((torch.cos(y).sum() - ld.sum()), z)
        grads.append(g)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-13)


def test_spline_flow_init_forward_reverse_match():
    """A spline flow: init_flow_params gives the JAX package's shapes
    (3K + 1 conditioner outputs), and the stack's forward and analytic
    reverse equal JAX's on the same parameters."""
    kw = dict(n_layers=3, coupling="spline", n_knots=5, hidden_sizes=(6,),
              s_clip=3.0)
    fresh = tf.init_flow_params(TSpec(**kw), torch.Generator().manual_seed(0),
                                device="cpu")
    jfresh = jf.init_flow_params(jax.random.PRNGKey(0), JSpec(**kw))
    assert [[tuple(c["w"].shape) for c in net] for net in fresh] == \
        [[tuple(c["w"].shape) for c in net] for net in jfresh]
    assert tf.count_parameters(fresh) == jf.count_parameters(jfresh)
    z = links(7)
    with jax.enable_x64():
        jspec, jp, tspec, tp = both(kw, 14)
        yj, ldj = jf.flow_forward(jp, jnp.asarray(z), jspec)
        xj, lrj = jf.flow_reverse(jp, yj, jspec)
        yj, ldj, xj, lrj = map(np.asarray, (yj, ldj, xj, lrj))
    yt, ldt = tf.flow_forward(tp, torch.as_tensor(z), tspec)
    assert wrapped_diff(yt.detach().numpy(), yj) < TOL
    np.testing.assert_allclose(ldt.detach().numpy(), ldj, rtol=0, atol=TOL)
    xt, lrt = tf.flow_reverse(tp, torch.tensor(yj), tspec)
    assert wrapped_diff(xt.numpy(), xj) < TOL
    np.testing.assert_allclose(lrt.numpy(), lrj, rtol=0, atol=TOL)
    assert wrapped_diff(xt.numpy(), z) < 1e-8


@pytest.mark.parametrize("coupling,M,s_clip", COUPLINGS + [("spline", 4, 3.0)])
def test_plaq_coupling_forward_matches(coupling, M, s_clip):
    """The plaquette-level forward (plaq_coupling_forward, its rncp and
    spline aliases, plaq_transform_forward) against JAX's on plaquette
    angles outside [-pi, pi), as a flow feeds it."""
    kw = dict(n_layers=1, coupling=coupling, n_mixture=M, n_knots=M,
              hidden_sizes=(8,), s_clip=s_clip)
    plaq = 1.5 * links(8)[:, 0] + links(9)[:, 1]
    fns = {"ncp": ("plaq_coupling_forward",),
           "rncp": ("rncp_plaq_coupling_forward",),
           "spline": ("spline_plaq_coupling_forward",)}[coupling] + (
        "plaq_transform_forward",)
    for name in fns:
        with jax.enable_x64():
            jspec, jp, tspec, tp = both(kw, 15)
            fj = getattr(jc, name)(jp[0], jnp.asarray(plaq), 0, 3, jspec)
            fj = tuple(np.asarray(a) for a in fj)
        ft = getattr(tc, name)(tp[0], torch.as_tensor(plaq), 0, 3, tspec)
        np.testing.assert_allclose(ft.x.detach().numpy(), fj[0], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(ft.logJ.detach().numpy(), fj[1], rtol=0,
                                   atol=TOL)


def test_dense_circulant_matches_jax_and_the_conv():
    """dense_circulant against JAX's matrix, and circular_conv2d_dense
    against circular_conv2d and JAX's, values and weight gradients (the
    JAX test's shapes: 8 outputs, 2 inputs, 8^2, 4 chains)."""
    rng = np.random.default_rng(0)
    w, b = rng.normal(size=(8, 2, 3, 3)), rng.normal(size=(8,))
    x = rng.normal(size=(4, 2, 8, 8))
    with jax.enable_x64():
        Dj = np.asarray(jconv.dense_circulant(jnp.asarray(w), 8))
        yj = np.asarray(jconv.circular_conv2d_dense(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    wt = torch.as_tensor(w).requires_grad_(True)
    np.testing.assert_array_equal(
        tconv.dense_circulant(wt, 8).detach().numpy(), Dj)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    y2 = tconv.circular_conv2d_dense(xt, wt, bt)
    y1 = tconv.circular_conv2d(xt, wt, bt)
    np.testing.assert_allclose(y2.detach().numpy(), yj, rtol=0, atol=TOL)
    np.testing.assert_allclose(y2.detach().numpy(), y1.detach().numpy(),
                               rtol=0, atol=TOL)
    (g1,) = torch.autograd.grad(torch.sin(y1).sum(), wt)
    (g2,) = torch.autograd.grad(torch.sin(y2).sum(), wt)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=0, atol=1e-9)
    # a lattice smaller than the kernel's reach: taps alias and add up
    np.testing.assert_allclose(
        tconv.circular_conv2d_dense(xt[:, :, :2, :2], wt, bt).detach(),
        tconv.circular_conv2d(xt[:, :, :2, :2], wt, bt).detach(), atol=TOL)
