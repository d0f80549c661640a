"""fthmc_tpu_torch's circular rational-quadratic spline (models/spline.py and
the spline coupling) against fthmc_tpu's: a mirror of tests/test_spline.py,
each test also held against the JAX package in float64 on the same numpy
inputs.

Bound 1e-10 against JAX: the spline is a few dozen fp64 operations a site
and both packages pick the bin by the same comparisons, cum[k] <= u <
cum[k+1], so they agree to roundoff (~1e-14). Points exactly on a knot go
to the bin above it in both; a different choice would move the results by
~1e-3, not by roundoff."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import hmc as jh
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.models import coupling as jc
from fthmc_tpu.models import flow as jf
from fthmc_tpu.models import spline as js
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch.config import FlowSpec as TSpec
from fthmc_tpu_torch.config import LeapfrogConfig
from fthmc_tpu_torch.models import coupling as tc
from fthmc_tpu_torch.models import flow as tf
from fthmc_tpu_torch.models import spline as ts
from fthmc_tpu_torch.weights import flow_params_from_numpy

PI = math.pi
K = 6
TOL = 1e-10
SPEC_KW = dict(n_layers=2, coupling="spline", n_knots=K, hidden_sizes=(4,),
               kernel_size=3)


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


def spline_tree(kw, seed, scale=1.0):
    """A spline flow's parameters as float64 numpy, torch-default scale
    times ``scale``."""
    rng = np.random.default_rng(seed)
    sizes = (2, *kw["hidden_sizes"], 3 * kw["n_knots"] + 1)
    tree = []
    for _ in range(kw["n_layers"]):
        net = []
        for ci, co in zip(sizes[:-1], sizes[1:]):
            bound = scale / math.sqrt(9 * ci)
            net.append({"w": rng.uniform(-bound, bound, (co, ci, 3, 3)),
                        "b": rng.uniform(-bound, bound, (co,))})
        tree.append(net)
    return tree


def both(kw, seed, dtype=torch.float64, scale=1.0):
    """(jax spec, jax params (float64 numpy tree), port spec, port params)."""
    tree = spline_tree(kw, seed, scale)
    tspec = TSpec(**kw)
    return (JSpec(**kw), tree, tspec,
            flow_params_from_numpy(tree, tspec, device="cpu", dtype=dtype))


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def raw_batch(seed=1, L=8):
    return 0.8 * np.random.default_rng(seed).normal(size=(3, 3 * K, L, L))


def ang_batch(seed=2, L=8):
    return np.random.default_rng(seed).uniform(-PI, PI, (3, L, L))


def links(seed, B=4, L=8):
    return np.random.default_rng(seed).uniform(-PI, PI, (B, 2, L, L))


def jax_spline(fn, x, raw):
    with jax.enable_x64():
        return [np.asarray(a) for a in getattr(js, fn)(
            jnp.asarray(x), jnp.asarray(raw), K)]


def port_spline(fn, x, raw):
    return [a.numpy() for a in getattr(ts, fn)(
        torch.as_tensor(x), torch.as_tensor(raw), K)]


def close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def wrapped(a, b):
    return float(np.abs(np.remainder(np.asarray(a) - np.asarray(b) + PI,
                                     2 * PI) - PI).max())


def test_out_channels():
    assert tf.flow_out_channels(TSpec(**SPEC_KW)) == 3 * K + 1 == \
        jf.flow_out_channels(JSpec(**SPEC_KW))
    assert tf.flow_out_channels(TSpec(n_mixture=4)) == 5
    assert ts.spline_out_channels(K) == js.spline_out_channels(K)
    assert (ts._MIN_BIN, ts._MIN_DERIV, ts._D_SHIFT) == \
        (js._MIN_BIN, js._MIN_DERIV, js._D_SHIFT)


def test_identity_at_zero_raw():
    x, raw0 = ang_batch(), np.zeros((3, 3 * K, 8, 8))
    y, lj = port_spline("spline_forward", x, raw0)
    np.testing.assert_allclose(y, x, atol=1e-5)
    assert np.abs(lj).max() < 1e-4
    close((y, lj), jax_spline("spline_forward", x, raw0))


def test_monotone_and_range():
    xs = np.broadcast_to(np.linspace(-PI, PI - 1e-4, 201)[None, :, None],
                         (3, 201, 1)).copy()
    raws = np.broadcast_to(raw_batch()[:, :, :1, :1],
                           (3, 3 * K, 201, 1)).copy()
    ys, lj = port_spline("spline_forward", xs, raws)
    assert np.all(np.diff(ys, axis=1) > -1e-6)
    assert np.abs(ys).max() <= PI + 1e-5
    close((ys, lj), jax_spline("spline_forward", xs, raws))


def test_analytic_inverse_roundtrip():
    x, raw = ang_batch(), raw_batch()
    y, lj = port_spline("spline_forward", x, raw)
    x2, lj2 = port_spline("spline_inverse", y, raw)
    np.testing.assert_allclose(x2, x, atol=1e-4)
    np.testing.assert_allclose(lj, lj2, atol=1e-4)
    close((x2, lj2), jax_spline("spline_inverse", y, raw))


def test_logJ_matches_numeric_derivative():
    x, raw, h = ang_batch(), raw_batch(), 1e-3
    yp, _ = port_spline("spline_forward", x + h, raw)
    ym, _ = port_spline("spline_forward", x - h, raw)
    num = (yp - ym) / (2 * h)
    ana = np.exp(port_spline("spline_forward", x, raw)[1])
    # the central difference crosses the wrap seam or a knot at a few sites
    ok = np.abs(num - ana) < 5e-2 * np.maximum(ana, 1.0)
    assert ok.mean() > 0.98
    close(port_spline("spline_forward", x + h, raw),
          jax_spline("spline_forward", x + h, raw))


def test_wrap_invariance():
    """Plaquette angles lie outside [-pi, pi): the transform is
    2pi-periodic in its input, value and logJ."""
    x, raw = ang_batch(), raw_batch()
    y1, lj1 = port_spline("spline_forward", x, raw)
    y2, lj2 = port_spline("spline_forward", x + 2 * PI, raw)
    np.testing.assert_allclose(y1, y2, atol=1e-4)
    np.testing.assert_allclose(lj1, lj2, atol=1e-4)
    close((y2, lj2), jax_spline("spline_forward", x + 2 * PI, raw))


def test_grads_finite():
    x, raw = ang_batch(), raw_batch()
    r = torch.as_tensor(raw).requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    y, lj = ts.spline_forward(xt, r, K)
    gr, gx = torch.autograd.grad(y.sum() + lj.sum(), (r, xt))
    assert np.all(np.isfinite(gr.numpy())) and np.all(np.isfinite(gx.numpy()))
    with jax.enable_x64():
        def obj(rr, xx):
            yy, ll = js.spline_forward(xx, rr, K)
            return jnp.sum(yy) + jnp.sum(ll)
        jgr, jgx = jax.grad(obj, argnums=(0, 1))(jnp.asarray(raw),
                                                 jnp.asarray(x))
    close((gr.numpy(), gx.numpy()), (np.asarray(jgr), np.asarray(jgx)))


def _on_knot(c: float):
    """An angle x whose u = (wrap(x) + pi) / 2pi, computed as the spline
    computes it, is exactly c: the nearest such among the float64
    neighbours of c 2pi - pi, or None."""
    lo = hi = c * 2 * PI - PI
    for _ in range(64):
        for x in (lo, hi):
            if (np.remainder(x + PI, 2 * PI) - PI + PI) / (2 * PI) == c:
                return float(x)
        lo, hi = np.nextafter(lo, -np.inf), np.nextafter(hi, np.inf)
    return None


@pytest.mark.parametrize("fn,knots", [("spline_forward", 0),
                                      ("spline_inverse", 1)])
def test_points_on_knots_take_the_upper_bin(fn, knots):
    """Inputs exactly on an interior knot (cum_w for the forward, cum_h for
    the inverse), at every site: JAX's rule cum[k] <= u < cum[k+1] puts
    them in bin k, the bin above the knot, and the port's results equal
    JAX's. (Knots below 1/2 are skipped where no float64 angle lands on
    them exactly: u is coarser there than the knot's own resolution.)"""
    raw = raw_batch(3, L=4)[:1]
    cum = ts.spline_knots(torch.as_tensor(raw), K)[knots].numpy()
    x = np.empty((1, 4, 4))
    want_bin = np.empty((1, 4, 4), dtype=int)
    for i in range(4):
        for j in range(4):
            first = 1 + (4 * i + j) % (K - 1)      # vary the knot by site
            for k in [*range(first, K), *range(1, first)]:
                xk = _on_knot(cum[0, k, i, j])
                if xk is not None:
                    x[0, i, j], want_bin[0, i, j] = xk, k
                    break
            else:
                raise AssertionError(f"no knot reachable at site {i, j}")
    assert len(np.unique(want_bin)) >= 3
    u = torch.as_tensor((np.remainder(x + PI, 2 * PI) - PI + PI) / (2 * PI))
    np.testing.assert_array_equal(
        u.numpy(), np.take_along_axis(cum, want_bin[:, None], 1)[:, 0])
    oh = ts._select_bin(torch.as_tensor(cum), u, K).numpy()
    np.testing.assert_array_equal(oh.argmax(axis=1), want_bin)
    assert np.all(oh.sum(axis=1) == 1)
    with jax.enable_x64():
        joh = np.asarray(js._select_bin(jnp.asarray(cum), jnp.asarray(
            u.numpy()), K))
    np.testing.assert_array_equal(oh, joh)
    close(port_spline(fn, x, raw), jax_spline(fn, x, raw))


def test_link_coupling_roundtrip_and_logdet():
    jspec, tree, tspec, tp = both(SPEC_KW, 5)
    x = links(3)
    y, logJ = tc.link_coupling_forward(tp[0], torch.as_tensor(x), 0, 0, tspec)
    x2, logJr = tc.link_coupling_reverse(tp[0], y, 0, 0, tspec)
    assert wrapped(x2.numpy(), x) < 5e-4
    np.testing.assert_allclose(logJ.numpy(), -logJr.numpy(), atol=5e-4)
    with jax.enable_x64():
        jp = jtree(tree)
        fj = jc.link_coupling_forward(jp[0], jnp.asarray(x), 0, 0, jspec)
        rj = jc.link_coupling_reverse(jp[0], fj.x, 0, 0, jspec)
        fj, rj = [tuple(np.asarray(a) for a in o) for o in (fj, rj)]
    assert wrapped(y.numpy(), fj[0]) < TOL
    assert wrapped(x2.numpy(), rj[0]) < TOL
    close((logJ.numpy(), logJr.numpy()), (fj[1], rj[1]))


def test_logdet_matches_autodiff_jacobian():
    jspec, tree, tspec, tp = both(SPEC_KW, 5)
    x = np.random.default_rng(0).uniform(-3.0, 3.0, (1, 2, 4, 4))

    def f(xx):
        return tc.link_coupling_forward(tp[0], xx[None], 0, 1, tspec).x[0]

    J = torch.autograd.functional.jacobian(f, torch.as_tensor(x[0]))
    sign, ladet = np.linalg.slogdet(J.reshape(32, 32).numpy())
    _, logJ = tc.link_coupling_forward(tp[0], torch.as_tensor(x), 0, 1, tspec)
    assert sign > 0
    np.testing.assert_allclose(float(logJ[0]), ladet, atol=1e-3)
    with jax.enable_x64():
        jp = jtree(tree)
        jJ = jax.jacfwd(lambda xx: jc.link_coupling_forward(
            jp[0], xx[None], 0, 1, jspec).x[0])(jnp.asarray(x[0]))
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=0, atol=TOL)


def test_full_flow_roundtrip():
    jspec, tree, tspec, tp = both(SPEC_KW, 5)
    x = links(4)
    y, logdet = tf.flow_forward(tp, torch.as_tensor(x), tspec)
    x2, logdet_rev = tf.flow_reverse(tp, y.detach(), tspec)
    assert wrapped(x2.numpy(), x) < 1e-3
    np.testing.assert_allclose(logdet.detach().numpy(), -logdet_rev.numpy(),
                               atol=2e-3)
    with jax.enable_x64():
        jp = jtree(tree)
        yj, ldj = jf.flow_forward(jp, jnp.asarray(x), jspec)
        xj, lrj = jf.flow_reverse(jp, yj, jspec)
        yj, ldj, xj, lrj = map(np.asarray, (yj, ldj, xj, lrj))
    assert wrapped(y.detach().numpy(), yj) < TOL
    assert wrapped(x2.numpy(), xj) < TOL
    close((logdet.detach().numpy(), logdet_rev.numpy()), (ldj, lrj))


def test_fthmc_exact_with_spline_flow():
    """<exp(-dH)> = 1 holds for any invertible flow: a short FT-HMC chain
    with a random spline flow at 8^2, beta=1, the JAX test's size and step
    (the autograd force: the kernels refuse spline). Its force is held to
    JAX's ft_force in float64 first."""
    jspec, tree, tspec, tp = both(SPEC_KW, 5)
    z = links(6, B=2)
    f = th.ft_force(tp, tspec, torch.as_tensor(z), 1.0, device="cpu")
    with jax.enable_x64():
        fj = np.asarray(jh.ft_force(jtree(tree), jspec, jnp.asarray(z), 1.0))
    np.testing.assert_allclose(f.numpy(), fj, rtol=0, atol=TOL)

    _, _, tspec, tp32 = both(SPEC_KW, 5, dtype=torch.float32)
    lf = LeapfrogConfig(tau=0.5, nstep=10)
    _, hist = th.run_fthmc(tp32, tspec, lf, beta=1.0, ntraj=40,
                           z0=torch.zeros((16, 2, 8, 8)),
                           generator=torch.Generator().manual_seed(3),
                           device="cpu")
    exp_mdh = hist.exp_mdh[10:].numpy()
    assert abs(exp_mdh.mean() - 1.0) < 5 * exp_mdh.std() / math.sqrt(
        exp_mdh.size) + 0.05
    assert hist.acc[10:].float().mean() > 0.5
    with pytest.raises(ValueError, match="coupling"):
        th.resolve_force_backend("kernel", tspec, (16, 2, 8, 8),
                                 torch.float32, "cpu")
