"""fthmc_tpu_torch lattice physics and K1's plain twin against fthmc_tpu.

Same numpy inputs (numpy.random.default_rng) go through both packages in
float64; deterministic functions agree to 1e-12 (roundoff of a few adds and
one sin/cos per site)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import lattice as jl
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.lattice_kernels import force, force_plain

TOL = 1e-12


def _links(seed, shape=(4, 2, 8, 8)):
    return np.random.default_rng(seed).uniform(-math.pi, math.pi, shape)


def test_wrap_and_mod_2pi_match_including_pi_edges():
    pi = math.pi
    x = np.concatenate([
        np.array([pi, -pi, 3 * pi, -3 * pi, 0.0, -0.0, 2 * pi, -2 * pi,
                  np.nextafter(pi, 0), np.nextafter(-pi, 0), 1e-17, -1e-17]),
        np.random.default_rng(0).uniform(-20, 20, 1000)])
    with jax.enable_x64():
        wj = np.asarray(jl.wrap(jnp.asarray(x)))
        mj = np.asarray(jl.mod_2pi(jnp.asarray(x)))
    wt = tl.wrap(torch.as_tensor(x)).numpy()
    mt = tl.mod_2pi(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(mt, mj)
    # floor-mod: +-pi both land on -pi, the range is [-pi, pi)
    assert wt[0] == wt[1] == -pi
    assert np.all((wt >= -pi) & (wt < pi))


def test_single_config_functions_match():
    x = _links(1)[0]
    with jax.enable_x64():
        xj = jnp.asarray(x)
        ref = {"plaq": jl.plaq_phase(xj), "action": jl.action(xj, 2.5),
               "mean": jl.plaq_mean(xj), "q": jl.topo_charge(xj),
               "force": jl.force(xj, 2.5)}
        ref = {k: np.asarray(v) for k, v in ref.items()}
    xt = torch.as_tensor(x)
    got = {"plaq": tl.plaq_phase(xt), "action": tl.action(xt, 2.5),
           "mean": tl.plaq_mean(xt), "q": tl.topo_charge(xt),
           "force": tl.force(xt, 2.5)}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_batched_functions_and_delta_action_match():
    x0, x1 = _links(2), _links(3)
    with jax.enable_x64():
        a, b = jnp.asarray(x0), jnp.asarray(x1)
        ref = {"plaqs": jl.batch_plaqs(a), "action": jl.batch_action(a, 6.0),
               "q": jl.batch_charges(a), "mean": jl.batch_plaq_mean(a),
               "force": jl.batch_force(a, 6.0),
               "dS": jax.vmap(lambda u, v: jl.delta_action(u, v, 6.0))(b, a)}
        ref = {k: np.asarray(v) for k, v in ref.items()}
    a, b = torch.as_tensor(x0), torch.as_tensor(x1)
    got = {"plaqs": tl.batch_plaqs(a), "action": tl.batch_action(a, 6.0),
           "q": tl.batch_charges(a), "mean": tl.batch_plaq_mean(a),
           "force": tl.batch_force(a, 6.0),
           "dS": tl.delta_action(b, a, 6.0)}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("L,beta", [(8, 2.0), (12, 6.0)])
def test_k1_plain_twin_matches_jax_force(L, beta):
    x = _links(4, (3, 2, L, L))
    with jax.enable_x64():
        ref = np.asarray(jl.batch_force(jnp.asarray(x), beta))
    before = _build.PLAIN_CALLS["K1"]
    got = force(torch.as_tensor(x), beta)          # CPU -> plain twin
    assert _build.PLAIN_CALLS["K1"] == before + 1
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(force_plain(torch.as_tensor(x), beta).numpy(),
                               ref, rtol=0, atol=TOL)


def test_force_is_gradient_of_action():
    x = torch.as_tensor(_links(5)).requires_grad_(True)
    (g,) = torch.autograd.grad(tl.batch_action(x, 3.0).sum(), x)
    np.testing.assert_allclose(tl.batch_force(x.detach(), 3.0).numpy(),
                               g.numpy(), rtol=0, atol=TOL)


def test_force_wrapper_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError):
        force(torch.empty((2, 2, 8, 8), device="meta"), 1.0)
    with pytest.raises(ValueError):
        force(torch.zeros((2, 3, 8, 8)), 1.0)


def test_starts_and_plaq_table():
    assert tl.PLAQ_EXACT == jl.PLAQ_EXACT
    g = torch.Generator().manual_seed(0)
    x = tl.hot_start(g, 5, 8, device="cpu")
    assert x.shape == (5, 2, 8, 8) and x.dtype == torch.float32
    assert float(x.min()) >= -math.pi and float(x.max()) < math.pi
    c = tl.cold_start(8, device="cpu")
    assert c.shape == (2, 8, 8) and not c.any()
    assert float(tl.plaq_mean(c)) == 1.0


def test_loops_and_gauge_transforms_match():
    """Wilson and Polyakov loops and the gauge transform, per chain, against
    the JAX package's single-config functions (vmapped), same alpha."""
    x = _links(6)
    alpha = np.random.default_rng(7).uniform(0, 2 * math.pi, (4, 8, 8))
    with jax.enable_x64():
        xj, aj = jnp.asarray(x), jnp.asarray(alpha)
        ref = {"w23": jl.batch_wilson_loops(xj, 2, 3),
               "w23phase": jax.vmap(lambda y: jl.wilson_loop_phase(y, 2, 3))(
                   xj),
               "p0": jl.batch_polyakov_loops(xj),
               "p1": jl.batch_polyakov_loops(xj, mu=1),
               "gauge": jax.vmap(jl.gauge_transform)(xj, aj),
               "density": jax.vmap(jl.action_density)(xj),
               "grad": jax.vmap(lambda y: jl.grad_force(y, 2.7))(xj)}
        ref = {k: np.asarray(v) for k, v in ref.items()}
    xt = torch.as_tensor(x)
    got = {"w23": tl.batch_wilson_loops(xt, 2, 3),
           "w23phase": tl.wilson_loop_phase(xt, 2, 3),
           "p0": tl.batch_polyakov_loops(xt),
           "p1": tl.batch_polyakov_loops(xt, mu=1),
           "gauge": tl.gauge_transform(xt, torch.as_tensor(alpha)),
           "density": tl.action_density(xt),
           "grad": tl.grad_force(xt, 2.7)}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_wilson_loop_1x1_is_plaq_and_grad_force_is_force():
    xt = torch.as_tensor(_links(8))
    np.testing.assert_allclose(tl.batch_wilson_loops(xt, 1, 1).numpy(),
                               tl.batch_plaq_mean(xt).numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tl.grad_force(xt, 2.7).numpy(),
                               tl.force(xt, 2.7).numpy(), rtol=0, atol=TOL)


def test_observables_are_gauge_invariant():
    x = torch.as_tensor(_links(9))
    xg = tl.random_gauge_transform(torch.Generator().manual_seed(11), x)
    assert xg.shape == x.shape and not torch.allclose(xg, x)
    for f in (tl.batch_plaq_mean, tl.batch_charges,
              lambda y: tl.batch_wilson_loops(y, 2, 3),
              tl.batch_polyakov_loops,
              lambda y: tl.batch_polyakov_loops(y, mu=1)):
        np.testing.assert_allclose(f(xg).numpy(), f(x).numpy(), rtol=0,
                                   atol=1e-9)


def test_polyakov_cold_start_is_one():
    p = tl.batch_polyakov_loops(tl.cold_start(8, device="cpu")[None])
    assert p.shape == (1, 2)
    np.testing.assert_allclose(p.numpy(), [[1.0, 0.0]], atol=1e-7)
