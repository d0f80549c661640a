"""fthmc_tpu_torch lattice physics and K1's plain twin against fthmc_tpu,
and a float64 mirror of K1's band indexing (csrc/force.cu) and its plans.

Same numpy inputs (numpy.random.default_rng) go through both packages in
float64; deterministic functions agree to 1e-12 (roundoff of a few adds and
one sin/cos per site). Against the TPU kernel itself (pallas_force in
interpret mode, fp32) K1's twin agrees to 1e-5, tests/test_pallas.py's own
bound for pallas_force: two fp32 sines of one angle may differ in the last
bit, times beta <= 6."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import lattice as jl
from fthmc_tpu.ops.pallas_lattice import pallas_force
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.lattice_kernels import (FORCE_MAX_L, ForcePlan,
                                                 force, force_plain,
                                                 force_plan, force_plan_of,
                                                 force_plans,
                                                 force_smem_bytes_of)

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


@pytest.mark.parametrize("B,L,beta", [(4, 8, 2.0), (3, 20, 6.0),
                                       (64, 16, 6.0)])
def test_k1_plain_twin_matches_pallas_force(B, L, beta):
    """K1's twin against the TPU kernel it replaces, pallas_force, run in
    interpret mode on the same fp32 links."""
    x = _links(10 + L, (B, 2, L, L)).astype(np.float32)
    ref = np.asarray(pallas_force(jnp.asarray(x), beta, block=B,
                                  interpret=True))
    got = force_plain(torch.as_tensor(x), beta)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# K1's band geometry (csrc/force.cu), mirrored in float64: bands of R rows
# of a chain (the last shorter where R does not divide L), a CTA each;
# thread t owns column t % L and the run of S rows from local row (t // L)
# S (rows past the band idle); x0 of the band's rows and sin P of the halo
# row r0 - 1 and of the band's rows in shared buffers that start NaN, so a
# site that reads what was never published shows. x1(i+1) comes from the
# run, or for its last site from a load of the row below; the halo row's
# sin P is recomputed by the first run's threads.
# ---------------------------------------------------------------------------

def band_force(x, beta, plan):
    B, _, L, _ = x.shape
    R, T, S = plan
    nb = -(-L // R)
    t = np.arange(T)
    j, g0 = t % L, (t // L) * S
    jp, jm = (j + 1) % L, (j - 1) % L
    r0 = np.arange(nb) * R
    rows = np.minimum(R, L - r0)
    nv = np.clip(rows[:, None] - g0[None, :], 0, S)                # (nb, T)
    k = np.arange(S)
    valid = k[None, None, :] < nv[:, :, None]                      # (nb,T,S)
    i = r0[:, None, None] + g0[None, :, None] + k[None, None, :]
    site = np.where(valid, i * L + j[None, :, None], 0)
    x0g, x1g = x[:, 0].reshape(B, -1), x[:, 1].reshape(B, -1)
    x0 = np.where(valid, x0g[:, site], 0.0)                        # (B,...)
    x1 = np.where(valid, x1g[:, site], 0.0)
    cell = np.broadcast_to((g0[None, :, None] + k[None, None, :]) * L
                           + j[None, :, None], valid.shape)
    bands = np.broadcast_to(np.arange(nb)[:, None, None], valid.shape)
    xs0 = np.full((B, nb, R * L), np.nan)
    sps = np.full((B, nb, (R + 1) * L), np.nan)
    xs0[:, bands[valid], cell[valid]] = x0[:, valid]
    run = nv > 0
    rb = (r0[:, None] + g0[None, :] + nv) % L                      # (nb, T)
    below = np.where(run, x1g[:, np.where(run, rb * L + j, 0)], 0.0)
    halo = run & (g0[None, :] == 0)
    rh = (r0 - 1) % L
    hs = np.sin(x0g[:, rh[:, None] * L + j] + x1[..., 0]
                - x0g[:, rh[:, None] * L + jp] - x1g[:, rh[:, None] * L + j])
    hb = np.broadcast_to(np.arange(nb)[:, None], halo.shape)
    sps[:, hb[halo], np.broadcast_to(j, halo.shape)[halo]] = hs[:, halo]
    xn = np.where(k[None, None, :] + 1 < nv[:, :, None],
                  np.concatenate([x1[..., 1:], x1[..., -1:]], axis=-1),
                  below[..., None])
    right = xs0[:, bands, np.where(valid, cell - j[None, :, None]
                                   + jp[None, :, None], 0)]
    right = np.where(valid, right, 0.0)
    sp = np.sin(x0 + xn - right - x1)
    sps[:, bands[valid], (cell + L)[valid]] = sp[:, valid]
    left = sps[:, bands, np.where(valid, cell + L - j[None, :, None]
                                  + jm[None, :, None], 0)]
    # sin P(i-1): the run's own previous site, else the smem row above
    # (the run above's last row, or the halo row)
    above = np.where(k[None, None, :] > 0,
                     np.concatenate([sp[..., :1], sp[..., :-1]], axis=-1),
                     sps[:, bands, np.where(valid, cell, 0)])
    out = np.full(x.shape, np.nan)
    f0 = beta * (sp - left)
    f1 = beta * (above - sp)
    for d, f in enumerate((f0, f1)):
        flat = out[:, d].reshape(B, -1)
        flat[:, site[valid]] = f[:, valid]
        out[:, d] = flat.reshape(B, L, L)
    return out


K1_MIRROR_CASES = [(L, plan) for L in (2, 3, 8, 16, 20, 64)
                   for plan in force_plans(L)]


@pytest.mark.parametrize("L,plan", K1_MIRROR_CASES,
                         ids=[f"L{L}-R{p.rows}-S{p.sites}"
                              for L, p in K1_MIRROR_CASES])
def test_k1_mirror_reproduces_the_twin(L, plan):
    """K1's indexing (bands, runs, the halo row), in float64, against its
    twin (float64) to 1e-12, under every plan of L."""
    x = _links(L * 100 + plan.rows * 10 + plan.sites, (3, 2, L, L))
    ref = force_plain(torch.as_tensor(x), 2.5).numpy()
    np.testing.assert_allclose(band_force(x, 2.5, plan), ref, rtol=0,
                               atol=1e-12)


H100_SMEM = 232448       # bytes a block may opt in to


def test_force_plan_covers_every_L_within_the_h100s_limits():
    """Every L from 2 to FORCE_MAX_L has a K1 plan within an H100's shared
    memory and threads, its bands covering every row, and so does every
    plan of the sweep; the cells' plans are the fastest or within 5% of it
    on an H100 (PERF.md section 6)."""
    for L in range(2, FORCE_MAX_L + 1):
        plan = force_plan(L)
        assert plan == force_plan_of(L, plan.rows, plan.sites)
        assert plan.threads % L == 0 and plan.threads <= 1024
        assert plan.threads // L * plan.sites >= plan.rows
        assert force_smem_bytes_of(L, plan) <= H100_SMEM
    for L in (2, 3, 8, 16, 20, 64, 256, 1024):
        for plan in force_plans(L):
            assert force_smem_bytes_of(L, plan) <= H100_SMEM
            assert plan.threads <= 1024
    assert force_plan(16) == ForcePlan(16, 128, 2)     # FT, path B
    assert force_plan(64) == ForcePlan(8, 256, 2)      # path A, headline


@pytest.mark.parametrize("L", [1, FORCE_MAX_L + 1, 4096])
def test_force_plan_raises_above_the_envelope(L):
    with pytest.raises(ValueError, match=f"L <= {FORCE_MAX_L}"):
        force_plan(L)


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
