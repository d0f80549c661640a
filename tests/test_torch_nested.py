"""The multi-timescale and Hasenbusch samplers of fthmc_tpu_torch.schwinger
against fthmc_tpu.schwinger, and mirrors of their tests in
tests/test_schwinger.py.

The integrators run on deterministic fp64 forces (the gauge force and a
smooth stand-in for the fermion force that counts its calls in its
auxiliary state) and must reproduce JAX's to 1e-10. The steps run one
trajectory on the draws JAX's key gives, in fp32 as the JAX fermion code
is, with the tolerances of test_torch_schwinger.py: dH within 1e-3, the new
links within 1e-4 wrapped, the accept equal except where u lies within
1e-3 of exp(-dH). The split FT forces sum to the single-scale force to
1e-5 (relative in norm)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import fermion as jf
from fthmc_tpu import lattice as jl
from fthmc_tpu import schwinger as js
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch import schwinger as ts
from fthmc_tpu_torch.config import FlowSpec as TSpec
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (flow_vjp_kernel,
                                                      ft_force_kernel)
from fthmc_tpu_torch.weights import flow_params_from_numpy

B, L = 4, 8
DH_TOL = 1e-3


def _links(seed, b=B, l=L, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, 2, l, l))
            * scale).astype(np.float32)


def _wrapped(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.abs(np.remainder(d + math.pi, 2 * math.pi)
                        - math.pi).max())


def _chi(key, shape):
    kr, ki = jax.random.split(key)
    return ((jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
            * math.sqrt(0.5)).astype(jnp.complex64)


def _jax_draws(key, x, n_chi=1):
    """The draws of JAX's hmc_step_dyn / fthmc_step_dyn (one chi) and
    hb_step_dyn (chi1, chi2 from four keys of kp) from its key
    (schwinger.py:291-293,359-361; fermion.py:330-333,525-531)."""
    kv, kp, ka = jax.random.split(key, 3)
    v0 = jax.random.normal(kv, x.shape, x.dtype)
    shape = (x.shape[0],) + tuple(x.shape[2:]) + (2,)
    if n_chi == 1:
        chis = (_chi(kp, shape),)
    else:
        k1r, k1i, k2r, k2i = jax.random.split(kp, 4)
        chis = tuple(
            ((jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
             * math.sqrt(0.5)).astype(jnp.complex64)
            for kr, ki in ((k1r, k1i), (k2r, k2i)))
    u = jax.random.uniform(ka, (x.shape[0],), x.dtype)
    return tuple(torch.as_tensor(np.array(a)) for a in (v0, *chis, u))


def _same_step(got, want, u):
    """(x', metrics) of the port against JAX's on the same draws."""
    (x_t, m_t), (x_j, m_j) = got, want
    dh_j = np.asarray(m_j.dh)
    assert np.abs(m_t.dh.numpy() - dh_j).max() < DH_TOL
    same = m_t.acc.numpy() == np.asarray(m_j.acc)
    border = np.abs(u.numpy() - np.exp(-dh_j)) <= DH_TOL * np.exp(-dh_j)
    assert np.all(same | border)
    assert _wrapped(x_t.numpy()[same], np.asarray(x_j)[same]) < 1e-4


# ------------------------------------------------------------ integrators

def _forces(beta=1.3):
    """(JAX, torch) pairs of a gauge force and a fermion-like force with an
    auxiliary state: f(x, a) = 0.3 sin(2 x + 0.1 a) + 0.05 x, a + 1."""
    def jg(x):
        return jax.vmap(lambda c: jl.force(c, beta))(x)

    def jf_(x, a):
        return 0.3 * jnp.sin(2 * x + 0.1 * a) + 0.05 * x, a + 1

    def tg(x):
        return tl.batch_force(x, beta)

    def tf_(x, a):
        return 0.3 * torch.sin(2 * x + 0.1 * a) + 0.05 * x, a + 1

    return (jg, jf_), (tg, tf_)


def _f64(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, 2, 6, 6)), rng.normal(size=(3, 2, 6, 6))


@pytest.mark.parametrize("n_in", [1, 2, 3, 5])
def test_nested_integrators_match_jax(n_in):
    """gauge_drift, nested_leapfrog_aux and nested_omelyan_aux (its segment
    rounding at n_in = 1, 2, 3, 5) on the same fp64 forces: 1e-10."""
    x, v = _f64(n_in)
    (jg, jff), (tg, tff) = _forces()
    with jax.enable_x64():
        jx, jv = jnp.asarray(x), jnp.asarray(v)
        want = [js.gauge_drift(jx, jv, 0.37, n_in, jg),
                js.nested_leapfrog_aux(jx, jv, 0.11, 3, n_in, jff, jg,
                                       jnp.float64(0.0)),
                js.nested_omelyan_aux(jx, jv, 0.11, 3, n_in, jff, jg,
                                      jnp.float64(0.0))]
        want = [[np.asarray(t) for t in w] for w in want]
    tx, tv = torch.as_tensor(x), torch.as_tensor(v)
    zero = torch.zeros((), dtype=torch.float64)
    got = [ts.gauge_drift(tx, tv, 0.37, n_in, tg),
           ts.nested_leapfrog_aux(tx, tv, 0.11, 3, n_in, tff, tg, zero),
           ts.nested_omelyan_aux(tx, tv, 0.11, 3, n_in, tff, tg, zero)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-10)


def test_nested_omelyan_3level_matches_jax():
    """The three-timescale integrator on fp64 forces (two auxiliary slots,
    each force its own): 1e-10, both slots' call counts equal."""
    x, v = _f64(7)
    (jg, jff), (tg, tff) = _forces()

    def j_outer(xx, aux):
        f, a = jff(xx, aux[0])
        return f, (a, aux[1])

    def j_mid(xx, aux):
        f, a = jff(0.5 * xx, aux[1])
        return f, (aux[0], a)

    def t_outer(xx, aux):
        f, a = tff(xx, aux[0])
        return f, (a, aux[1])

    def t_mid(xx, aux):
        f, a = tff(0.5 * xx, aux[1])
        return f, (aux[0], a)

    with jax.enable_x64():
        z = (jnp.float64(0.0), jnp.float64(0.0))
        wx, wv, wa = js.nested_omelyan_3level(
            jnp.asarray(x), jnp.asarray(v), 0.2, 2, 2, 3, j_outer, j_mid, jg,
            z)
        wx, wv, wa = np.asarray(wx), np.asarray(wv), [float(a) for a in wa]
    z = (torch.zeros((), dtype=torch.float64),) * 2
    gx, gv, ga = ts.nested_omelyan_3level(
        torch.as_tensor(x), torch.as_tensor(v), 0.2, 2, 2, 3, t_outer, t_mid,
        tg, z)
    np.testing.assert_allclose(gx.numpy(), wx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=1e-10)
    assert [float(a) for a in ga] == wa == [4.0, 24.0]


@pytest.mark.parametrize("kw,want", [
    (dict(nstep=8, n_inner=2), {"gauge": 64, "fermion": 16}),
    (dict(nstep=8, n_inner=3), {"gauge": 96, "fermion": 16}),
    (dict(nstep=4, n_inner=4, integrator="leapfrog"),
     {"gauge": 32, "fermion": 5}),
    (dict(nstep=12), {"dyn": 24}),
    (dict(nstep=4, n_mid=2, n_inner=2, hasenbusch_dm=0.2),
     {"gauge": 288, "heavy": 48, "ratio": 8})])
def test_force_evaluations_are_the_integrators(kw, want):
    """The force counts a trajectory makes (what the card suite's launch
    counts rest on): path D's 8 outer steps of n_inner 2 (n_edge 1, n_mid
    2), path F's n_inner 3 (1, 4), nested leapfrog, single scale, and path
    E's Hasenbusch schedule (8 light and 48 heavy forces)."""
    assert ts.force_evaluations(ts.SchwingerConfig(**kw)) == want


# ------------------------------------------------------------------ steps

@pytest.mark.parametrize("integrator,n_inner,dm", [
    pytest.param("leapfrog", 2, 0.0, id="leapfrog"),
    pytest.param("omelyan", 2, 0.0, id="omelyan"),
    pytest.param("omelyan", 0, 0.2, id="omelyan-single-hasenbusch_dm"),
    pytest.param("omelyan", 2, 0.2, id="omelyan-nested-hasenbusch_dm")])
def test_nested_hmc_step_dyn_matches_jax_on_its_draws(integrator, n_inner,
                                                      dm):
    """hmc_step_dyn, single scale or nested, on JAX's draws. As in the JAX
    package the step does not read hasenbusch_dm (only run_hmc_dyn picks
    the Hasenbusch step), so dm > 0 runs the same step."""
    kw = dict(L=L, beta=2.0, mass=0.3, tau=0.4, nstep=3, n_inner=n_inner,
              n_chains=B, integrator=integrator, hasenbusch_dm=dm,
              cg_tol_force=1e-10, cg_tol_mh=1e-12, cg_maxiter=400)
    x = _links(1)
    key = jax.random.PRNGKey(3)
    xj, _, mj = js.hmc_step_dyn(key, jnp.asarray(x),
                                jl.batch_charges(jnp.asarray(x)),
                                js.SchwingerConfig(**kw))
    draws = _jax_draws(key, jnp.asarray(x))
    xt = torch.as_tensor(x)
    x_new, q_new, m = ts._hmc_step_dyn(xt, tl.topo_charge(xt),
                                       ts.SchwingerConfig(**kw), draws)
    _same_step((x_new, m), (xj, mj), draws[-1])
    assert 0 < float(np.asarray(mj.acc).sum())
    assert torch.equal(q_new, m.q)


@pytest.mark.parametrize("eo", [True, False])
def test_hb_step_dyn_matches_jax_on_its_draws(eo):
    kw = dict(L=L, beta=2.0, mass=0.3, hasenbusch_dm=0.4, tau=0.3, nstep=2,
              n_mid=1, n_inner=1, n_chains=B, eo_precond=eo,
              cg_tol_force=1e-10, cg_tol_mh=1e-12, cg_maxiter=400)
    x = _links(2)
    key = jax.random.PRNGKey(5)
    xj, _, mj = js.hb_step_dyn(key, jnp.asarray(x),
                               jl.batch_charges(jnp.asarray(x)),
                               js.SchwingerConfig(**kw))
    draws = _jax_draws(key, jnp.asarray(x), 2)
    xt = torch.as_tensor(x)
    log = tf.CGLog()
    x_new, _, m = ts._hb_step_dyn(xt, tl.topo_charge(xt),
                                  ts.SchwingerConfig(**kw), draws, log)
    _same_step((x_new, m), (xj, mj), draws[-1])
    assert 0 < float(np.asarray(mj.acc).sum())
    want = ts.force_evaluations(ts.SchwingerConfig(**kw))
    assert {k: len(v) for k, v in log.solves.items()} == {
        "force": 0, "mh": 2, "refresh": 1, "heavy": want["heavy"],
        "ratio": want["ratio"]}


def _np_flow(kw, seed, identity=False):
    rng = np.random.default_rng(seed)
    M = kw["n_mixture"]
    sizes = (2, *kw["hidden_sizes"], 2 * M + 1)
    tree = []
    for _ in range(kw["n_layers"]):
        net = [{"w": rng.uniform(-1, 1, (co, ci, 3, 3)) / math.sqrt(9 * ci),
                "b": rng.uniform(-0.1, 0.1, (co,))}
               for ci, co in zip(sizes[:-1], sizes[1:])]
        if identity:
            net[-1] = {k: np.zeros_like(v) for k, v in net[-1].items()}
        tree.append(net)
    return tree


FLOW = dict(n_layers=2, coupling="rncp", n_mixture=2, hidden_sizes=(8, 8))


def _flows(seed=1, identity=False):
    tree = _np_flow(FLOW, seed, identity)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tspec = TSpec(**FLOW)
    return JSpec(**FLOW), jp, tspec, flow_params_from_numpy(
        tree, tspec, device="cpu", dtype=torch.float32)


def test_nested_fthmc_step_dyn_matches_jax_on_its_draws():
    jspec, jp, tspec, tp = _flows(seed=2)
    kw = dict(L=L, beta=2.0, mass=0.3, tau=0.3, nstep=2, n_inner=2,
              n_chains=B, cg_tol_force=1e-10, cg_tol_mh=1e-12,
              cg_maxiter=400)
    z = _links(6)
    key = jax.random.PRNGKey(7)
    zj, yj, _, mj = js.fthmc_step_dyn(jp, jspec, key, jnp.asarray(z),
                                      jnp.zeros(B), js.SchwingerConfig(**kw))
    draws = _jax_draws(key, jnp.asarray(z))
    cfg = ts.SchwingerConfig(**kw)
    zt, remat, backend, flow = ts._ft_setup(tp, tspec, cfg, torch.as_tensor(z),
                                            False, "kernel",
                                            torch.device("cpu"))
    z_new, y_new, _, m = ts._fthmc_step_dyn(tp, tspec, zt, torch.zeros(B),
                                            cfg, draws, remat, backend, flow)
    _same_step((z_new, m), (zj, mj), draws[-1])
    same = m.acc.numpy() == np.asarray(mj.acc)
    assert _wrapped(y_new.numpy()[same], np.asarray(yj)[same]) < 1e-4


@pytest.mark.parametrize("backend", ["kernel", "autograd"])
def test_ft_force_split_matches_jax_and_sums_to_total(backend):
    """ft_gauge_force and ft_fermion_force against JAX's (1e-4 relative in
    norm, fp32 through the flow and a CG at 1e-12), and their sum the
    single-scale ft_dyn_force (1e-5: the same solve, the log-det moved
    between the two)."""
    jspec, jp, tspec, tp = _flows()
    kw = dict(L=L, beta=1.5, mass=0.4, cg_tol_force=1e-12, cg_maxiter=400)
    z = _links(4, scale=1.0)
    from fthmc_tpu.models.flow import flow_forward as jflow
    y, _ = jflow(jp, jnp.asarray(z), jspec)
    phi, _ = jf.pf_refresh(jax.random.PRNGKey(5), y, 0.4, eo=True)
    jcfg, tcfg = js.SchwingerConfig(**kw), ts.SchwingerConfig(**kw)
    zero = jnp.zeros_like(phi)
    wg = np.asarray(js.ft_gauge_force(jp, jspec, jnp.asarray(z), 1.5, False))
    wf = np.asarray(js.ft_fermion_force(jp, jspec, jnp.asarray(z), jcfg, phi,
                                        zero, False)[0])
    tz, tphi = torch.as_tensor(z), torch.as_tensor(np.array(phi))
    guess = torch.zeros(tuple(phi.shape), dtype=torch.complex64)
    gg = ts.ft_gauge_force(tp, tspec, tz, 1.5, False, backend)
    gf, _ = ts.ft_fermion_force(tp, tspec, tz, tcfg, tphi, guess, False,
                                backend)
    total, _ = ts.ft_dyn_force(tp, tspec, tz, tcfg, tphi, guess, False,
                               backend)

    def rel(a, b):
        return float(np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b))

    assert rel(gg, wg) < 1e-4 and rel(gf, wf) < 1e-4
    assert rel(gg + gf, total.numpy()) < 1e-5


@pytest.mark.parametrize("gl", [-1.0, 0.0, 0.7])
def test_flow_vjp_kernel_logdet_cotangent(gl):
    """flow_vjp_kernel's log-det cotangent on the CPU route (the twins):
    -1, the default, is ft_force_kernel bit for bit; any gl is autograd of
    S(f(z)) + gl log|det| within 1e-5 relative in norm."""
    _, _, tspec, tp = _flows(seed=3)
    z = torch.as_tensor(_links(8, scale=1.0))
    beta = 1.7
    if gl == -1.0:
        assert torch.equal(
            flow_vjp_kernel(tp, tspec, z, lambda y: tl.batch_force(y, beta),
                            logdet_cotangent=gl),
            ft_force_kernel(tp, tspec, z, beta))
    got = flow_vjp_kernel(tp, tspec, z, lambda y: tl.batch_force(y, beta),
                          logdet_cotangent=gl)
    from fthmc_tpu_torch.models.flow import flow_forward
    zz = z.clone().requires_grad_(True)
    y, logj = flow_forward(tp, zz, tspec)
    (want,) = torch.autograd.grad(
        (tl.batch_action(y, beta) + gl * logj).sum(), zz)
    assert float((got - want).norm() / want.norm()) < 1e-5


# -------------------------------------------------- mirrors of test_schwinger

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_mts_exp_mdh_near_one():
    cfg = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.5, nstep=5,
                             n_inner=5, n_chains=4, ntraj=2,
                             cg_tol_force=1e-12, cg_tol_mh=1e-12,
                             cg_maxiter=400)
    _, hist = ts.run_hmc_dyn(cfg, generator=_gen(21), device="cpu")
    assert bool((hist.dh.abs() < 0.05).all()), hist.dh


def test_mts_reversibility():
    """Nested leapfrog forward, momentum flipped, back with cold solves:
    the start again within fp32's 5e-4 (the JAX test's bound)."""
    cfg = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.5, nstep=5,
                             n_inner=4, n_chains=2, warm_start=False,
                             cg_tol_force=1e-12, cg_maxiter=400)
    x = tl.hot_start(_gen(5), 2, 4, device="cpu")
    v = torch.randn(x.shape, generator=_gen(6))
    phi, _ = tf.pf_refresh(_gen(7), x, cfg.mass)

    def ff(xx, aux):
        res = tf.cg_solve(xx, phi, cfg.mass, torch.zeros_like(phi),
                          tol=cfg.cg_tol_force, maxiter=cfg.cg_maxiter)
        return tf.pf_force_at(xx, phi, res.x, cfg.mass), res.x

    def fg(xx):
        return tl.batch_force(xx, cfg.beta)

    zero = torch.zeros_like(phi)
    x1, v1, _ = ts.nested_leapfrog_aux(x, v, cfg.dt, cfg.nstep, cfg.n_inner,
                                       ff, fg, zero)
    x2, v2, _ = ts.nested_leapfrog_aux(x1, -v1, cfg.dt, cfg.nstep,
                                       cfg.n_inner, ff, fg, zero)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=5e-4)
    np.testing.assert_allclose(-v2.numpy(), v.numpy(), atol=5e-4)


def test_ft_mts_exp_mdh_near_one():
    _, _, tspec, tp = _flows(seed=1)
    cfg = ts.SchwingerConfig(L=4, beta=1.5, mass=0.4, tau=0.2, nstep=5,
                             n_inner=4, n_chains=2, ntraj=2,
                             cg_tol_force=1e-12, cg_tol_mh=1e-12,
                             cg_maxiter=400)
    z, hist = ts.run_fthmc_dyn(tp, tspec, cfg, generator=_gen(2),
                               device="cpu")
    assert z.shape == (2, 2, 4, 4)
    assert bool((hist.dh.abs() < 0.08).all()), hist.dh


def test_hasenbusch_exp_mdh_near_one():
    cfg = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, hasenbusch_dm=0.5,
                             tau=0.4, nstep=4, n_mid=2, n_inner=2,
                             n_chains=4, ntraj=2, cg_tol_force=1e-12,
                             cg_tol_mh=1e-12, cg_maxiter=400)
    _, hist = ts.run_hmc_dyn(cfg, generator=_gen(31), device="cpu")
    assert bool((hist.dh.abs() < 0.05).all()), hist.dh


def test_hasenbusch_start_action_is_chi_sq():
    """S1 + S2 at the heatbath point is |chi1|^2 + |chi2|^2, checked by
    solving again (2e-4 relative, the JAX test's)."""
    x = tl.hot_start(_gen(41), 2, 4, device="cpu")
    m, m1 = 0.3, 0.8
    phi1, phi2, s0, _ = tf.hasenbusch_refresh(_gen(42), x, m, m1, tol=1e-14,
                                              maxiter=600, eo=True)
    s1, _ = tf.pf_action_exact(x, phi1, m1, tol=1e-14, maxiter=600, eo=True)
    s2, _ = tf.ratio_action_exact(x, phi2, m, m1, tol=1e-14, maxiter=600,
                                  eo=True)
    np.testing.assert_allclose((s1 + s2).numpy(), s0.numpy(), rtol=2e-4)


@pytest.fixture
def cg_backend():
    """Set fermion's process-wide CG backend for one test."""
    def use(name):
        tf.set_cg_backend(name)
    yield use
    tf.set_cg_backend("auto")


def test_mixed_cg_backend_full_step_exact(cg_backend):
    """A run on the mixed CG reproduces the 'xla' run from the same
    generator: dH within 5e-4 and the links within 1e-3 (the refinement
    restores fp32 solves), |dH| < 0.05."""
    cfg = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.25, nstep=10,
                             n_chains=4, ntraj=2, cg_tol_force=1e-10,
                             cg_tol_mh=1e-12, cg_maxiter=400)
    cg_backend("mixed")
    log = tf.CGLog()
    x_m, h_m = ts.run_hmc_dyn(cfg, generator=_gen(5), device="cpu",
                              cg_log=log)
    cg_backend("xla")
    x_r, h_r = ts.run_hmc_dyn(cfg, generator=_gen(5), device="cpu")
    np.testing.assert_allclose(h_m.dh.numpy(), h_r.dh.numpy(), atol=5e-4)
    np.testing.assert_allclose(x_m.numpy(), x_r.numpy(), atol=1e-3)
    assert bool((h_m.dh.abs() < 0.05).all())
    # every mixed solve reads the host once a refinement cycle and once more
    assert 2 * log.count() <= log.reads() <= 8 * log.count()


def test_nested_runs_on_the_cpu_count_only_twins(cg_backend):
    """Nested FT-HMC on the CPU with the kernel chain: the twins' calls are
    force_evaluations' counts (K7/K8 a layer each a force of either scale,
    K1 a gauge force only, K11's twin a fermion force), no kernel
    launched."""
    _, _, tspec, tp = _flows(identity=True)
    cfg = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.3, nstep=2,
                             n_inner=3, n_chains=2, ntraj=1,
                             cg_tol_force=1e-10, cg_tol_mh=1e-12,
                             cg_maxiter=400)
    cg_backend("fused")
    n = ts.force_evaluations(cfg)
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    log = tf.CGLog()
    ts.run_fthmc_dyn(tp, tspec, cfg, generator=_gen(1),
                     force_backend="kernel", device="cpu", cg_log=log)
    plain = {k: _build.PLAIN_CALLS[k] - before[0][k] for k in before[0]}
    assert dict(_build.LAUNCHES) == before[1]
    assert plain["K7"] == plain["K8"] == 2 * (n["gauge"] + n["fermion"])
    assert plain["K1"] == n["gauge"]
    assert len(log.solves["force"]) == n["fermion"]


def test_unported_options_are_gone_and_ft_hasenbusch_still_refused():
    """n_inner > 0, Hasenbusch with n_mid and the 'mixed' CG run (none
    raises naming an unported item); FT-HMC keeps JAX's refusal of
    hasenbusch_dm."""
    _, _, tspec, tp = _flows(identity=True)
    cfg = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.2, nstep=1,
                             n_inner=1, n_chains=2, ntraj=1,
                             cg_tol_force=1e-8, cg_tol_mh=1e-10,
                             cg_maxiter=200)
    x = tl.hot_start(_gen(2), 2, 4, device="cpu")
    q = tl.topo_charge(x)
    ts.hmc_step_dyn(_gen(0), x, q, cfg, device="cpu")
    ts.hb_step_dyn(_gen(0), x, q, dataclasses.replace(
        cfg, hasenbusch_dm=0.5, n_mid=2), device="cpu")
    phi, _ = tf.pf_refresh(_gen(3), x, 0.3, eo=True)
    tf.cg_solve(x, phi, 0.3, tol=1e-8, eo=True, backend="mixed")
    with pytest.raises(ValueError, match="hasenbusch_dm"):
        ts.fthmc_step_dyn(tp, tspec, _gen(0), x, q, dataclasses.replace(
            cfg, hasenbusch_dm=0.5), device="cpu")
