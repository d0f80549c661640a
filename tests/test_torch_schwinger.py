"""Dynamical-fermion HMC and FT-HMC (fthmc_tpu_torch.schwinger) against
fthmc_tpu.schwinger, and mirrors of tests/test_schwinger.py.

All in fp32, as the JAX fermion code is. One trajectory on JAX's own draws
(its key splits): dH within 1e-3 (its terms are sums of ~10^3 fp32 values
up to ~10^2 each, S_pf being about 2V, summed in another order: measured
9e-5); the new links within 1e-4 wrapped (a few hundred fp32 operations a
link, and CG solutions that agree to the solve's 1e-6 relative residual);
the accept equal except where u lies within 1e-3 of exp(-dH). The FT force
1e-4 relative in norm (fp32 through a 2-layer flow and a CG at 1e-12)."""
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
from fthmc_tpu_torch.ops import fermion_kernels as fk
from fthmc_tpu_torch.weights import flow_params_from_numpy

B, L = 4, 8
DH_TOL = 1e-3


def _links(seed, b=B, l=L, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, 2, l, l))
            * scale).astype(np.float32)


def _jax_draws(key, x):
    """The draws of JAX's hmc_step_dyn / fthmc_step_dyn from its key
    (schwinger.py:359-361, fermion.py:330-333)."""
    kv, kp, ka = jax.random.split(key, 3)
    v0 = jax.random.normal(kv, x.shape, x.dtype)
    kr, ki = jax.random.split(kp)
    shape = (x.shape[0],) + tuple(x.shape[2:]) + (2,)
    chi = ((jax.random.normal(kr, shape) + 1j * jax.random.normal(ki, shape))
           * math.sqrt(0.5)).astype(jnp.complex64)
    u = jax.random.uniform(ka, (x.shape[0],), x.dtype)
    return tuple(torch.as_tensor(np.array(a)) for a in (v0, chi, u))


def _wrapped(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.abs(np.remainder(d + math.pi, 2 * math.pi)
                        - math.pi).max())


def _same_step(got, want, u):
    """(x', metrics) of the port against JAX's on the same draws."""
    (x_t, m_t), (x_j, m_j) = got, want
    dh_j = np.asarray(m_j.dh)
    assert np.abs(m_t.dh.numpy() - dh_j).max() < DH_TOL
    same = m_t.acc.numpy() == np.asarray(m_j.acc)
    border = np.abs(u.numpy() - np.exp(-dh_j)) <= DH_TOL * np.exp(-dh_j)
    assert np.all(same | border)
    assert _wrapped(x_t.numpy()[same], np.asarray(x_j)[same]) < 1e-4


@pytest.mark.parametrize("integrator", ["leapfrog", "omelyan"])
@pytest.mark.parametrize("eo", [False, True])
def test_hmc_step_dyn_matches_jax_on_its_draws(integrator, eo):
    kw = dict(L=L, beta=2.0, mass=0.3, tau=0.4, nstep=4, n_chains=B,
              integrator=integrator, eo_precond=eo, cg_tol_force=1e-10,
              cg_tol_mh=1e-12, cg_maxiter=400)
    x = _links(1)
    key = jax.random.PRNGKey(3)
    xj, _, mj = js.hmc_step_dyn(key, jnp.asarray(x),
                                jl.batch_charges(jnp.asarray(x)),
                                js.SchwingerConfig(**kw))
    draws = _jax_draws(key, jnp.asarray(x))
    xt = torch.as_tensor(x)
    x_new, q_new, m = ts._hmc_step_dyn(xt, tl.topo_charge(xt),
                                       ts.SchwingerConfig(**kw), draws)
    _same_step((x_new, m), (xj, mj), draws[2])
    assert 0 < float(np.asarray(mj.acc).sum())
    np.testing.assert_allclose(m.plaq.numpy(), np.asarray(mj.plaq),
                               atol=1e-5)
    assert torch.equal(q_new, m.q)


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


def _flows(kw=FLOW, seed=1, identity=False):
    tree = _np_flow(kw, seed, identity)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tspec = TSpec(**kw)
    return JSpec(**kw), jp, tspec, flow_params_from_numpy(
        tree, tspec, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("backend", ["kernel", "autograd"])
def test_ft_dyn_force_matches_jax(backend):
    """The latent force of the dynamical theory at the same phi and guess:
    the kernel chain's twins (K7, K1 + fermion force, K8) and autograd
    against JAX's one VJP."""
    jspec, jp, tspec, tp = _flows()
    kw = dict(L=L, beta=1.5, mass=0.4, cg_tol_force=1e-12, cg_maxiter=400)
    z = _links(4, scale=1.0)
    from fthmc_tpu.models.flow import flow_forward as jflow
    y, _ = jflow(jp, jnp.asarray(z), jspec)
    phi, _ = jf.pf_refresh(jax.random.PRNGKey(5), y, 0.4, eo=True)
    want, xj = js.ft_dyn_force(jp, jspec, jnp.asarray(z),
                               js.SchwingerConfig(**kw), phi,
                               jnp.zeros_like(phi), False)
    got, res = ts.ft_dyn_force(tp, tspec, torch.as_tensor(z),
                               ts.SchwingerConfig(**kw),
                               torch.as_tensor(np.array(phi)),
                               torch.zeros(tuple(phi.shape),
                                           dtype=torch.complex64),
                               False, backend)
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel
    x_rel = (np.linalg.norm(res.x.numpy() - np.asarray(xj))
             / np.linalg.norm(np.asarray(xj)))
    assert x_rel < 1e-4


@pytest.mark.parametrize("eo", [False, True])
def test_fthmc_step_dyn_matches_jax_on_its_draws(eo):
    jspec, jp, tspec, tp = _flows(seed=2)
    kw = dict(L=L, beta=2.0, mass=0.3, tau=0.3, nstep=3, n_chains=B,
              eo_precond=eo, cg_tol_force=1e-10, cg_tol_mh=1e-12,
              cg_maxiter=400)
    z = _links(6)
    key = jax.random.PRNGKey(7)
    zj, yj, _, mj = js.fthmc_step_dyn(jp, jspec, key, jnp.asarray(z),
                                      jnp.zeros(B), js.SchwingerConfig(**kw))
    draws = _jax_draws(key, jnp.asarray(z))
    zt = torch.as_tensor(z)
    cfg = ts.SchwingerConfig(**kw)
    z, remat, backend, flow = ts._ft_setup(tp, tspec, cfg, zt, False,
                                           "kernel", torch.device("cpu"))
    z_new, y_new, _, m = ts._fthmc_step_dyn(tp, tspec, z, torch.zeros(B),
                                            cfg, draws, remat, backend, flow)
    _same_step((z_new, m), (zj, mj), draws[2])
    same = m.acc.numpy() == np.asarray(mj.acc)
    assert _wrapped(y_new.numpy()[same], np.asarray(yj)[same]) < 1e-4


# ------------------------------------------- mirrors of tests/test_schwinger

CFG = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.5, nstep=10,
                         n_chains=4, ntraj=4, cg_tol_force=1e-10,
                         cg_tol_mh=1e-12, cg_maxiter=400)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def cg_backend():
    """Set fermion's process-wide CG backend for one test."""
    def use(name):
        tf.set_cg_backend(name)
    yield use
    tf.set_cg_backend("auto")


def test_exp_mdh_near_one_small_dt():
    cfg = dataclasses.replace(CFG, tau=0.25, nstep=25, ntraj=2,
                              cg_tol_force=1e-12)
    _, hist = ts.run_hmc_dyn(cfg, generator=_gen(0), device="cpu")
    assert bool((hist.dh.abs() < 0.05).all()), hist.dh


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_dh_scales_as_dt_squared(backend, cg_backend):
    """Halving dt at fixed tau cuts |dH| ~4x (> 2.5x), with either CG."""
    x0 = tl.hot_start(_gen(3), 4, 4, device="cpu")
    cg_backend(backend)

    def max_dh(nstep):
        cfg = dataclasses.replace(CFG, nstep=nstep, ntraj=1,
                                  integrator="leapfrog", cg_tol_force=1e-12)
        _, hist = ts.run_hmc_dyn(cfg, x0=x0, generator=_gen(1),
                                 device="cpu")
        return float(hist.dh.abs().max())

    a, b = max_dh(8), max_dh(16)
    assert b < a / 2.5, (a, b)


def test_reversibility():
    """Forward, flip the momentum, back with cold solves: the start again
    (fp32, the JAX test's 5e-4)."""
    cfg = dataclasses.replace(CFG, n_chains=2, warm_start=False,
                              cg_tol_force=1e-12)
    x = tl.hot_start(_gen(5), 2, 4, device="cpu")
    v = torch.randn(x.shape, generator=_gen(6))
    phi, _ = tf.pf_refresh(_gen(7), x, cfg.mass)

    def ff(xx, aux):
        f, res = ts.dyn_force(xx, phi, cfg.beta, cfg.mass,
                              torch.zeros_like(phi), cfg.cg_tol_force,
                              cfg.cg_maxiter)
        return f, res.x

    zero = torch.zeros_like(phi)
    x1, v1, _ = ts.omelyan_aux(x, v, cfg.dt, cfg.nstep, ff, zero)
    x2, v2, _ = ts.omelyan_aux(x1, -v1, cfg.dt, cfg.nstep, ff, zero)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=5e-4)
    np.testing.assert_allclose(-v2.numpy(), v.numpy(), atol=5e-4)


@pytest.mark.parametrize("backend", ["kernel", "autograd"])
def test_ft_identity_flow_matches_plain(backend):
    """FT-HMC through an identity flow is plain dynamical HMC: the same
    generator gives the same draws, so dH within 2e-3 and y = x'."""
    _, _, tspec, tp = _flows(identity=True)
    x0 = tl.hot_start(_gen(9), 2, 4, device="cpu")
    q0 = tl.topo_charge(x0)
    cfg = dataclasses.replace(CFG, n_chains=2, nstep=8, cg_tol_force=1e-12)
    x_p, _, m_p = ts.hmc_step_dyn(_gen(11), x0, q0, cfg, device="cpu")
    _, y_f, _, m_f = ts.fthmc_step_dyn(tp, tspec, _gen(11), x0, q0, cfg,
                                       force_backend=backend, device="cpu")
    np.testing.assert_allclose(m_f.dh.numpy(), m_p.dh.numpy(), atol=2e-3)
    np.testing.assert_allclose(y_f.numpy(), x_p.numpy(), atol=1e-5)


def test_ft_random_flow_exp_mdh():
    _, _, tspec, tp = _flows(seed=1)
    cfg = ts.SchwingerConfig(L=4, beta=1.5, mass=0.4, tau=0.2, nstep=20,
                             n_chains=2, ntraj=2, cg_tol_force=1e-12,
                             cg_tol_mh=1e-12, cg_maxiter=400)
    z, hist = ts.run_fthmc_dyn(tp, tspec, cfg, generator=_gen(2),
                               device="cpu")
    assert z.shape == (2, 2, 4, 4)
    assert bool((hist.dh.abs() < 0.08).all()), hist.dh


def test_chunked_matches_whole_run():
    seen = []
    x, h = ts.run_hmc_dyn_chunked(CFG, block=3, generator=_gen(3),
                                  device="cpu",
                                  callback=lambda d, _: seen.append(d))
    assert seen == [3, 4]
    assert all(t.shape == (CFG.ntraj, CFG.n_chains) for t in h)
    assert bool(torch.isfinite(h.dh).all())
    x_full, h_full = ts.run_hmc_dyn(CFG, generator=_gen(3), device="cpu")
    assert torch.equal(x, x_full) and torch.equal(h.dh, h_full.dh)
    _, _, tspec, tp = _flows(identity=True)
    z, hz = ts.run_fthmc_dyn_chunked(tp, tspec, dataclasses.replace(
        CFG, ntraj=3), block=2, generator=_gen(4), device="cpu")
    assert hz.dh.shape == (3, 4) and z.shape == (4, 2, 4, 4)


def test_warm_start_preserves_dh():
    cold = dataclasses.replace(CFG, nstep=12, ntraj=2, warm_start=False)
    warm = dataclasses.replace(cold, warm_start=True)
    x0 = tl.hot_start(_gen(13), 4, 4, device="cpu")
    log_c, log_w = tf.CGLog(), tf.CGLog()
    _, h_c = ts.run_hmc_dyn(cold, x0=x0, generator=_gen(14), device="cpu",
                            cg_log=log_c)
    _, h_w = ts.run_hmc_dyn(warm, x0=x0, generator=_gen(14), device="cpu",
                            cg_log=log_w)
    np.testing.assert_allclose(h_w.dh.numpy(), h_c.dh.numpy(), atol=1e-3)
    # omelyan: two force solves a step, one Metropolis solve a trajectory
    assert len(log_w.solves["force"]) == 2 * 12 * 2
    assert len(log_w.solves["mh"]) == 2
    assert log_w.mean_iters("force") < log_c.mean_iters("force")


def test_eo_hmc_matches_plain_physics():
    """The mirror of tests/test_fermion.py::test_eo_hmc_matches_plain_physics:
    the eo sampler's <exp(-dH)> near 1 and its plaquette that of the
    unpreconditioned one (the same det(D)^2 theory)."""
    base = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.5, nstep=8,
                              n_chains=8, ntraj=40, cg_tol_force=1e-10,
                              cg_tol_mh=1e-12, cg_maxiter=400,
                              eo_precond=False)
    x0 = tl.hot_start(_gen(36), 8, 4, device="cpu")
    _, h0 = ts.run_hmc_dyn(base, x0=x0, generator=_gen(37), device="cpu")
    _, h1 = ts.run_hmc_dyn(dataclasses.replace(base, eo_precond=True),
                           x0=x0, generator=_gen(37), device="cpu")
    assert abs(float(h1.exp_mdh.mean()) - 1.0) < 0.1
    assert abs(float(h0.plaq[20:].mean()) - float(h1.plaq[20:].mean())) \
        < 0.03


def test_unported_options_raise():
    """FT-HMC refuses Hasenbusch, as the JAX package does (the nested
    integrators, Hasenbusch and the 'mixed' CG run since they were ported:
    tests/test_torch_nested.py)."""
    x = torch.zeros((2, 2, 4, 4))
    q = torch.zeros(2)
    _, _, tspec, tp = _flows(identity=True)
    with pytest.raises(ValueError, match="hasenbusch_dm"):
        ts.fthmc_step_dyn(tp, tspec, _gen(0), x, q, dataclasses.replace(
            CFG, hasenbusch_dm=0.5), device="cpu")


def test_runs_on_the_cpu_count_only_twins(cg_backend):
    """On the CPU the 'fused' CG, K1 and the kernel force chain run their
    twins: plain calls counted, no kernel launched."""
    _, _, tspec, tp = _flows(identity=True)
    cfg = dataclasses.replace(CFG, ntraj=1, nstep=2)
    cg_backend("fused")
    before = dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES)
    ts.run_fthmc_dyn(tp, tspec, cfg, generator=_gen(1),
                     force_backend="kernel", device="cpu")
    plain = {k: _build.PLAIN_CALLS[k] - before[0][k] for k in before[0]}
    assert dict(_build.LAUNCHES) == before[1]
    # omelyan: 2 x nstep forces; each is 2 layers of K7 and K8 and one K1;
    # the energy flows (start charge, y0, y1) 2 layers of K6 each
    assert plain["K7"] == plain["K8"] == 2 * 2 * 2
    assert plain["K1"] == 2 * 2 and plain["K6"] == 3 * 2
    assert plain["K11"] > 0
    # 'auto' picks K10 at this 4^2 lattice (resolve_layout), K9 above 8^2
    op, other = (("K10", "K9") if fk.resolve_layout("auto", cfg.L, cfg.L)
                 == "cl" else ("K9", "K10"))
    assert plain[op] > 0 and plain[other] == 0
