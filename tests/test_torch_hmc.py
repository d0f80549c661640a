"""Plain HMC in fthmc_tpu_torch against fthmc_tpu, and mirrors of
tests/test_hmc.py and tests/test_omelyan.py.

The trajectories, dH and accept of every backend (on the CPU: the 'xla'
loop with K1's twin, and the twins of K2, K3, K5) are held in float64
against the JAX package's XLA path fed the draws the port took from its
generator, to 1e-10 (a few hundred fp64 operations a link; roundoff
~1e-13). The statistical mirrors run in fp32 with the JAX tests' windows."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import hmc as jh
from fthmc_tpu import lattice as jl
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.config import HMCConfig
from fthmc_tpu_torch.ops import _build, rng
from fthmc_tpu_torch.ops.lattice_kernels import hmc_traj_hostrng_plain

TOL = 1e-10
TRAJ_BACKENDS = ["xla", "pallas", "pallas_cl"]
STEP_BACKENDS = ["auto", "xla", "pallas", "pallas_cl", "fused",
                 "fused_hostrng"]


def _links(seed, B=8, L=8, lo=-math.pi, hi=math.pi):
    return np.random.default_rng(seed).uniform(lo, hi, (B, 2, L, L))


def _momenta(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def _wrapped_err(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.remainder(d + math.pi, 2 * math.pi) - math.pi).max()


@pytest.mark.parametrize("backend,integrator", [
    ("xla", "leapfrog"), ("pallas", "leapfrog"), ("pallas_cl", "leapfrog"),
    ("auto", "leapfrog"), ("xla", "omelyan"), ("auto", "omelyan")])
def test_run_leapfrog_matches_jax(backend, integrator):
    x, v = _links(1), _momenta(2, (8, 2, 8, 8))
    with jax.enable_x64():
        ref = jh.run_leapfrog(jnp.asarray(x), jnp.asarray(v), 2.5, 0.1, 7,
                              backend="xla", integrator=integrator)
        ref = [np.asarray(r) for r in ref]
    got = th.run_leapfrog(torch.as_tensor(x), torch.as_tensor(v), 2.5, 0.1,
                          7, backend=backend, integrator=integrator,
                          device="cpu")
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL)


def test_kinetic_delta_matches_jax():
    v0, v1 = _momenta(3, (5, 2, 6, 6)), _momenta(4, (5, 2, 6, 6))
    with jax.enable_x64():
        ref = np.asarray(jh._kinetic_delta(jnp.asarray(v1), jnp.asarray(v0)))
    got = th._kinetic_delta(torch.as_tensor(v1), torch.as_tensor(v0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def _jax_step(x, v0, u, beta, dt, nstep, integrator):
    """The JAX package's hmc_step (hmc.py:192-211) on the given draws."""
    with jax.enable_x64():
        xj = jnp.asarray(x)
        x1, v1 = jh.run_leapfrog(xj, jnp.asarray(v0), beta, dt, nstep,
                                 backend="xla", integrator=integrator)
        x1 = jl.wrap(x1)
        dh = (jax.vmap(lambda a, b: jl.delta_action(a, b, beta))(x1, xj)
              + jh._kinetic_delta(v1, jnp.asarray(v0)))
        acc = jnp.asarray(u) < jnp.exp(-dh)
        x_new = jnp.where(acc[:, None, None, None], x1, xj)
        return {"x": np.asarray(x_new), "dh": np.asarray(dh),
                "acc": np.asarray(acc, np.float64),
                "plaq": np.asarray(jl.batch_plaq_mean(x_new)),
                "q": np.asarray(jl.batch_charges(x_new))}


@pytest.mark.parametrize("backend,integrator", [
    (b, "leapfrog") for b in STEP_BACKENDS] + [("auto", "omelyan")])
def test_hmc_step_matches_jax(backend, integrator):
    """hmc_step from x with the momenta and accept draws its generator
    gives: the JAX step on the same draws gives the same x', dH and
    metrics. 'fused' draws from the Philox stream of a seed the generator
    gives."""
    beta, seed = 2.0, 5
    dt, nstep = (0.12, 6) if integrator == "leapfrog" else (0.35, 4)
    x = _links(6, lo=-1.0, hi=1.0)
    B = x.shape[0]
    q0 = tl.topo_charge(torch.as_tensor(x))
    x_new, q_new, m = th.hmc_step(torch.Generator().manual_seed(seed),
                                  torch.as_tensor(x), q0, beta, dt, nstep,
                                  backend=backend, integrator=integrator,
                                  device="cpu")
    g = torch.Generator().manual_seed(seed)
    if backend == "fused":
        s = torch.randint(0, 2 ** 31 - 1, (1,), generator=g,
                          dtype=torch.int32)
        v0 = rng.momenta(s, B, 8, torch.float64).numpy()
        u = rng.accept_uniforms(s, B, torch.float64).numpy()
    else:
        v0 = torch.randn(x.shape, generator=g, dtype=torch.float64).numpy()
        u = torch.rand((B,), generator=g, dtype=torch.float64).numpy()
    ref = _jax_step(x, v0, u, beta, dt, nstep, integrator)
    np.testing.assert_allclose(m.dh.numpy(), ref["dh"], rtol=0, atol=TOL)
    np.testing.assert_array_equal(m.acc.numpy(), ref["acc"])
    assert 0 < ref["acc"].sum() < B   # both branches of the accept
    assert _wrapped_err(x_new.numpy(), ref["x"]) < TOL
    for k in ("plaq", "q"):
        np.testing.assert_allclose(getattr(m, k).numpy(), ref[k], rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(m.exp_mdh.numpy(), np.exp(-ref["dh"]),
                               rtol=1e-9)
    np.testing.assert_allclose(m.dq.numpy(), np.abs(ref["q"] - q0.numpy()),
                               rtol=0, atol=TOL)
    assert torch.equal(q_new, m.q)


def test_fused_step_is_k5_on_its_seed_draws():
    """hmc_step(backend='fused') on the CPU is K4's twin: K5's arithmetic on
    the Philox draws of the seed it takes from the generator."""
    x = torch.as_tensor(_links(7, B=4), dtype=torch.float32)
    q0 = tl.topo_charge(x)
    x_new, _, m = th.hmc_step(torch.Generator().manual_seed(3), x, q0, 2.0,
                              0.1, 4, backend="fused", device="cpu")
    s = torch.randint(0, 2 ** 31 - 1, (1,),
                      generator=torch.Generator().manual_seed(3),
                      dtype=torch.int32)
    xr, dhr, accr = hmc_traj_hostrng_plain(x, rng.momenta(s, 4, 8),
                                           rng.accept_uniforms(s, 4), 2.0,
                                           0.1, 4)
    assert torch.equal(x_new, xr) and torch.equal(m.dh, dhr)
    assert torch.equal(m.acc, accr)


@pytest.mark.parametrize("backend,integrator,nstep,tol", [
    (b, "leapfrog", 12, 2e-4) for b in TRAJ_BACKENDS] + [
    ("xla", "omelyan", 10, 3e-4)])
def test_reversibility(backend, integrator, nstep, tol):
    """Forward, flip the momentum, back: the start again (fp32, the JAX
    tests' bounds)."""
    x = torch.as_tensor(_links(0, B=2, lo=-3.0, hi=3.0), dtype=torch.float32)
    v = torch.as_tensor(_momenta(1, x.shape), dtype=torch.float32)
    kw = dict(backend=backend, integrator=integrator, device="cpu")
    x1, v1 = th.run_leapfrog(x, v, 2.0, 0.1, nstep, **kw)
    x2, v2 = th.run_leapfrog(x1, -v1, 2.0, 0.1, nstep, **kw)
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=tol)
    np.testing.assert_allclose(v2.numpy(), -v.numpy(), atol=tol)


def _abs_dh(x, v, x1, v1, beta):
    return float((tl.delta_action(x1, x, beta)
                  + th._kinetic_delta(v1, v)).abs().mean())


def test_energy_error_scaling_and_omelyan():
    """Leapfrog's |dH| ~ dt^2 (halving dt cuts it > 2.5x); at equal dt the
    2MN integrator's is > 5x smaller."""
    x = torch.as_tensor(_links(2, B=4, lo=-3.0, hi=3.0), dtype=torch.float32)
    v = torch.as_tensor(_momenta(3, x.shape), dtype=torch.float32)

    def dh(nstep, integrator="leapfrog", tau=1.0):
        x1, v1 = th.run_leapfrog(x, v, 2.0, tau / nstep, nstep,
                                 integrator=integrator, device="cpu")
        return _abs_dh(x, v, x1, v1, 2.0)

    assert dh(16) < dh(8) / 2.5
    assert dh(16, "omelyan", 2.0) < dh(16, "leapfrog", 2.0) / 5.0


@pytest.mark.parametrize("backend", STEP_BACKENDS)
def test_hmc_step_shapes_and_determinism(backend):
    x = torch.zeros((8, 2, 8, 8))
    q = tl.topo_charge(x)
    out = [th.hmc_step(torch.Generator().manual_seed(5), x, q, 2.0, 0.2, 10,
                       backend=backend, device="cpu") for _ in range(2)]
    assert torch.equal(out[0][0], out[1][0])
    m = out[0][2]
    assert all(t.shape == (8,) for t in m)
    assert set(m.acc.unique().tolist()) <= {0.0, 1.0}
    assert out[0][0].dtype == torch.float32


@pytest.mark.parametrize("backend,integrator,nstep,ntraj,min_acc", [
    ("auto", "leapfrog", 10, 400, 0.5), ("fused", "leapfrog", 10, 400, 0.5),
    ("auto", "omelyan", 8, 300, 0.8)])
def test_run_hmc_physics(backend, integrator, nstep, ntraj, min_acc):
    """8x8, beta=2 from a hot start: <plaq> within 0.01 of the exact Bessel
    ratio, <exp(-dH)> within 0.05 of 1 (the JAX tests' windows), over the
    second half of the run."""
    cfg = HMCConfig(beta=2.0, L=8, tau=2.0, nstep=nstep, ntraj=ntraj,
                    n_chains=32, randinit=True, seed=7)
    x, hist = th.run_hmc(cfg, backend=backend, integrator=integrator,
                         device="cpu")
    half = ntraj // 2
    assert x.shape == (32, 2, 8, 8)
    assert all(t.shape == (ntraj, 32) for t in hist)
    assert abs(float(hist.plaq[half:].mean()) - tl.PLAQ_EXACT[2.0]) < 0.01
    assert abs(float(hist.exp_mdh[half:].mean()) - 1.0) < 0.05
    assert min_acc < float(hist.acc.mean()) <= 1.0


@pytest.mark.parametrize("backend,integrator,epilogues", [
    ("auto", "leapfrog", 1), ("xla", "omelyan", 1), ("pallas", "leapfrog", 1),
    ("pallas_cl", "leapfrog", 1), ("fused", "leapfrog", 0),
    ("fused_hostrng", "leapfrog", 0)])
def test_run_hmc_takes_the_epilogue_twin_once_a_trajectory(
        backend, integrator, epilogues):
    """On the CPU a step after K2, K3 or the K1 loop ends in K12's twin,
    once a trajectory; the fused steps have their own epilogue; nothing is
    launched."""
    cfg = HMCConfig(beta=2.0, L=8, tau=0.5, nstep=2, ntraj=5, n_chains=3,
                    randinit=True, seed=1)
    _build.reset_counts()
    th.run_hmc(cfg, backend=backend, integrator=integrator, device="cpu")
    assert _build.PLAIN_CALLS["K12"] == epilogues * cfg.ntraj
    assert not any(_build.LAUNCHES.values())


def test_run_hmc_chunked_matches_shapes():
    cfg = HMCConfig(beta=2.0, L=8, tau=1.0, nstep=4, ntraj=10, n_chains=4,
                    randinit=True, seed=5)
    calls = []
    x, hist = th.run_hmc_chunked(cfg, block=4, device="cpu",
                                 callback=lambda done, h: calls.append(done))
    assert calls == [4, 8, 10]
    assert all(t.shape == (10, 4) and t.device.type == "cpu" for t in hist)
    assert bool(torch.isfinite(hist.dh).all())
    # one generator threads through the blocks: the same as one run
    x_full, hist_full = th.run_hmc(cfg, device="cpu")
    assert torch.equal(x, x_full) and torch.equal(hist.dh, hist_full.dh)


def test_run_hmc_thinned_summary_consistent():
    """The thinned history is every thin-th trajectory of the full run, and
    the summary the full run's means over all trajectories."""
    cfg = HMCConfig(beta=2.0, L=8, tau=2.0, nstep=8, ntraj=64, n_chains=16,
                    randinit=True, seed=5)
    x, hist, summary = th.run_hmc_thinned(cfg, thin=8, device="cpu")
    assert hist.plaq.shape == (8, 16)
    x_full, full = th.run_hmc(cfg, device="cpu")
    assert torch.equal(x, x_full)
    assert torch.equal(hist.plaq, full.plaq[7::8])
    for k, ref in (("acc", full.acc), ("plaq", full.plaq),
                   ("exp_mdh", full.exp_mdh), ("abs_dh", full.dh.abs())):
        np.testing.assert_allclose(float(summary[k]), float(ref.mean()),
                                   rtol=1e-5)
    with pytest.raises(ValueError):
        th.run_hmc_thinned(cfg, thin=7, device="cpu")


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_run_hmc_rejection_keeps_state(backend):
    """With an absurd step everything rejects, and a rejected chain keeps
    its state exactly."""
    cfg = HMCConfig(beta=2.0, L=8, tau=80.0, nstep=2, ntraj=4, n_chains=4,
                    randinit=True, seed=3)
    x0 = tl.hot_start(torch.Generator().manual_seed(1), 4, 8, device="cpu")
    x, hist = th.run_hmc(cfg, x0=x0, backend=backend, device="cpu")
    assert float(hist.acc.mean()) < 0.3
    q_prev = torch.cat([tl.topo_charge(x0)[None], hist.q[:-1]])
    frozen = hist.acc == 0.0
    assert torch.equal(hist.q[frozen], q_prev[frozen])
    if not bool(hist.acc.any()):
        assert torch.equal(x, x0)


def test_run_hmc_nrun_independent_runs():
    cfg = HMCConfig(beta=2.0, L=8, tau=1.0, nstep=6, ntraj=8, n_chains=4,
                    nrun=3, randinit=True, seed=2)
    x, runs = th.run_hmc_nrun(cfg, device="cpu")
    assert runs.plaq.shape == (3, 8, 4) and x.shape == (4, 2, 8, 8)
    assert bool(torch.isfinite(runs.dh).all())
    assert float((runs.plaq[0] - runs.plaq[1]).abs().max()) > 0


def test_cold_start_and_seeded_generator():
    """x0=None starts cold unless cfg.randinit; generator=None seeds one
    with cfg.seed, so two runs of one config agree."""
    cfg = HMCConfig(beta=6.0, L=8, tau=1.0, nstep=4, ntraj=3, n_chains=2)
    a = th.run_hmc(cfg, device="cpu")
    b = th.run_hmc(cfg, device="cpu")
    assert torch.equal(a[0], b[0])
    first = th.run_hmc(HMCConfig(beta=6.0, L=8, tau=1e-6, nstep=1, ntraj=1,
                                 n_chains=2), device="cpu")[1]
    assert float(first.plaq.min()) > 0.999999


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_plain_hmc_entry_points_need_the_card_unless_asked(no_cuda):
    """hmc_step and the run drivers default to the card and raise without
    one; with device='cpu' they run there."""
    x = torch.zeros((2, 2, 8, 8))
    q = torch.zeros(2)
    cfg = HMCConfig(beta=2.0, L=8, tau=0.5, nstep=2, ntraj=2, n_chains=2)
    calls = [
        lambda **kw: th.hmc_step(torch.Generator(), x, q, 2.0, 0.1, 2, **kw),
        lambda **kw: th.run_leapfrog(x, x, 2.0, 0.1, 2, **kw),
        lambda **kw: th.run_hmc(cfg, generator=torch.Generator(), **kw),
        lambda **kw: th.run_hmc_thinned(cfg, thin=1,
                                        generator=torch.Generator(), **kw),
        lambda **kw: th.run_hmc_nrun(cfg, generator=torch.Generator(), **kw),
        lambda **kw: th.run_hmc_chunked(cfg, generator=torch.Generator(),
                                        **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")


def test_resolve_backend():
    f32, f64 = torch.float32, torch.float64
    assert th.resolve_backend("auto", "leapfrog", f32, "cpu") == "xla"
    assert th.resolve_backend("auto", "leapfrog", f64, "cpu") == "xla"
    assert th.resolve_backend("auto", "leapfrog", f32, "cuda") == \
        "pallas"
    assert th.resolve_backend("auto", "omelyan", f32, "cuda") == "xla"
    # the measured rule: K3 up to 16^2, K2 above, whatever the chains
    for B in (1, 128, 1024):
        for L, kernel in ((2, "pallas_cl"), (8, "pallas_cl"),
                          (16, "pallas_cl"), (17, "pallas"),
                          (32, "pallas"), (64, "pallas")):
            shape = (B, 2, L, L)
            assert th.resolve_backend("auto", "leapfrog", f32, "cuda",
                                      shape) == kernel
            assert th.resolve_backend("auto", "omelyan", f32, "cuda",
                                      shape) == "xla"
            assert th.resolve_backend("auto", "leapfrog", f32, "cpu",
                                      shape) == "xla"
    for b in ("pallas", "pallas_cl", "fused", "fused_hostrng", "xla"):
        assert th.resolve_backend(b, "leapfrog", f32, "cuda") == b
    # fp64 on the card has no kernel: 'auto' raises instead of running the
    # torch loop unseen
    for integrator in ("leapfrog", "omelyan"):
        with pytest.raises(ValueError):
            th.resolve_backend("auto", integrator, f64, "cuda")
    # the trajectory kernels integrate leapfrog only
    for b in ("pallas", "pallas_cl", "fused", "fused_hostrng"):
        with pytest.raises(ValueError):
            th.resolve_backend(b, "omelyan", f32, "cpu")
    with pytest.raises(ValueError):
        th.resolve_backend("mosaic", "leapfrog", f32, "cpu")
    with pytest.raises(ValueError):
        th.resolve_backend("xla", "verlet", f32, "cpu")
    x = torch.zeros((4, 2, 8, 8))
    with pytest.raises(ValueError):   # a whole step, not a trajectory
        th.run_leapfrog(x, x, 1.0, 0.1, 1, backend="fused", device="cpu")
