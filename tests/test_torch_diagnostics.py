"""fthmc_tpu_torch.diagnostics against fthmc_tpu.diagnostics: the integrator
trace, the reversibility check, the run-validity report (a mirror of the
sanity tests of tests/test_diagnostics.py, each report equal to JAX's on
the same numpy histories) and the NaN guards of tests/test_nan_guards.py
under torch.autograd.detect_anomaly.

The trace runs on the same float64 fields and force in both packages, so
positions, momenta and every StepInfo entry agree to 1e-10. The logger,
plotting and table tests of tests/test_diagnostics.py belong to utils/,
which the port does not have yet."""
import math
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import diagnostics as jd
from fthmc_tpu import lattice as jl
from fthmc_tpu_torch import diagnostics as td
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch import train as ttrain
from fthmc_tpu_torch.config import FlowSpec, TrainConfig
from fthmc_tpu_torch.weights import flow_params_from_numpy

PI = math.pi
TOL = 1e-10
SPEC2 = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,), kernel_size=3)


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


def _fields(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, (2, 2, 8, 8)).astype(dtype)
    return x, rng.normal(size=x.shape).astype(dtype)


def test_leapfrog_with_diagnostics_matches_plain_and_jax():
    x, v = _fields(0)
    beta = 2.0
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    x1, v1, info = td.leapfrog_with_diagnostics(
        xt, vt, 0.1, 6, lambda y: tl.batch_force(y, beta),
        lambda y: tl.batch_action(y, beta))
    x2, v2 = th.leapfrog(xt, vt, 0.1, 6, lambda y: tl.batch_force(y, beta))
    np.testing.assert_allclose(x1.numpy(), x2.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=0, atol=1e-12)
    assert info.force_norm.shape == (6, 2)
    assert np.all(np.isfinite(info.mom_overlap.numpy()))
    summary = td.summarize_step_info(info)
    assert summary["rms_force"] > 0
    assert -1.01 <= summary["final_mom_overlap"] <= 1.01
    with jax.enable_x64():
        jx, jv, jinfo = jd.leapfrog_with_diagnostics(
            jnp.asarray(x), jnp.asarray(v), 0.1, 6,
            lambda y: jl.batch_force(y, beta),
            lambda y: jl.batch_action(y, beta))
        jsum = jd.summarize_step_info(jinfo)
        jx, jv = np.asarray(jx), np.asarray(jv)
        jinfo = [np.asarray(a) for a in jinfo]
    np.testing.assert_allclose(x1.numpy(), jx, rtol=0, atol=TOL)
    np.testing.assert_allclose(v1.numpy(), jv, rtol=0, atol=TOL)
    for got, want in zip(info, jinfo):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    for k, want in jsum.items():
        assert summary[k] == pytest.approx(want, abs=TOL)


def test_reversibility_error_small():
    x, v = _fields(2, np.float32)
    err = td.reversibility_error(torch.as_tensor(x), torch.as_tensor(v),
                                 0.1, 10, lambda y: tl.batch_force(y, 2.0))
    assert err < 1e-3
    x, v = _fields(2)
    err = td.reversibility_error(torch.as_tensor(x), torch.as_tensor(v),
                                 0.1, 10, lambda y: tl.batch_force(y, 2.0))
    with jax.enable_x64():
        jerr = jd.reversibility_error(jnp.asarray(x), jnp.asarray(v), 0.1,
                                      10, lambda y: jl.batch_force(y, 2.0))
    assert err < 1e-12 and abs(err - jerr) < TOL


# ---------------------------------------------------------------- sanity


def _healthy_hist(n=400, B=8, seed=0, plaq0=0.91236):
    rng = np.random.default_rng(seed)
    return {
        "acc": (rng.random((n, B)) < 0.8).astype(np.float32),
        "plaq": plaq0 + 0.002 * rng.standard_normal((n, B)),
        "exp_mdh": 1.0 + 0.05 * rng.standard_normal((n, B)),
    }


def _same_report(hist, **kw):
    """The port's report, equal to JAX's on the same numpy history, and
    equal again when the history holds tensors (a TrajMetrics)."""
    rep = td.sanity_report(hist, **kw)
    assert rep == jd.sanity_report(hist, **kw)
    if isinstance(hist, dict):
        assert td.sanity_report({k: torch.as_tensor(v)
                                 for k, v in hist.items()}, **kw) == rep
    return rep


def test_sanity_report_healthy():
    rep = _same_report(_healthy_hist(), plaq_ref=0.91236)
    assert rep["ok"], rep["flags"]
    assert rep["stats"]["plaq_ref_pull"] < 5


def test_sanity_report_acceptance_collapse():
    h = _healthy_hist()
    h["acc"] = np.zeros_like(h["acc"])
    h["plaq"] = np.ones_like(h["plaq"])
    rep = _same_report(h, plaq_ref=0.91236)
    assert not rep["ok"]
    assert any(f.startswith("acceptance-collapse") for f in rep["flags"])
    assert any(f.startswith("plaq-mismatch") for f in rep["flags"])


def test_sanity_report_drift():
    h = _healthy_hist()
    h["plaq"] += np.linspace(0.05, 0.0, h["plaq"].shape[0])[:, None]
    rep = _same_report(h)
    assert any(f.startswith("plaq-drift") for f in rep["flags"])


def test_sanity_report_nonfinite_and_mdh():
    h = _healthy_hist()
    h["exp_mdh"] = h["exp_mdh"] + 2.0
    rep = _same_report(h)
    assert any(f.startswith("exp_mdh-off") for f in rep["flags"])
    h2 = _healthy_hist()
    h2["plaq"][3, 2] = np.nan
    rep2 = _same_report(h2)
    assert "nonfinite:plaq" in rep2["flags"]


def test_sanity_report_namedtuple_and_single_chain():
    H = namedtuple("H", ["acc", "plaq", "exp_mdh"])
    h = _healthy_hist(B=1)
    hist = H(h["acc"][:, 0], h["plaq"][:, 0], h["exp_mdh"][:, 0])
    rep = _same_report(hist)
    assert rep["ok"], rep["flags"]
    assert td.sanity_report(H(*map(torch.as_tensor, hist))) == rep


# ---------------------------------------------------------------- NaN guards


@pytest.fixture(scope="module")
def params2(params2):
    """The conftest's JAX flow (2 ncp layers, hidden (4,)) in the port."""
    return flow_params_from_numpy(jax.tree_util.tree_map(np.asarray, params2),
                                  SPEC2, device="cpu")


def test_train_step_nan_free(params2):
    cfg = TrainConfig(L=8, beta=2.0, batch_size=8, flow=SPEC2, seed=0)
    state = ttrain.init_train_state(torch.Generator().manual_seed(0), cfg,
                                    params=params2, device="cpu")
    with torch.autograd.detect_anomaly():
        state, metrics = ttrain.train_step(state, SPEC2, 8, 8, 2.0, 1.0,
                                           1e-3)
    assert np.isfinite(float(metrics["loss_dkl"]))


def test_fthmc_step_nan_free(params2):
    g = torch.Generator().manual_seed(1)
    z = tl.hot_start(g, 4, 8, device="cpu")
    with torch.autograd.detect_anomaly():
        _, _, _, m = th.fthmc_step(params2, SPEC2, g, z, torch.zeros(4), 2.0,
                                   0.05, 3, force_backend="autograd",
                                   device="cpu")
    assert bool(torch.isfinite(m.dh).all())


def test_inverse_residual_diagnostic(params2, x_batch):
    """The bisection's convergence as a measurable residual, equal to JAX's
    reading on the same flow and fields to within fp32 roundoff of the
    flow (1e-5)."""
    from fthmc_tpu.config import FlowSpec as JSpec
    from fthmc_tpu.models.flow import init_flow_params
    with torch.autograd.detect_anomaly():
        res = td.flow_inverse_residual(params2, SPEC2,
                                       torch.as_tensor(np.array(x_batch)))
    assert res < 5e-5
    jspec = JSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,), kernel_size=3)
    jres = jd.flow_inverse_residual(
        init_flow_params(jax.random.PRNGKey(7), jspec), jspec, x_batch)
    assert abs(res - jres) < 1e-5
