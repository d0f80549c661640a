"""fthmc_tpu_torch.observables against fthmc_tpu.observables.

The training metrics (calc_dkl, calc_ess) are torch: float64 against the
JAX package in 64-bit mode to 1e-12 (a logsumexp over the batch). The
ensemble statistics are the same numpy code with the same RNG seeding:
equal results exactly. The rest mirrors tests/test_observables.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import observables as jo
from fthmc_tpu_torch import observables as to
from fthmc_tpu_torch.observables import (blocked_dq_sq_vs_dt, bootstrap,
                                         calc_dkl, calc_ess, chain_stats,
                                         tau_int, tau_int_err,
                                         topo_susceptibility)


def _ar1(rng, n, rho, nchain=1):
    """AR(1) series with tau_int = (1+rho)/(2(1-rho)), shape (n, nchain)."""
    x = np.empty((n, nchain))
    x[0] = rng.normal(size=nchain)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho**2) * rng.normal(size=nchain)
    return x


# ---------------------------------------------------------------------------
# against the JAX package on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 30.0), (2, 300.0)])
def test_dkl_and_ess_match_jax(seed, scale):
    rng = np.random.default_rng(seed)
    logp = rng.normal(size=64) * scale
    logq = rng.normal(size=64) * scale - 5.0
    with jax.enable_x64():
        dkl = float(jo.calc_dkl(jnp.asarray(logp), jnp.asarray(logq)))
        ess = float(jo.calc_ess(jnp.asarray(logp), jnp.asarray(logq)))
    tp, tq = torch.tensor(logp), torch.tensor(logq)
    assert abs(float(to.calc_dkl(tp, tq)) - dkl) <= 1e-12 * max(1, abs(dkl))
    assert abs(float(to.calc_ess(tp, tq)) - ess) <= 1e-12


def test_ensemble_statistics_equal_jax_exactly():
    """bootstrap, topo_susceptibility, acceptance_rate, tau_int,
    tau_int_err, chain_stats, blocked_dq_sq_vs_dt, creutz_ratio and
    string_tension_exact give the JAX package's numbers on the same inputs
    and seeds."""
    rng = np.random.default_rng(11)
    x = _ar1(rng, 2048, 0.7, nchain=6)
    q = np.round(3 * x)
    acc = (rng.uniform(size=(300, 4)) < 0.3).astype(np.float32)
    for kw in (dict(nboot=50, binsize=8), dict(nboot=20, binsize=64)):
        assert bootstrap(x[:, 0], rng=np.random.default_rng(3), **kw) == \
            jo.bootstrap(x[:, 0], rng=np.random.default_rng(3), **kw)
        assert bootstrap(x, **kw) == jo.bootstrap(x, **kw)
    assert topo_susceptibility(q[:, 1]) == jo.topo_susceptibility(q[:, 1])
    assert to.acceptance_rate(acc) == jo.acceptance_rate(acc)
    for c, lag in ((4.0, None), (6.0, 100)):
        assert tau_int(x[:, 2], c, lag) == jo.tau_int(x[:, 2], c, lag)
        assert tau_int_err(x[:, 2], c, lag) == jo.tau_int_err(x[:, 2], c,
                                                              lag)
    for kw in (dict(), dict(n_boot=50, seed=3, therm_frac=0.25, c=5.0)):
        assert chain_stats(q, **kw) == jo.chain_stats(q, **kw)
        assert chain_stats(q[:, 0], **kw) == jo.chain_stats(q[:, 0], **kw)
    assert blocked_dq_sq_vs_dt(q[:, 3], 7, 9) == \
        jo.blocked_dq_sq_vs_dt(q[:, 3], 7, 9)
    W = np.exp(-0.3 * np.outer(np.arange(5), np.arange(5))) \
        * (1 + 0.01 * rng.normal(size=(5, 5)))
    for R, T in ((1, 1), (2, 3), (4, 4)):
        assert to.creutz_ratio(W, R, T) == jo.creutz_ratio(W, R, T)
    for beta in (1.0, 2.0, 6.0, 9.5):
        assert to.string_tension_exact(beta) == jo.string_tension_exact(beta)
    with pytest.raises(KeyError):
        to.string_tension_exact(1.25)


# ---------------------------------------------------------------------------
# mirrors of tests/test_observables.py
# ---------------------------------------------------------------------------

def test_ess_equal_weights_is_one():
    logp = torch.zeros(64)
    logq = torch.full((64,), 3.0)
    assert abs(float(calc_ess(logp, logq)) - 1.0) < 1e-6


def test_ess_single_dominant_weight():
    logp = torch.tensor([0.0] + [-100.0] * 63)
    logq = torch.zeros(64)
    assert abs(float(calc_ess(logp, logq)) - 1.0 / 64) < 1e-6


def test_dkl():
    logp = torch.tensor([1.0, 2.0])
    logq = torch.tensor([2.0, 4.0])
    assert abs(float(calc_dkl(logp, logq)) - 1.5) < 1e-6


def test_bootstrap_recovers_mean():
    rng = np.random.default_rng(0)
    x = rng.normal(5.0, 1.0, size=1024)
    mean, err = bootstrap(x, nboot=200, binsize=16, rng=rng)
    assert abs(mean - 5.0) < 0.2
    assert 0.0 < err < 0.2


def test_topo_susceptibility():
    rng = np.random.default_rng(1)
    q = rng.normal(0.0, 2.0, size=2048)
    mean, err = topo_susceptibility(q, nboot=100, binsize=16, rng=rng)
    assert abs(mean - 4.0) < 0.5


def test_tau_int_iid_is_half():
    rng = np.random.default_rng(2)
    x = rng.normal(size=8192)
    assert abs(tau_int(x) - 0.5) < 0.15


def test_tau_int_correlated_series():
    rng = np.random.default_rng(3)
    n, rho = 16384, 0.9
    x = np.empty(n)
    x[0] = rng.normal()
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho**2) * rng.normal()
    t = tau_int(x)
    assert 6.0 < t < 14.0


def test_tau_int_err_covers_truth():
    rng = np.random.default_rng(4)
    x = _ar1(rng, 32768, 0.8)[:, 0]
    t, err, w = tau_int_err(x)
    assert w > 0
    assert 0.0 < err < t
    assert abs(t - 4.75) < 4 * err + 0.5


def test_chain_stats_ar1_known_tau():
    rng = np.random.default_rng(5)
    q = _ar1(rng, 8192, 0.9, nchain=32)
    cs = chain_stats(q)
    assert cs["n_chains"] == 32 and cs["ntraj_used"] == 8192
    assert cs["tau_int_q_err"] > 0
    assert abs(cs["tau_int_q"] - 9.5) < 4 * cs["tau_int_q_err"] + 1.0
    assert abs(cs["chi_q"] - 1.0) < 4 * cs["chi_q_err"] + 0.05
    assert abs(cs["q_mobility_dt1"] - 2 * (1 - 0.9)) < 0.05


def test_chain_stats_bootstrap_error_sanity():
    rng = np.random.default_rng(6)
    q = _ar1(rng, 4096, 0.5, nchain=64)
    a = chain_stats(q)
    b = chain_stats(2.0 * q)
    assert abs(a["tau_int_q"] - b["tau_int_q"]) < 1e-12
    assert abs(b["chi_q"] - 4 * a["chi_q"]) < 1e-9
    assert abs(b["chi_q_err"] - 4 * a["chi_q_err"]) < 1e-9
    few = chain_stats(q[:, :8])
    assert few["tau_int_q_err"] > a["tau_int_q_err"]


def test_chain_stats_therm_and_single_chain():
    rng = np.random.default_rng(7)
    q = _ar1(rng, 2048, 0.5, nchain=1)
    cs = chain_stats(q[:, 0], therm_frac=0.25)
    assert cs["therm"] == 512 and cs["ntraj_used"] == 1536
    assert cs["n_chains"] == 1
    assert cs["tau_int_q_err"] > 0 and cs["chi_q_err"] > 0


def test_blocked_dq_sq_vs_dt():
    q = np.arange(100, dtype=np.float64)
    out = blocked_dq_sq_vs_dt(q, dt_range=5, n_block=4)
    for dt, mean, err in out:
        assert abs(mean - dt * dt) < 1e-9
