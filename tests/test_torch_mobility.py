"""fthmc_tpu_torch.mobility against fthmc_tpu.mobility: a mirror of
tests/test_mobility.py. mobility_stats is host numpy in both packages, so
its dict equals JAX's exactly on the same series, bootstrap seed included.
The probes run the port's samplers on the CPU at the JAX tests' tiny sizes
and return JAX's keys, with its block rounding and floor extension."""
import jax
import numpy as np
import pytest
import torch

from fthmc_tpu import mobility as jm
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.mobility import mobility_probe, mobility_stats
from fthmc_tpu_torch.models.flow import init_flow_params


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


@pytest.fixture(scope="module")
def jax_keys():
    """The keys of the JAX package's probe (its plain probe at this file's
    smallest size)."""
    return set(jm.mobility_probe(None, None, L=8, beta=2.0, n_chains=4,
                                 ntraj=4, therm=2, tau=1.0, nstep=2,
                                 call_block=4, sampler="plain",
                                 key=jax.random.PRNGKey(0)))


def test_mobility_stats_exact_on_synthetic_series():
    # chain 0 hops 0->1->1->0 (dq^2 = 1,0,1); chain 1 frozen
    q = np.array([[0.0, 2.0], [1.0, 2.0], [1.0, 2.0], [0.0, 2.0]])
    st = mobility_stats(q, s_per_traj=0.5)
    assert st["mobility"] == pytest.approx((2 / 3 + 0.0) / 2)
    assert st["n_events"] == pytest.approx(2.0)
    assert st["n_chains"] == 2 and st["ntraj"] == 4
    assert st["B_mob_per_s"] == pytest.approx(st["mobility"] * 2 / 0.5)
    assert st["mobility_err"] > 0
    st1 = mobility_stats(q[:, 0])
    assert st1["mobility_err"] == pytest.approx(
        st1["mobility"] / np.sqrt(2.0))
    assert st == jm.mobility_stats(q, s_per_traj=0.5)
    assert st1 == jm.mobility_stats(q[:, 0])


@pytest.mark.parametrize("shape,seed", [((50, 16), 0), ((9, 3), 7),
                                        ((20,), 3)])
def test_mobility_stats_equal_jax_on_the_same_series(shape, seed):
    """Integer charge series with hops: every value, the bootstrap error
    included (numpy's generator seeded alike), equals JAX's exactly; a
    tensor series gives the same dict."""
    rng = np.random.default_rng(seed)
    q = np.cumsum(rng.integers(-1, 2, size=shape) * (rng.random(shape) < 0.3),
                  axis=0).astype(np.float32)
    for kw in ({}, {"s_per_traj": 0.25, "n_boot": 100, "seed": 5}):
        st = mobility_stats(q, **kw)
        assert st == jm.mobility_stats(q, **kw)
        assert mobility_stats(torch.as_tensor(q), **kw) == st


def test_mobility_stats_rejects_single_row():
    with pytest.raises(ValueError):
        mobility_stats(np.zeros((1, 4)))


def test_probe_plain_quenched_runs_and_reports(jax_keys):
    st = mobility_probe(None, None, L=8, beta=2.0, n_chains=4, ntraj=12,
                        therm=4, tau=1.0, nstep=4, call_block=8,
                        sampler="plain",
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert set(st) == jax_keys
    assert 0.0 <= st["acc"] <= 1.0
    assert st["mobility"] >= 0.0 and st["valid"]
    assert st["s_per_traj"] > 0 and st["B_mob_per_s"] >= 0.0
    # ntraj rounds up to whole timed blocks: 12 -> 2 blocks of 8
    assert st["ntraj"] == 16 and st["sampler"] == "plain"
    assert st["n_events"] > 0
    with pytest.raises(ValueError, match="sampler"):
        mobility_probe(None, None, L=8, beta=2.0, sampler="nope",
                       device="cpu")


@pytest.fixture(scope="module")
def tiny_flow():
    spec = FlowSpec(n_layers=2, hidden_sizes=(4, 4), n_mixture=2,
                    coupling="ncp")
    params = init_flow_params(spec, torch.Generator().manual_seed(3),
                              device="cpu")
    return params, spec


def test_probe_ft_quenched(tiny_flow, jax_keys):
    params, spec = tiny_flow
    st = mobility_probe(params, spec, L=8, beta=2.0, n_chains=4, ntraj=8,
                        therm=2, tau=0.5, nstep=4, call_block=8,
                        sampler="ft", generator=torch.Generator().manual_seed(1),
                        device="cpu")
    assert set(st) == jax_keys
    assert 0.0 <= st["acc"] <= 1.0 and st["mobility"] >= 0.0
    assert 0.0 < st["plaq"] <= 1.0
    assert st["ntraj"] == 8


def test_probe_ft_dynamical_and_floor_extension(tiny_flow, jax_keys):
    params, spec = tiny_flow
    # an impossible floor with a 1-block budget: the probe extends by
    # exactly 2 blocks and flags the row invalid
    st = mobility_probe(params, spec, L=8, beta=1.0, mass=0.3, n_chains=4,
                        ntraj=6, therm=2, tau=0.5, nstep=2, call_block=6,
                        cg_maxiter=200, sampler="ft",
                        generator=torch.Generator().manual_seed(2),
                        min_events=1e9, max_extra_blocks=2, device="cpu")
    assert set(st) == jax_keys
    assert st["ntraj"] == 6 + 2 * 6
    assert not st["valid"]
    assert 0.0 <= st["acc"] <= 1.0
    assert st["mass"] == 0.3 and st["sampler"] == "ft"


def test_probe_draws_from_the_generator():
    """The same generator seed gives the same run; another seed another."""
    def run(seed):
        return mobility_probe(None, None, L=8, beta=2.0, n_chains=4,
                              ntraj=4, therm=2, tau=1.0, nstep=2,
                              call_block=4, sampler="plain",
                              generator=torch.Generator().manual_seed(seed),
                              device="cpu")
    a, b, c = run(5), run(5), run(6)
    assert (a["plaq"], a["mobility"]) == (b["plaq"], b["mobility"])
    assert a["plaq"] != c["plaq"]
