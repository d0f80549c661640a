"""Flow sampling in fthmc_tpu_torch against fthmc_tpu.

The accept pass is held against the JAX package's on the proposals and
uniforms its keys draw: the acceptance pattern and the fields exactly (a
selection), charges, logq and logp to 1e-12 in float64 for the serial
chain; the JAX ensemble draws float32 latents, so its comparison runs in
float32. The rest mirrors
tests/test_sampling.py on the port, whose proposals run K6's plain twin
here.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import lattice as jl
from fthmc_tpu import sampling as js
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.train import sample_and_logq as jax_sample_and_logq
from fthmc_tpu_torch import sampling as ts
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.sampling import generate_ensemble, make_mcmc_ensemble
from fthmc_tpu_torch.weights import flow_params_from_numpy

PI = math.pi
TOL = 1e-12
KW = dict(n_layers=2, coupling="ncp", n_mixture=2, hidden_sizes=(4,))
SPEC2 = FlowSpec(**KW)


def np_tree(kw, seed, identity=False):
    rng = np.random.default_rng(seed)
    M = kw["n_mixture"]
    out = 2 * M + 1 if kw["coupling"] == "rncp" else M + 1
    sizes = (2, *kw["hidden_sizes"], out)
    tree = []
    for _ in range(kw["n_layers"]):
        net = []
        for ci, co in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / math.sqrt(9 * ci)
            net.append({"w": rng.uniform(-bound, bound, (co, ci, 3, 3)),
                        "b": rng.uniform(-bound, bound, (co,))})
        if identity:
            net[-1] = {k: np.zeros_like(v) for k, v in net[-1].items()}
        tree.append(net)
    return tree


@pytest.fixture(scope="module")
def params2():
    return flow_params_from_numpy(np_tree(KW, 7), SPEC2, device="cpu")


@pytest.fixture(scope="module")
def identity_params2():
    return flow_params_from_numpy(np_tree(KW, 7, identity=True), SPEC2,
                                  device="cpu")


def gen(seed):
    return torch.Generator().manual_seed(seed)


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=TOL * max(1.0, np.abs(b).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the accept pass against the JAX package's on its draws
# ---------------------------------------------------------------------------

def test_mcmc_chain_scan_matches_jax():
    """One serial chain over given proposals: the JAX scan's uniforms (one
    key a step) fed to the port."""
    n, L = 40, 4
    rng = np.random.default_rng(0)
    props = rng.uniform(-PI, PI, (n, 2, L, L))
    logq = rng.normal(size=n) - 20.0
    logp = logq + rng.normal(size=n)
    x0 = rng.uniform(-PI, PI, (2, L, L))
    key = jax.random.PRNGKey(4)
    with jax.enable_x64():
        ref = js.mcmc_chain_scan(key, jnp.asarray(props), jnp.asarray(logq),
                                 jnp.asarray(logp), jnp.asarray(x0),
                                 jnp.asarray(-20.0), jnp.asarray(-20.5))
        u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(
            jax.random.split(key, n))
        ref, u = jax.tree.map(np.asarray, ref), np.asarray(u)
    got = ts.mcmc_chain_scan(None, torch.tensor(props), torch.tensor(logq),
                             torch.tensor(logp), torch.tensor(x0),
                             torch.tensor(-20.0, dtype=torch.float64),
                             torch.tensor(-20.5, dtype=torch.float64),
                             uniforms=torch.tensor(u))
    assert 0 < ref.acc.sum() < n
    np.testing.assert_array_equal(got.acc.numpy(), ref.acc)
    np.testing.assert_array_equal(got.x.numpy(), ref.x)
    for k in ("q", "dqsq", "logq", "logp"):
        close(getattr(got, k).numpy(), getattr(ref, k), k)


@pytest.mark.parametrize("n_chains,batch,num_samples", [(3, 5, 16),
                                                        (1, 8, 17)])
def test_accept_pass_matches_the_jax_ensemble_scan(n_chains, batch,
                                                   num_samples):
    """The multi-chain ensemble block by block: the proposals (x, logq,
    logp, charge) and uniforms that _ensemble_scan's keys draw, through the
    port's accept_pass, against the history of the JAX package's
    make_mcmc_ensemble with the same key. The JAX ensemble draws float32
    latents, so this runs in float32: the acceptance pattern and the fields
    equal exactly; charges, logq and logp to 1e-6 relative (the proposals
    here are JAX's eager ops, the ensemble's its compiled scan, whose sums
    round in another order)."""
    L, beta, key = 8, 2.0, jax.random.PRNGKey(9)
    tree = np_tree(KW, 3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    jspec = JSpec(**KW)
    ref = js.make_mcmc_ensemble(jp, jspec, beta=beta, L=L,
                                batch_size=batch, num_samples=num_samples,
                                key=key, n_chains=n_chains,
                                keep_fields=True)
    kinit, kscan = jax.random.split(key)
    x0, _, lq0 = jax_sample_and_logq(jp, jspec, kinit, n_chains, L)
    init = (x0, lq0, -jl.batch_action(x0, beta), jl.batch_charges(x0))
    blocks = []
    nblocks = -(-(num_samples - 1) // batch)
    for kb in jax.random.split(kscan, nblocks):
        kprop, kacc = jax.random.split(kb)
        xp, _, lqp = jax_sample_and_logq(jp, jspec, kprop,
                                         batch * n_chains, L)
        lpp = -jl.batch_action(xp, beta)
        qpp = jl.batch_charges(xp)
        us = jax.random.uniform(kacc, (batch, n_chains), lqp.dtype)
        blocks.append([np.asarray(a).reshape(batch, n_chains,
                                             *a.shape[1:])
                       for a in (xp, lqp, lpp, qpp)] + [np.asarray(us)])
    init = [np.asarray(a) for a in init]
    carry = tuple(torch.tensor(a) for a in init)
    rows = {"x": [init[0][None]], "logq": [init[1][None]],
            "logp": [init[2][None]], "q": [init[3][None]],
            "acc": [np.ones((1, n_chains))],
            "dqsq": [np.zeros((1, n_chains))]}
    for xp, lqp, lpp, qpp, us in blocks:
        out, carry = ts.accept_pass(carry, *(torch.tensor(a) for a in
                                             (lqp, lpp, qpp, us)),
                                    proposals=torch.tensor(xp))
        for k, v in out.items():
            rows[k].append(v.numpy())
    got = {k: np.concatenate(v)[:num_samples] for k, v in rows.items()}
    if n_chains == 1:
        got = {k: v[:, 0] for k, v in got.items()}
    assert 0 < ref["acc"][1:].mean() < 1
    np.testing.assert_array_equal(got["acc"], ref["acc"])
    np.testing.assert_array_equal(got["x"], ref["x"])
    for k in ("q", "dqsq", "logq", "logp"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(ref[k]).max()),
                                   err_msg=k)


def test_identity_flow_at_beta_zero_accepts_everything(identity_params2):
    """The identity flow proposes from the prior, which at beta = 0 is the
    target: every proposal is accepted, logq is the prior's constant."""
    hist = make_mcmc_ensemble(identity_params2, SPEC2, beta=0.0, L=8,
                              batch_size=8, num_samples=33, generator=gen(2),
                              n_chains=3, device="cpu")
    assert (hist["acc"] == 1.0).all()
    np.testing.assert_allclose(hist["logq"], -128 * math.log(2 * PI),
                               rtol=1e-6)


def test_proposals_run_k6s_twin_once_a_layer_a_block(params2):
    nblocks = -(-(20 - 1) // 4)
    _build.reset_counts()
    make_mcmc_ensemble(params2, SPEC2, beta=2.0, L=8, batch_size=4,
                       num_samples=20, generator=gen(0), n_chains=2,
                       device="cpu")
    assert _build.PLAIN_CALLS["K6"] == SPEC2.n_layers * (nblocks + 1)
    assert not any(_build.LAUNCHES.values())


def test_flow_backend_torch_runs_the_torch_flow_and_every_spec(params2):
    """flow_backend='torch' runs models.flow.flow_forward (no K6 twin
    call): on an ncp flow its history equals 'auto''s exactly (the same
    operations), and it samples the specs K6 does not take, a spline and a
    bf16-conv flow. An unknown backend raises."""
    kw = dict(beta=2.0, L=8, batch_size=4, num_samples=13, n_chains=2,
              device="cpu")
    ref = make_mcmc_ensemble(params2, SPEC2, generator=gen(4), **kw)
    _build.reset_counts()
    got = make_mcmc_ensemble(params2, SPEC2, generator=gen(4),
                             flow_backend="torch", **kw)
    assert not any(_build.PLAIN_CALLS.values())
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    for spec in (FlowSpec(n_layers=2, coupling="spline", n_knots=4,
                          hidden_sizes=(4,), s_clip=3.0),
                 FlowSpec(**KW, conv_dtype="bfloat16")):
        params = (params2 if spec.coupling == "ncp" else
                  flow_params_from_numpy(
                      [[{"w": 0.1 * np.ones((4, 2, 3, 3)),
                         "b": np.zeros(4)},
                        {"w": 0.05 * np.ones((13, 4, 3, 3)),
                         "b": np.zeros(13)}]] * 2, spec, device="cpu"))
        out = make_mcmc_ensemble(params, spec, generator=gen(5),
                                 flow_backend="torch", **kw)
        assert out["acc"].shape == (13, 2) and out["acc"][0].all()
        assert np.all(np.isfinite(out["logq"]))
    with pytest.raises(ValueError, match="flow_backend"):
        make_mcmc_ensemble(params2, SPEC2, generator=gen(4),
                           flow_backend="bogus", **kw)


# ---------------------------------------------------------------------------
# mirrors of tests/test_sampling.py
# ---------------------------------------------------------------------------

def test_mcmc_ensemble_shapes_and_chain_consistency(params2):
    hist = make_mcmc_ensemble(params2, SPEC2, beta=2.0, L=8, batch_size=16,
                              num_samples=50, generator=gen(0), device="cpu")
    for k in ("q", "dqsq", "logq", "logp", "acc"):
        assert hist[k].shape == (50,), (k, hist[k].shape)
    acc = hist["acc"]
    assert acc[0] == 1.0
    assert set(np.unique(acc)) <= {0.0, 1.0}
    rej = np.where(acc[1:] == 0.0)[0] + 1
    np.testing.assert_allclose(hist["logp"][rej], hist["logp"][rej - 1])
    np.testing.assert_allclose(hist["q"][rej], hist["q"][rej - 1], atol=1e-5)
    np.testing.assert_allclose(hist["dqsq"][rej], 0.0, atol=1e-8)


def test_identity_flow_uniform_proposals_all_weights_equal(identity_params2):
    hist = make_mcmc_ensemble(identity_params2, SPEC2, beta=1.0, L=8,
                              batch_size=16, num_samples=64, generator=gen(1),
                              device="cpu")
    lq = hist["logq"]
    np.testing.assert_allclose(lq, lq[0], atol=1e-4)
    assert 0.0 < hist["acc"].mean() <= 1.0


def test_multichain_ensemble_shapes_and_independence(params2):
    hist = make_mcmc_ensemble(params2, SPEC2, beta=2.0, L=8, batch_size=8,
                              num_samples=33, generator=gen(3), n_chains=4,
                              device="cpu")
    for k in ("q", "dqsq", "logq", "logp", "acc"):
        assert hist[k].shape == (33, 4), (k, hist[k].shape)
    acc = hist["acc"]
    np.testing.assert_allclose(acc[0], 1.0)
    for c in range(4):
        rej = np.where(acc[1:, c] == 0.0)[0] + 1
        np.testing.assert_allclose(hist["logp"][rej, c],
                                   hist["logp"][rej - 1, c])
        np.testing.assert_allclose(hist["dqsq"][rej, c], 0.0, atol=1e-8)
    assert not np.allclose(hist["logp"][:, 0], hist["logp"][:, 1])


def test_multichain_keep_fields(params2):
    hist = make_mcmc_ensemble(params2, SPEC2, beta=2.0, L=8, batch_size=4,
                              num_samples=9, generator=gen(4), n_chains=2,
                              keep_fields=True, device="cpu")
    assert hist["x"].shape == (9, 2, 2, 8, 8)
    acc = hist["acc"]
    for c in range(2):
        rej = np.where(acc[1:, c] == 0.0)[0] + 1
        np.testing.assert_allclose(hist["x"][rej, c], hist["x"][rej - 1, c])


def test_generate_ensemble_multichain_reports(params2):
    out = generate_ensemble(params2, SPEC2, beta=2.0, L=8, ensemble_size=40,
                            batch_size=8, n_chains=3, generator=gen(5),
                            device="cpu")
    assert 0.0 <= out["accept_rate"] <= 1.0
    assert np.isfinite(out["suscept_mean"]) and out["suscept_err"] >= 0
    assert out["tau_int_q"] >= 0.5
    assert out["chain_stats"]["n_chains"] == 3


def test_generate_ensemble_reports(params2):
    out = generate_ensemble(params2, SPEC2, beta=2.0, L=8, ensemble_size=64,
                            batch_size=16, nboot=10, binsize=4,
                            generator=gen(2), device="cpu")
    assert 0.0 <= out["accept_rate"] <= 1.0
    assert np.isfinite(out["suscept_mean"])
    assert out["suscept_err"] >= 0.0


# ---------------------------------------------------------------------------
# the JAX package's readings that tests/test_torch_card_training.py holds
# the card to
# ---------------------------------------------------------------------------

def jax_reference_readings() -> dict:
    """The JAX package's readings, on the CPU, of the two configurations
    the card suite runs with the exported flows: D_KL = mean(logq - logp) of
    flow8x8_b3_rncp24 at 8^2, beta=3 over 8192 draws (with its standard
    error), and flow sampling with flow8x8_b2_16l_long at 8^2, beta=2, 64
    chains x 4096 samples in blocks of 64 (acceptance, tau_int(Q))."""
    import time

    from fthmc_tpu.checkpoint import load_checkpoint_auto
    from fthmc_tpu.observables import chain_stats

    out = {}
    state, _, spec, _ = load_checkpoint_auto("artifacts/flow8x8_b3_rncp24")
    draw = jax.jit(lambda k: jax_sample_and_logq(state.params, spec, k,
                                                 1024, 8))
    d = []
    for k in jax.random.split(jax.random.PRNGKey(0), 8):
        x, _, logq = draw(k)
        d.append(np.asarray(logq + jl.batch_action(x, 3.0)))
    d = np.concatenate(d)
    out["dkl_rncp24_b3"] = {"draws": d.size, "mean": float(d.mean()),
                            "stderr": float(d.std() / np.sqrt(d.size))}
    state, _, spec, _ = load_checkpoint_auto(
        "artifacts/flow8x8_b2_16l_long")
    t0 = time.perf_counter()
    hist = js.make_mcmc_ensemble(state.params, spec, beta=2.0, L=8,
                                 batch_size=64, num_samples=4096,
                                 key=jax.random.PRNGKey(0), n_chains=64)
    cs = chain_stats(hist["q"])
    out["sampling_16l_long_b2"] = {
        "chains": 64, "samples": 4096, "batch": 64,
        "acceptance": float(np.mean(hist["acc"])),
        "tau_int_q": cs["tau_int_q"], "tau_int_q_err": cs["tau_int_q_err"],
        "chi_q": cs["chi_q"], "cpu_seconds": time.perf_counter() - t0}
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sampling.py
    import json
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(jax_reference_readings()))
