"""Fermion-aware flow training (``ferm_mass``) in fthmc_tpu_torch against
fthmc_tpu, and mirrors of its tests in tests/test_fermion.py.

The JAX fermion code is fp32 only (complex64 links, the dense log-det in
fp32), so these comparisons run in fp32 on the z JAX's key draws: the
dynamical force and one training step's loss and parameter gradients
(through the double backward of slogdet) within 1e-4 relative in norm."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fthmc_tpu import train as jt
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.hmc import ft_force as jax_ft_force
from fthmc_tpu.models.priors import uniform_link_prior as jax_prior
from fthmc_tpu_torch import train as tt
from fthmc_tpu_torch.config import FlowSpec, TrainConfig
from fthmc_tpu_torch.hmc import ft_force
from fthmc_tpu_torch.weights import flow_params_from_numpy

KW = dict(n_layers=2, coupling="ncp", n_mixture=2, hidden_sizes=(4,))
L = 4


def _both(seed=0):
    rng = np.random.default_rng(seed)
    sizes = (2, *KW["hidden_sizes"], KW["n_mixture"] + 1)
    tree = []
    for _ in range(KW["n_layers"]):
        tree.append([{"w": rng.uniform(-1, 1, (co, ci, 3, 3))
                      / math.sqrt(9 * ci),
                      "b": rng.uniform(-0.2, 0.2, (co,))}
                     for ci, co in zip(sizes[:-1], sizes[1:])])
    spec = FlowSpec(**KW)
    return (JSpec(**KW), jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                      tree),
            spec, flow_params_from_numpy(tree, spec, device="cpu",
                                         dtype=torch.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_ft_force_dyn_matches_jax():
    jspec, jp, spec, tp = _both(1)
    z = np.asarray(jax_prior(L, jnp.float32).sample_n(jax.random.PRNGKey(2),
                                                      3))
    want = np.asarray(jt.ft_force_dyn(jp, jspec, jnp.asarray(z), 2.0, 0.1))
    got = tt.ft_force_dyn(tp, spec, torch.tensor(z), 2.0, 0.1)
    assert _rel(got, want) < 1e-4


def test_ferm_mass_step_loss_and_grads_match_jax():
    """One ferm_mass = 0.1, force_weight = 0.5 reverse-KL objective and its
    parameter gradients (grad of the dynamical force: slogdet's double
    backward) on the z JAX's key draws."""
    jspec, jp, spec, tp = _both(3)
    key, batch, beta = jax.random.PRNGKey(4), 4, 2.0

    def loss_fn(p):
        return jt.reverse_kl_loss(p, jspec, key, batch, L, beta, 1.0,
                                  force_weight=0.5, ferm_mass=0.1)

    (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    z = np.asarray(jax_prior(L, jnp.float32).sample_n(key, batch))
    want = [np.asarray(c[k]) for net in g for c in net for k in ("w", "b")]
    tloss, taux, tg = tt.loss_and_grads(tp, spec, torch.tensor(z), beta,
                                        1.0, force_weight=0.5,
                                        ferm_mass=0.1)
    assert abs(float(tloss) - float(loss)) <= 1e-4 * abs(float(loss))
    assert _rel(taux["force_sq"], aux["force_sq"]) < 1e-4
    assert _rel(torch.cat([t.flatten() for t in tg]),
                np.concatenate([w.ravel() for w in want])) < 1e-4


def test_ft_force_dyn_reduces_to_gauge_force_at_heavy_mass():
    """The mirror of the JAX test: as m grows the determinant's force
    vanishes, so the dynamical force tends to the quenched one; at a light
    mass it is genuinely different."""
    _, _, spec, tp = _both(5)
    z = torch.rand((2, 2, L, L), generator=torch.Generator().manual_seed(6))
    z = (2 * z - 1) * math.pi
    fg = ft_force(tp, spec, z, 2.0, device="cpu").numpy()
    fd = tt.ft_force_dyn(tp, spec, z, 2.0, mass=1e4).numpy()
    np.testing.assert_allclose(fd, fg, rtol=1e-4, atol=5e-4)
    fl = tt.ft_force_dyn(tp, spec, z, 2.0, mass=0.1).numpy()
    assert np.max(np.abs(fl - fg)) > 1e-2


def test_train_step_fermaware_runs_and_updates():
    spec = FlowSpec(n_layers=2, hidden_sizes=(4,), n_mixture=2)
    cfg = TrainConfig(L=L, beta=2.0, batch_size=4, flow=spec,
                      force_weight=0.5, ferm_mass=0.1)
    state = tt.init_train_state(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    new, metrics = tt.train_step(state, spec, 4, L, 2.0, 1.0, 1e-3,
                                 force_weight=0.5, ferm_mass=0.1)
    assert math.isfinite(float(metrics["loss_dkl"]))
    assert math.isfinite(float(metrics["force_sq"]))
    assert any(not torch.allclose(a, b) for a, b in zip(
        tt.param_leaves(state.params), tt.param_leaves(new.params)))


def test_train_era_threads_ferm_mass():
    """The mirror of the JAX regression test: the fermion-aware term
    changes the era's force_sq (a threading bug once made it a no-op)."""
    spec = FlowSpec(n_layers=2, hidden_sizes=(4,), n_mixture=2)
    cfg = TrainConfig(L=L, beta=2.0, batch_size=4, flow=spec)

    def era(ferm_mass):
        state = tt.init_train_state(torch.Generator().manual_seed(1), cfg,
                                    device="cpu")
        return tt.train_era(state, spec, 4, L, 2.0, 1.0, 1e-3, 2,
                            force_weight=0.5, ferm_mass=ferm_mass)[1]

    fg, ff = era(0.0)["force_sq"], era(0.1)["force_sq"]
    assert np.all(np.isfinite(ff))
    assert np.max(np.abs(fg - ff)) > 1e-6


def test_train_runs_ferm_mass_from_its_config():
    """train() passes cfg.ferm_mass to every era (it once raised)."""
    spec = FlowSpec(n_layers=2, hidden_sizes=(4,), n_mixture=2)
    cfg = TrainConfig(L=L, beta=2.0, batch_size=4, flow=spec, n_era=1,
                      n_epoch=2, force_weight=0.5, ferm_mass=0.1, seed=3)
    _, hist = tt.train(cfg, device="cpu")
    base = TrainConfig(L=L, beta=2.0, batch_size=4, flow=spec, n_era=1,
                       n_epoch=2, force_weight=0.5, seed=3)
    _, ref = tt.train(base, device="cpu")
    assert np.all(np.isfinite(hist["force_sq"]))
    assert np.max(np.abs(np.asarray(hist["force_sq"])
                         - np.asarray(ref["force_sq"]))) > 1e-6


def test_jax_quenched_force_is_the_ports_at_ferm_mass_zero():
    """ferm_mass = 0 leaves the force objective the quenched one: the
    port's force equals JAX's ft_force on the same z (1e-4, fp32)."""
    jspec, jp, spec, tp = _both(7)
    z = np.asarray(jax_prior(L, jnp.float32).sample_n(jax.random.PRNGKey(8),
                                                      2))
    want = np.asarray(jax_ft_force(jp, jspec, jnp.asarray(z), 2.0))
    got = ft_force(tp, spec, torch.tensor(z), 2.0, device="cpu")
    assert _rel(got, want) < 1e-4
