"""Flow training in fthmc_tpu_torch against fthmc_tpu.

The JAX package draws its latent batch from a key inside each step; the
port draws from a torch.Generator, so every comparison hands the port's
deterministic core the z the JAX key draws. Float64 bounds: the loss and its
gradients (a flow of 2 layers, with the double backward of the force
objectives) 1e-10, a few thousand fp64 operations a site; one Adam update
with clipping on identical gradients 1e-12 (a few operations an element);
the plateau rule and the beta schedule exactly. The rest mirrors
tests/test_train.py on the port.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fthmc_tpu import train as jt
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.config import SchedulerConfig as JSched
from fthmc_tpu.config import TrainConfig as JCfg
from fthmc_tpu.hmc import ft_force as jax_ft_force
from fthmc_tpu.models.priors import uniform_link_prior as jax_prior
from fthmc_tpu_torch import train as tt
from fthmc_tpu_torch.config import FlowSpec, SchedulerConfig, TrainConfig
from fthmc_tpu_torch.hmc import ft_force
from fthmc_tpu_torch.models.flow import flow_forward, init_flow_params
from fthmc_tpu_torch.models.priors import uniform_link_prior
from fthmc_tpu_torch.weights import flow_params_from_numpy

TOL = 1e-10
PI = math.pi
KW = {"ncp": dict(n_layers=2, coupling="ncp", n_mixture=2,
                  hidden_sizes=(4,)),
      "rncp": dict(n_layers=2, coupling="rncp", n_mixture=2,
                   hidden_sizes=(4,), s_clip=3.0)}
SPEC2 = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,), kernel_size=3)


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


def both(kw, seed=0, dtype=torch.float64):
    tree = np_tree(kw, seed)
    spec = FlowSpec(**kw)
    return (JSpec(**kw), jax.tree.map(jnp.asarray, tree), spec,
            flow_params_from_numpy(tree, spec, device="cpu", dtype=dtype))


def jax_leaves(tree):
    """A JAX flow tree's arrays in the port's param_leaves order."""
    return [np.asarray(conv[k]) for net in tree for conv in net
            for k in ("w", "b")]


def assert_leaves(got, ref, tol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=0, atol=tol)


def cpu_state(cfg, seed=0):
    return tt.init_train_state(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package on the same z
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coupling,force_weight", [
    ("ncp", 0.0), ("rncp", 0.0), ("ncp", 0.3), ("rncp", 0.3)])
def test_reverse_kl_loss_and_grads_match_jax(coupling, force_weight):
    """loss, aux and the parameter gradients, with force_weight > 0 the
    gradient of the force objective (grad of grad), against
    jax.value_and_grad of reverse_kl_loss on the z its key draws."""
    key, batch, L, beta = jax.random.PRNGKey(5), 6, 8, 2.5
    with jax.enable_x64():
        jspec, jp, spec, tp = both(KW[coupling], seed=1)

        def loss_fn(p):
            return jt.reverse_kl_loss(p, jspec, key, batch, L, beta, 0.7,
                                      dtype=jnp.float64,
                                      force_weight=force_weight)

        (loss, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jp)
        z = np.asarray(jax_prior(L, jnp.float64).sample_n(key, batch))
        ref = {k: np.asarray(v) for k, v in aux.items()}
        loss, g = float(loss), jax_leaves(g)
    tloss, taux, tg = tt.loss_and_grads(tp, spec, torch.tensor(z), beta,
                                        0.7, force_weight=force_weight)
    np.testing.assert_array_equal(taux["z"].numpy(), ref["z"])
    assert abs(float(tloss) - loss) <= TOL * max(1.0, abs(loss))
    for k in ("logp", "logq", "dkl") + (("force_sq",) if force_weight
                                        else ()):
        np.testing.assert_allclose(taux[k].numpy(), ref[k], rtol=0,
                                   atol=TOL * max(1.0, np.abs(ref[k]).max()))
    assert_leaves(tg, g, TOL * max(1.0, max(np.abs(r).max() for r in g)))


def test_force_matching_loss_and_grads_match_jax():
    """sum ||F_eff||^2 and its parameter gradients (grad of grad) against
    jax.value_and_grad of the same objective on the same z."""
    beta = 2.0
    z = np.random.default_rng(3).uniform(-PI, PI, (4, 2, 8, 8))
    with jax.enable_x64():
        jspec, jp, spec, tp = both(KW["rncp"], seed=2)

        def loss_fn(p):
            f = jax_ft_force(p, jspec, jnp.asarray(z), beta)
            return jnp.sum(f * f)

        loss, g = jax.jit(jax.value_and_grad(loss_fn))(jp)
        loss, g = float(loss), jax_leaves(g)
    tloss, tg = tt.force_loss_and_grads(tp, spec, torch.as_tensor(z), beta)
    assert abs(float(tloss) - loss) <= TOL * max(1.0, abs(loss))
    assert_leaves(tg, g, TOL * max(1.0, max(np.abs(r).max() for r in g)))


def test_grad_of_grad_through_remat_equals_without():
    """flow_forward checkpoints each layer (non-reentrant): the force
    objective's parameter gradient is the same with and without it."""
    _, _, spec, tp = both(KW["rncp"], seed=4)
    z = torch.as_tensor(np.random.default_rng(4).uniform(-PI, PI,
                                                         (3, 2, 8, 8)))
    (l1, g1), (l2, g2) = (tt.force_loss_and_grads(tp, spec, z, 1.5,
                                                  remat=r)
                          for r in (True, False))
    assert abs(float(l1) - float(l2)) <= 1e-12 * abs(float(l2))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    _, a1, k1 = tt.loss_and_grads(tp, spec, z, 1.5, force_weight=0.4,
                                  remat=True)
    _, a2, k2 = tt.loss_and_grads(tp, spec, z, 1.5, force_weight=0.4,
                                  remat=False)
    for a, b in zip(k1, k2):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("grad_clip", [None, 1e3, 0.05])
def test_adam_update_matches_optax(grad_clip):
    """Three updates (global-norm clipping, Adam, plateau-scaled learning
    rate) on identical gradients against optax's, as the JAX package
    builds it (make_optimizer, inject_hyperparams). grad_clip 1e3 never
    clips, 0.05 always does."""
    base_lr, scales = 1e-2, (1.0, 0.5, 0.25)
    rng = np.random.default_rng(6)
    tree = np_tree(KW["ncp"], seed=6)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape), tree)
             for _ in scales]
    with jax.enable_x64():
        opt = jt.make_optimizer(base_lr, grad_clip)
        p = jax.tree.map(jnp.asarray, tree)
        st = opt.init(p)
        for g, s in zip(grads, scales):
            st.hyperparams["learning_rate"] = base_lr * jnp.asarray(
                s, jnp.float32)
            upd, st = opt.update(jax.tree.map(jnp.asarray, g), st, p)
            p = optax.apply_updates(p, upd)
        ref = jax_leaves(p)
    spec = FlowSpec(**KW["ncp"])
    params = flow_params_from_numpy(tree, spec, device="cpu",
                                    dtype=torch.float64)
    adam = tt.make_optimizer(base_lr, grad_clip)
    opt_state = adam.init(params)
    for g, s in zip(grads, scales):
        tg = [torch.as_tensor(a) for a in jax_leaves(g)]
        params, opt_state = adam.update(tg, opt_state, params,
                                        torch.tensor(s, dtype=torch.float32))
    assert int(opt_state.count) == 3
    assert_leaves(tt.param_leaves(params), ref, 1e-12)


def _jax_sched_state():
    return jt.TrainState(params=None, opt_state=None, key=None,
                         step=jnp.zeros((), jnp.int32),
                         lr_scale=jnp.ones((), jnp.float32),
                         best_loss=jnp.full((), jnp.inf, jnp.float32),
                         plateau_count=jnp.zeros((), jnp.int32))


def _port_sched_state():
    return tt.TrainState(params=None, opt_state=None, generator=None,
                         step=torch.zeros((), dtype=torch.int32),
                         lr_scale=torch.ones(()),
                         best_loss=torch.full((), torch.inf),
                         plateau_count=torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("sched", [
    dict(factor=0.5, patience=2, threshold=1e-4, cooldown=0, min_lr=1e-5),
    dict(factor=0.3, patience=1, threshold=1e-2, cooldown=3, min_lr=2e-4),
    dict(factor=0.5, patience=0, threshold=0.0, cooldown=1, min_lr=1e-4)])
def test_plateau_rule_matches_jax_exactly(sched):
    """The device rule over a fixed loss sequence (improvements, plateaus,
    a relative-threshold miss, an inf and a nan loss) against
    _plateau_update_device: lr_scale, best_loss and plateau_count equal
    after every epoch, including the inf guard and the cooldown."""
    losses = np.array([5.0, 4.0, 4.0, 3.99999, 4.1, 4.0, 3.0, 3.0, 3.0, 3.0,
                       np.inf, 2.0, 2.0, np.nan, 2.0, 1.0, 1.0, 1.0, 1.0,
                       1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                      np.float32)
    js, ts = _jax_sched_state(), _port_sched_state()
    jsc, tsc = JSched(**sched), SchedulerConfig(**sched)
    for loss in losses:
        js = jt._plateau_update_device(js, jnp.asarray(loss), jsc, 1e-3)
        ts = tt._plateau_update_device(ts, torch.tensor(loss), tsc, 1e-3)
        for k in ("lr_scale", "best_loss", "plateau_count"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                          np.asarray(getattr(js, k)))
    assert float(ts.lr_scale) < 1.0


@pytest.mark.parametrize("era", [0, 1, 3])
@pytest.mark.parametrize("kw", [
    dict(beta=3.0, beta_init=2.0, beta_anneal_frac=0.5, n_era=4, n_epoch=7),
    dict(beta=2.5, beta_init=1.0, beta_anneal_frac=0.7, n_era=4, n_epoch=5),
    dict(beta=6.0, beta_init=3.0, beta_anneal_frac=1.0, n_era=4, n_epoch=3)])
def test_anneal_betas_matches_jax_exactly(kw, era):
    ref = np.asarray(jt.anneal_betas(JCfg(**kw), era))
    got = tt.anneal_betas(TrainConfig(**kw), era, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tt.anneal_betas(TrainConfig(), era, device="cpu") is None


def test_train_step_at_matches_jax_train_step():
    """One whole step in fp32, as both packages train: the port's step at
    the z that the JAX step's key draws against JAX's train_step (flow,
    loss, gradients, clipping, Adam at a plateau-scaled rate, metrics),
    to fp32 roundoff through two layers and one update (1e-5)."""
    kw = dict(KW["rncp"], hidden_sizes=(4, 4))
    tree = np_tree(kw, seed=8)
    jspec = JSpec(**kw)
    jcfg = JCfg(L=8, beta=2.0, batch_size=8, flow=jspec, grad_clip=0.5)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    js = jt.init_train_state(jax.random.PRNGKey(3), jcfg, params=jp)
    js = js._replace(lr_scale=jnp.asarray(0.5, jnp.float32))
    z = np.asarray(jax_prior(8).sample_n(jax.random.split(js.key)[1], 8))
    js, jm = jt.train_step(js, jspec, 8, 8, 2.0, 1.0, 1e-2, 0.5)
    spec = FlowSpec(**kw)
    ts = tt.init_train_state(
        torch.Generator().manual_seed(0),
        TrainConfig(L=8, flow=spec, grad_clip=0.5),
        params=flow_params_from_numpy(tree, spec, device="cpu"),
        device="cpu")._replace(lr_scale=torch.tensor(0.5))
    ts, tm = tt.train_step_at(ts, spec, torch.tensor(z), 2.0, 1.0, 1e-2,
                              0.5)
    assert int(ts.step) == int(js.step) == 1
    assert_leaves(tt.param_leaves(ts.params), jax_leaves(js.params), 1e-5)
    assert set(tm) == set(jm)
    for k, v in jm.items():
        v = np.asarray(v)
        np.testing.assert_allclose(tm[k].numpy(), v, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(v).max()))


def test_ferm_mass_and_mesh_raise():
    """ferm_mass > 0 runs through every entry since it was ported (finite
    force objectives; tests/test_torch_train_ferm.py holds it to JAX);
    mesh= trains since it was ported (tests/test_torch_mesh.py) and, as
    the JAX package asserts, refuses ferm_mass and force matching."""
    cfg = TrainConfig(L=8, n_era=1, n_epoch=1, batch_size=2, flow=SPEC2,
                      force_weight=1.0, ferm_mass=0.2)
    _, hist = tt.train(cfg, device="cpu")
    assert np.isfinite(hist["force_sq"]).all()
    state = cpu_state(cfg)
    _, m = tt.train_step(state, SPEC2, 2, 8, 2.0, 1.0, 1e-3,
                         force_weight=1.0, ferm_mass=0.2)
    assert math.isfinite(float(m["force_sq"]))
    _, h = tt.train_era(state, SPEC2, 2, 8, 2.0, 1.0, 1e-3, 1, ferm_mass=0.2)
    assert np.isfinite(h["loss_dkl"]).all()
    z = uniform_link_prior(8, device="cpu").sample_n(state.generator, 2)
    loss, aux = tt.reverse_kl_loss(state.params, SPEC2, z, 2.0,
                                   force_weight=1.0, ferm_mass=0.2)
    assert math.isfinite(float(loss)) and "force_sq" in aux
    with pytest.raises(ValueError, match="single-device"):
        tt.train(cfg, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        tt.train(TrainConfig(L=8, flow=SPEC2, with_force=True),
                 mesh=object(), device="cpu")


def test_era_metrics_come_back_as_the_jax_era_returns_them():
    """train_era's host metrics have the JAX era's names, one value an
    epoch, and the step count advances by n_epoch."""
    jcfg = JCfg(L=8, beta=2.0, n_epoch=2, batch_size=4,
                flow=JSpec(n_layers=1, n_mixture=2, hidden_sizes=(2,)))
    js = jt.init_train_state(jax.random.PRNGKey(0), jcfg)
    _, jh = jt.train_era(js, jcfg.flow, 4, 8, 2.0, 1.0, 1e-3, 2,
                         sched=JSched(), with_force=True, force_weight=0.1)
    cfg = TrainConfig(L=8, beta=2.0, n_epoch=2, batch_size=4,
                      flow=FlowSpec(n_layers=1, n_mixture=2,
                                    hidden_sizes=(2,)))
    state, th = tt.train_era(cpu_state(cfg), cfg.flow, 4, 8, 2.0, 1.0, 1e-3,
                             2, sched=SchedulerConfig(), with_force=True,
                             force_weight=0.1)
    assert set(th) == set(jh)
    for k, v in th.items():
        assert isinstance(v, np.ndarray) and v.shape == (2,), k
        assert v.dtype == np.asarray(jh[k]).dtype, k
    assert int(state.step) == 2


# ---------------------------------------------------------------------------
# mirrors of tests/test_train.py
# ---------------------------------------------------------------------------

def _cfg(spec):
    return TrainConfig(L=8, beta=2.0, n_era=1, n_epoch=3, batch_size=8,
                       base_lr=1e-3, flow=spec, seed=0)


def test_train_step_metrics_and_update():
    cfg = _cfg(SPEC2)
    state = cpu_state(cfg)
    p0 = tt.param_leaves(state.params)[0].clone()
    state, metrics = tt.train_step(state, SPEC2, cfg.batch_size, cfg.L,
                                   cfg.beta, 1.0, cfg.base_lr)
    assert int(state.step) == 1
    assert float((tt.param_leaves(state.params)[0] - p0).abs().max()) > 0.0
    assert 0.0 < float(metrics["ess"]) <= 1.0 + 1e-6
    for k in ("loss_dkl", "logp", "logq", "plaq"):
        assert np.isfinite(float(metrics[k]))


def test_training_improves_loss():
    cfg = TrainConfig(L=8, beta=2.0, n_era=1, n_epoch=30, batch_size=32,
                      base_lr=3e-3, flow=SPEC2, seed=1)
    _, history = tt.train(cfg, device="cpu")
    losses = np.asarray(history["loss_dkl"], dtype=np.float64)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert np.asarray(history["ess"], dtype=np.float64)[-1] > 0.0


def test_force_matching_step_runs():
    cfg = _cfg(SPEC2)
    state = cpu_state(cfg)
    state, metrics = tt.force_matching_step(state, SPEC2, 4, cfg.L, cfg.beta,
                                            cfg.base_lr, 0.01)
    assert np.isfinite(float(metrics["loss_force"]))
    assert int(state.step) == 0    # the KL step owns the step count


def test_force_matching_with_distillation():
    """Latents distilled through a frozen pre-model and inverted through
    the current flow: with the identity flow they are the pre-model's
    pushforward."""
    kw = dict(n_layers=2, coupling="ncp", n_mixture=2, hidden_sizes=(4,))
    pre = flow_params_from_numpy(np_tree(kw, 7), SPEC2, device="cpu")
    ident = flow_params_from_numpy(np_tree(kw, 7, identity=True), SPEC2,
                                   device="cpu")
    xi = tt.distill_latents(ident, pre, SPEC2,
                            torch.Generator().manual_seed(0), 2, 8)
    z_pre = uniform_link_prior(8, device="cpu").sample_n(
        torch.Generator().manual_seed(0), 2)
    with torch.no_grad():
        x_expect, _ = flow_forward(pre, z_pre, SPEC2)
    err = (torch.remainder(xi - x_expect + PI, 2 * PI) - PI).abs().max()
    assert float(err) < 1e-4
    state = cpu_state(_cfg(SPEC2), seed=1)
    state, metrics = tt.force_matching_step(state, SPEC2, 2, 8, 2.0, 1e-3,
                                            0.01, pre_params=pre)
    assert np.isfinite(float(metrics["loss_force"]))


def test_plateau_scheduler():
    cfg = _cfg(SPEC2)
    sched = SchedulerConfig(factor=0.5, patience=2, threshold=1e-4,
                            min_lr=1e-5)
    state = cpu_state(cfg)
    state = tt.plateau_scheduler_update(state, 1.0, sched, cfg.base_lr)
    assert float(state.best_loss) == 1.0
    for _ in range(3):
        state = tt.plateau_scheduler_update(state, 1.0, sched, cfg.base_lr)
    assert float(state.lr_scale) == 0.5
    state = tt.plateau_scheduler_update(state, 0.5, sched, cfg.base_lr)
    assert float(state.best_loss) == 0.5
    assert int(state.plateau_count) == 0


def test_resume_continues_era_numbering(tmp_path):
    """Restore-then-train produces ckpt_era{k+1}, not era 0 again."""
    from fthmc_tpu_torch.checkpoint import (find_and_load_checkpoint,
                                            save_checkpoint)
    cfg = TrainConfig(L=8, beta=2.0, n_era=3, n_epoch=2, batch_size=4,
                      flow=SPEC2, seed=0)
    ckdir = str(tmp_path / "ck")
    saved = []

    def ckpt_fn(era, st, history):
        saved.append(era)
        save_checkpoint(ckdir, st, era=era, epoch=cfg.n_epoch,
                        history=history)

    cfg01 = TrainConfig(L=8, beta=2.0, n_era=2, n_epoch=2, batch_size=4,
                        flow=SPEC2, seed=0)
    tt.train(cfg01, checkpoint_fn=ckpt_fn, device="cpu")
    assert saved == [0, 1]
    state2, meta = find_and_load_checkpoint(ckdir, cpu_state(cfg))
    assert meta["era"] == 1
    state3, _ = tt.train(cfg, state2, checkpoint_fn=ckpt_fn,
                         start_era=meta["era"] + 1)
    assert saved == [0, 1, 2]
    assert int(state3.step) == 6


def test_annealed_training_beta_schedule():
    cfg = TrainConfig(L=8, beta=2.5, beta_init=2.0, beta_anneal_frac=0.5,
                      n_era=2, n_epoch=4, batch_size=4, flow=SPEC2, seed=0)
    _, hist = tt.train(cfg, device="cpu")
    betas = np.asarray(hist["beta"])
    assert abs(betas[0] - 2.0) < 1e-6
    assert abs(betas[-1] - 2.5) < 1e-6
    assert np.all(np.diff(betas) >= -1e-6)


def test_grad_clip_trains():
    cfg = TrainConfig(L=8, beta=2.0, n_era=1, n_epoch=3, batch_size=4,
                      flow=SPEC2, seed=0, grad_clip=1.0)
    _, hist = tt.train(cfg, device="cpu")
    assert np.isfinite(hist["loss_dkl"]).all()


def test_plateau_never_fires_while_improving():
    sched = SchedulerConfig(factor=0.5, patience=2)
    state = cpu_state(TrainConfig(L=8, flow=FlowSpec(n_layers=1,
                                                     hidden_sizes=(2,))))
    for i in range(10):
        state = tt._plateau_update_device(
            state, torch.tensor(1.0 - 0.05 * i), sched, 1e-3)
    assert float(state.lr_scale) == 1.0
    assert abs(float(state.best_loss) - 0.55) < 1e-6


def test_scheduler_cooldown_device():
    sched = SchedulerConfig(factor=0.5, patience=1, cooldown=3)
    state = cpu_state(TrainConfig(L=8, flow=FlowSpec(n_layers=1,
                                                     hidden_sizes=(2,))))
    state = state._replace(best_loss=torch.tensor(0.0))
    scales = []
    for _ in range(8):
        state = tt._plateau_update_device(state, torch.tensor(1.0), sched,
                                          1e-3)
        scales.append(float(state.lr_scale))
    fires = [i for i in range(1, len(scales)) if scales[i] < scales[i - 1]]
    assert len(fires) >= 1
    if len(fires) > 1:
        assert fires[1] - fires[0] >= sched.cooldown


def test_force_weight_joint_objective():
    """loss = dkl_factor * D_KL + force_weight * mean(F_eff^2) exactly on
    the same batch; the step reports force_sq."""
    cfg = _cfg(SPEC2)
    state = cpu_state(cfg, seed=3)
    z = uniform_link_prior(8, device="cpu").sample_n(
        torch.Generator().manual_seed(4), 8)
    w = 0.5
    loss0, _ = tt.reverse_kl_loss(state.params, SPEC2, z, cfg.beta)
    with torch.enable_grad():
        loss1, aux1 = tt.reverse_kl_loss(state.params, SPEC2, z, cfg.beta,
                                         force_weight=w)
    assert np.isclose(float(loss1.detach()), float(loss0) + w * float(
        aux1["force_sq"].detach()), rtol=1e-5)
    state, metrics = tt.train_step(state, SPEC2, cfg.batch_size, cfg.L,
                                   cfg.beta, 1.0, cfg.base_lr, force_weight=w)
    assert np.isfinite(float(metrics["force_sq"]))
    assert np.isfinite(float(metrics["loss_dkl"]))


def test_force_weight_training_smooths():
    """A large force_weight drives mean(F_eff^2) below the pure-KL run's
    endpoint (same seed and configuration otherwise)."""
    def endpoint_fsq(force_weight):
        cfg = TrainConfig(L=8, beta=2.0, n_era=1, n_epoch=40, batch_size=16,
                          base_lr=3e-3, flow=SPEC2, seed=5,
                          force_weight=force_weight)
        state, _ = tt.train(cfg, device="cpu")
        z = uniform_link_prior(8, device="cpu").sample_n(
            torch.Generator().manual_seed(9), 16)
        f = ft_force(state.params, SPEC2, z, 2.0, device="cpu")
        return float(torch.mean(f * f))

    assert endpoint_fsq(5.0) < endpoint_fsq(0.0)


def test_init_train_state_refuses_mixed_devices():
    cfg = TrainConfig(L=8, flow=SPEC2)
    with pytest.raises(ValueError, match="generator"):
        tt.init_train_state(torch.Generator(), cfg, device="meta")
    params = init_flow_params(SPEC2, torch.Generator().manual_seed(0),
                              device="meta")
    with pytest.raises(ValueError, match="parameters"):
        tt.init_train_state(torch.Generator(), cfg, params=params,
                            device="cpu")
