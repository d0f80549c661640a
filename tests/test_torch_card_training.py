"""Flow training and flow sampling on the card at their production widths:
the reference configuration trained through train() then sampled, the
flagship's training configuration across a checkpoint, D_KL of an exported
flow against the JAX package's reading, flow sampling with the exported
16-layer flow, a fermion-aware era and a spline flow.

Marked ``cuda``: each test skips without a card. Imports only torch, numpy
and the port (tests/test_torch_cuda.py gives the command)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import sampling as tsample
from fthmc_tpu_torch import train as ttrain
from fthmc_tpu_torch.config import FlowSpec, TrainConfig
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.weights import load_flow_npz
from test_torch_cuda import card  # noqa: F401

pytestmark = pytest.mark.cuda

# The reference configuration (fthmc_tpu/bench.py bench_train's flow: ncp,
# 16 layers, hidden (8, 8), 2 components; 8^2, beta=2, batch 64, lr 1e-3,
# TrainConfig's 10 eras of 100 epochs), then flow sampling with 64 chains:
# the JAX package read an acceptance of 0.202 after the same training, the
# reference code 0.21-0.25 (BENCH.md:1459).
REF_TRAIN = TrainConfig(L=8, beta=2.0, batch_size=64, base_lr=1e-3,
                        flow=FlowSpec(n_layers=16, n_mixture=2,
                                      hidden_sizes=(8, 8)))
MIN_TRAINED_ACCEPTANCE = 0.15
# The flagship flow's training settings (artifacts/flow8x8_b3_rncp24_ftb6
# .meta.json: 8^2, batch 512, lr 1e-3, grad_clip 1, beta annealed 2 -> 3
# over half of the steps), cut to 2 eras of 100 epochs.
FLAGSHIP_TRAIN = TrainConfig(
    L=8, beta=3.0, beta_init=2.0, beta_anneal_frac=0.5, n_era=2,
    n_epoch=100, batch_size=512, base_lr=1e-3, grad_clip=1.0, seed=7,
    flow=FlowSpec(n_layers=24, coupling="rncp", n_mixture=8,
                  hidden_sizes=(32, 32), s_clip=3.0))
# The JAX package's readings on a CPU (tests/test_torch_sampling.py,
# jax_reference_readings): D_KL = mean(logq - logp) of flow8x8_b3_rncp24
# at 8^2, beta=3 over 8192 draws, and flow sampling with
# flow8x8_b2_16l_long at 8^2, beta=2, 64 chains x 4096 samples, blocks of
# 64.
JAX_DKL_RNCP24 = (-335.28973388671875, 0.020102684869653945)  # mean, stderr
DKL_DRAWS = 8192
JAX_SAMPLING_ACC, SAMPLING_ACC_MARGIN = 0.25147247314453125, 0.02
SAMPLING = dict(beta=2.0, L=8, batch_size=64, num_samples=4096, n_chains=64)
# Splines: the reference training configuration with the spline coupling,
# 8 knots, s_clip 3, cut to 2 eras of 100 epochs; flow sampling with
# (chains, samples a chain)
SPLINE_TRAIN = dataclasses.replace(
    REF_TRAIN, n_era=2, flow=FlowSpec(n_layers=16, coupling="spline",
                                      n_knots=8, hidden_sizes=(8, 8),
                                      s_clip=3.0))
SPLINE_ENSEMBLE = (64, 1024)


def _count_syncs(run):
    """(run()'s value, the host synchronisations CUDA's sync debug mode
    warns of while it runs)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            value = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return value, sum("synchroniz" in str(w.message) for w in seen)


def test_reference_training_then_flow_sampling(card):
    """REF_TRAIN through train() on the card, then generate_ensemble with
    64 chains: the loss finite and the last 100 epochs' mean below the
    first 100's; flow-sampling acceptance >= MIN_TRAINED_ACCEPTANCE."""
    cfg = REF_TRAIN
    state, hist = ttrain.train(cfg, device=card)
    loss = np.asarray(hist["loss_dkl"], dtype=np.float64)
    assert np.isfinite(loss).all()
    first, last = float(loss[:100].mean()), float(loss[-100:].mean())
    assert last < first, (first, last)
    ens = tsample.generate_ensemble(
        state.params, cfg.flow, beta=cfg.beta, L=cfg.L, n_chains=64,
        generator=torch.Generator(card).manual_seed(5), device=card)
    assert ens["accept_rate"] >= MIN_TRAINED_ACCEPTANCE, ens["accept_rate"]


def test_flagship_training_resumes_from_its_checkpoint(card, tmp_path):
    """FLAGSHIP_TRAIN from fresh weights: era 0 through train_era,
    save_checkpoint, load_checkpoint_auto (the configuration and the
    parameters restored), then era 1 through train(start_era=1): losses
    finite, the step count and the beta schedule continue the first
    era's."""
    from fthmc_tpu_torch.checkpoint import (load_checkpoint_auto,
                                            save_checkpoint)
    cfg = FLAGSHIP_TRAIN
    state = ttrain.init_train_state(None, cfg, device=card)
    betas0 = ttrain.anneal_betas(cfg, 0, device=card)
    state, h0 = ttrain.train_era(
        state, cfg.flow, cfg.batch_size, cfg.L, cfg.beta, cfg.dkl_factor,
        cfg.base_lr, cfg.n_epoch, betas=betas0, grad_clip=cfg.grad_clip)
    save_checkpoint(str(tmp_path), state, era=0, epoch=cfg.n_epoch,
                    history=h0, train_cfg=cfg)
    state1, meta, spec, rcfg = load_checkpoint_auto(str(tmp_path),
                                                    device=card)
    assert rcfg == cfg and spec == cfg.flow and meta["era"] == 0
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.param_leaves(state.params), ttrain.param_leaves(
            state1.params)))
    state2, h1 = ttrain.train(rcfg, state1, start_era=meta["era"] + 1)
    loss = np.concatenate([h0["loss_dkl"], np.asarray(h1["loss_dkl"])])
    assert np.isfinite(loss).all()
    assert int(state2.step) == cfg.n_era * cfg.n_epoch
    want = ttrain.anneal_betas(cfg, 1, device="cpu").numpy()
    assert np.array_equal(np.asarray(h1["beta"]), want)
    assert float(h0["beta"][-1]) < float(want[0])


def test_dkl_of_the_exported_flow_is_the_jax_packages(card):
    """D_KL = mean(logq - logp) of flow8x8_b3_rncp24 at 8^2, beta=3 over
    DKL_DRAWS prior draws through K6, within 5 standard errors (the two
    runs' combined) of the JAX package's CPU reading."""
    from fthmc_tpu_torch.models import priors
    params, spec = load_flow_npz(device=card, name="flow8x8_b3_rncp24")
    prior = priors.uniform_link_prior(8, device=card)
    g = torch.Generator(card).manual_seed(11)
    d = []
    for _ in range(DKL_DRAWS // 1024):
        _, logq, logp, _ = tsample.propose(params, spec,
                                           prior.sample_n(g, 1024), 3.0)
        d.append((logq - logp).double())
    d = torch.cat(d)
    mean, se = float(d.mean()), float(d.std() / math.sqrt(d.numel()))
    jm, jse = JAX_DKL_RNCP24
    assert abs(mean - jm) <= 5 * math.hypot(se, jse), (mean, se)


def test_flow_sampling_with_the_exported_16_layer_flow(card):
    """Flow sampling with flow8x8_b2_16l_long (SAMPLING) through
    make_mcmc_ensemble, the counters set to 0 just before and read just
    after: K6 launched exactly once a layer a block (the initial proposals
    one block) and nothing else, no plain twin, the history finite, the
    acceptance within SAMPLING_ACC_MARGIN of the JAX package's CPU
    reading."""
    params, spec = load_flow_npz(device=card, name="flow8x8_b2_16l_long")
    cfg = SAMPLING
    nblocks = -(-(cfg["num_samples"] - 1) // cfg["batch_size"])
    gen = torch.Generator(card).manual_seed(17)
    tsample.make_mcmc_ensemble(params, spec, generator=gen,
                               **{**cfg, "num_samples": 65}, device=card)
    torch.cuda.synchronize()
    _build.reset_counts()
    hist = tsample.make_mcmc_ensemble(params, spec, generator=gen, **cfg,
                                      device=card)
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    expect = {**dict.fromkeys(_build.KERNELS, 0),
              "K6": spec.n_layers * (nblocks + 1)}
    assert launches == expect and not any(plain.values()), (launches, plain)
    assert all(np.isfinite(v).all() for v in hist.values())
    acc = float(hist["acc"].mean())
    assert abs(acc - JAX_SAMPLING_ACC) <= SAMPLING_ACC_MARGIN, acc


def test_ferm_mass_era_at_the_reference_width(card):
    """Fermion-aware training (ferm_mass = 0.1, force_weight = 0.5) with
    the reference flow at 8^2, beta=2, batch 64: an era of 10 epochs
    through train_era (graphed or eager, as FERM_ERA_GRAPHED says), its
    metrics finite. (One step's loss and gradients against the CPU:
    tests/test_torch_cuda.py, the 'ferm' case.)"""
    cfg = dataclasses.replace(REF_TRAIN, force_weight=0.5, ferm_mass=0.1)
    state = ttrain.init_train_state(None, cfg, device=card)
    _, hist = ttrain.train_era(state, cfg.flow, cfg.batch_size, cfg.L,
                               cfg.beta, cfg.dkl_factor, cfg.base_lr, 10,
                               force_weight=0.5, ferm_mass=0.1)
    assert all(np.isfinite(v).all() for v in hist.values())


def test_spline_flow_trains_and_samples(card):
    """SPLINE_TRAIN through train() on the card (its CUDA graph): the loss
    finite and falling from the first 100 epochs to the last 100, one host
    synchronisation an era, no K6-K8 launch; flow sampling: 'auto' (K6)
    refuses the spec, flow_backend='torch' samples SPLINE_ENSEMBLE chains x
    samples, logq finite, no K6-K8 launch. (One step's loss and gradients
    against the CPU: tests/test_torch_cuda.py, the 'spline' case.)"""
    cfg = SPLINE_TRAIN
    _build.reset_counts()
    (state, hist), syncs = _count_syncs(lambda: ttrain.train(cfg,
                                                             device=card))
    loss = np.asarray(hist["loss_dkl"], dtype=np.float64)
    first, last = float(loss[:100].mean()), float(loss[-100:].mean())
    assert np.isfinite(loss).all() and last < first, (first, last)
    assert syncs == cfg.n_era, syncs
    n_chains, num = SPLINE_ENSEMBLE
    kw = dict(beta=cfg.beta, L=cfg.L, batch_size=cfg.batch_size,
              num_samples=num, n_chains=n_chains, device=card)
    with pytest.raises(ValueError):
        tsample.make_mcmc_ensemble(state.params, cfg.flow,
                                   generator=torch.Generator(card), **kw)
    ens = tsample.make_mcmc_ensemble(
        state.params, cfg.flow, generator=torch.Generator(card).manual_seed(
            98), flow_backend="torch", **kw)
    assert np.isfinite(ens["logq"]).all()
    assert not any(_build.LAUNCHES[k] for k in ("K6", "K7", "K8")), \
        dict(_build.LAUNCHES)
