"""Checkpoints of fthmc_tpu_torch: mirrors of tests/test_checkpoint.py on
the port's .npz layout, resume bit for bit on the CPU, and the meta sidecar
against the JAX package's for the same configurations."""
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from fthmc_tpu import checkpoint as jck
from fthmc_tpu import train as jt
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.config import TrainConfig as JCfg
from fthmc_tpu_torch import train as tt
from fthmc_tpu_torch.checkpoint import (STATE_FILE, find_and_load_checkpoint,
                                        latest_checkpoint, load_checkpoint,
                                        load_checkpoint_auto, load_history,
                                        save_checkpoint)
from fthmc_tpu_torch.config import FlowSpec, SchedulerConfig, TrainConfig
from fthmc_tpu_torch.weights import flow_params_from_numpy

SPEC2 = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,), kernel_size=3)


def _state(spec, seed=0):
    cfg = TrainConfig(L=8, beta=2.0, flow=spec, seed=0)
    return tt.init_train_state(torch.Generator().manual_seed(seed), cfg,
                               device="cpu")


def _trained(spec):
    """A state a step into training (non-zero moments and count)."""
    state = _state(spec)
    state, _ = tt.train_step(state, spec, 4, 8, 2.0, 1.0, 1e-3)
    return state


def _leaves_equal(a, b):
    for x, y in zip(tt.param_leaves(a.params), tt.param_leaves(b.params)):
        assert torch.equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    state = _trained(SPEC2)
    path = save_checkpoint(str(tmp_path), state, era=0, epoch=9,
                           history={"loss": [1.0, 0.5]})
    assert os.path.isdir(path)
    restored, meta = load_checkpoint(path, _state(SPEC2, seed=5))
    assert meta == {"era": 0, "epoch": 9}
    _leaves_equal(state, restored)
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    restored.opt_state.mu + restored.opt_state.nu):
        assert torch.equal(a, b)
    assert int(restored.step) == int(state.step) == 1
    assert int(restored.opt_state.count) == 1
    hist = load_history(path + ".history.npz")
    np.testing.assert_allclose(hist["loss"], [1.0, 0.5])


def test_latest_checkpoint_discovery(tmp_path):
    state = _state(SPEC2)
    save_checkpoint(str(tmp_path), state, era=0, epoch=1)
    time.sleep(0.05)
    p1 = save_checkpoint(str(tmp_path), state, era=1, epoch=1)
    assert latest_checkpoint(str(tmp_path)) == p1
    out = find_and_load_checkpoint(str(tmp_path), _state(SPEC2))
    assert out is not None
    assert out[1]["era"] == 1


def test_find_in_empty_dir(tmp_path):
    assert find_and_load_checkpoint(str(tmp_path), None) is None


def test_self_describing_roundtrip(tmp_path):
    """Saved with its TrainConfig, a checkpoint restores with no template:
    the whole FlowSpec and the optimizer's settings come from the meta."""
    spec = FlowSpec(n_layers=2, coupling="rncp", n_mixture=3,
                    hidden_sizes=(4,), s_clip=2.5)
    cfg = TrainConfig(L=8, beta=3.0, flow=spec, grad_clip=1.0, seed=0)
    state = tt.init_train_state(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    state, _ = tt.train_step(state, spec, 4, 8, 3.0, 1.0, 1e-3, 1.0)
    save_checkpoint(str(tmp_path), state, era=4, epoch=7, train_cfg=cfg)
    out = load_checkpoint_auto(str(tmp_path), device="cpu")
    assert out is not None
    restored, meta, rspec, rcfg = out
    assert rspec == spec and rcfg == cfg
    assert meta["era"] == 4
    _leaves_equal(state, restored)
    assert len(restored.opt_state.mu) == len(state.opt_state.mu)
    assert torch.equal(restored.opt_state.nu[3], state.opt_state.nu[3])
    out2 = load_checkpoint_auto(str(tmp_path), spec_overrides={"s_clip": 1.0},
                                device="cpu")
    assert out2[2].s_clip == 1.0 and out2[2].coupling == "rncp"


def test_auto_restore_bare_dir_and_legacy(tmp_path):
    state = _state(SPEC2)
    p = save_checkpoint(str(tmp_path / "legacy"), state, era=0, epoch=1)
    assert load_checkpoint_auto(p, device="cpu") is None
    cfg = TrainConfig(L=8, beta=2.0, flow=SPEC2, seed=0)
    p2 = save_checkpoint(str(tmp_path / "new"), state, era=1, epoch=1,
                         train_cfg=cfg)
    out = load_checkpoint_auto(p2, device="cpu")
    assert out is not None and out[2] == SPEC2


def test_corrupt_checkpoint_raises(tmp_path):
    """A directory that looks like a checkpoint but does not load raises; a
    directory that does not look like one is 'not found'."""
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "_METADATA").write_text("{}")      # an orbax checkpoint's marker
    with pytest.raises(FileNotFoundError, match="orbax"):
        find_and_load_checkpoint(str(bad), _state(SPEC2))
    torn = tmp_path / "torn"
    torn.mkdir()
    (torn / STATE_FILE).write_bytes(b"not an npz")
    with pytest.raises(Exception):
        find_and_load_checkpoint(str(torn), _state(SPEC2))
    assert find_and_load_checkpoint(str(tmp_path / "plain"), None) is None
    wrong = save_checkpoint(str(tmp_path / "wrong"), _state(SPEC2), era=0,
                            epoch=0)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(wrong, _state(FlowSpec(n_layers=2, n_mixture=3,
                                               hidden_sizes=(4,))))


def test_generator_of_another_device_is_refused(tmp_path):
    path = save_checkpoint(str(tmp_path), _state(SPEC2), era=0, epoch=0)
    f = os.path.join(path, STATE_FILE)
    with np.load(f) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["generator_device"] = np.array("cuda")
    np.savez(f, **arrays)
    with pytest.raises(ValueError, match="cuda"):
        load_checkpoint(path, _state(SPEC2))


def test_resume_is_bit_equal(tmp_path):
    """Two eras straight through, and one era + save + load + one era,
    give bit-equal parameters, moments and scheduler state on the CPU; the
    resumed run continues the era numbering, the step count and the beta
    schedule."""
    cfg = TrainConfig(L=8, beta=2.5, beta_init=1.5, beta_anneal_frac=0.75,
                      n_era=2, n_epoch=3, batch_size=4, flow=SPEC2, seed=3,
                      grad_clip=0.5)
    sched = SchedulerConfig(patience=1)
    eras = []
    full, hist = tt.train(cfg, scheduler=sched,
                          checkpoint_fn=lambda e, s, h: eras.append(e),
                          device="cpu")
    assert eras == [0, 1]

    class Interrupted(Exception):
        pass

    def save_and_stop(era, st, h):
        save_checkpoint(str(tmp_path), st, era=era, epoch=cfg.n_epoch,
                        history=h, train_cfg=cfg)
        raise Interrupted

    with pytest.raises(Interrupted):
        tt.train(cfg, scheduler=sched, checkpoint_fn=save_and_stop,
                 device="cpu")
    state, meta, _, rcfg = load_checkpoint_auto(str(tmp_path), device="cpu")
    assert rcfg == cfg and meta["era"] == 0
    resumed, hist2 = tt.train(rcfg, state, scheduler=sched,
                              start_era=meta["era"] + 1,
                              checkpoint_fn=lambda e, s, h: eras.append(e))
    assert eras == [0, 1, 1]
    assert int(resumed.step) == int(full.step) == 6
    _leaves_equal(full, resumed)
    for a, b in zip(full.opt_state.mu + full.opt_state.nu,
                    resumed.opt_state.mu + resumed.opt_state.nu):
        assert torch.equal(a, b)
    for k in ("lr_scale", "best_loss", "plateau_count"):
        assert torch.equal(getattr(full, k), getattr(resumed, k))
    np.testing.assert_array_equal(hist2["beta"], hist["beta"][3:])
    np.testing.assert_array_equal(hist2["loss_dkl"], hist["loss_dkl"][3:])
    np.testing.assert_array_equal(
        hist2["beta"], tt.anneal_betas(cfg, 1, device="cpu").numpy())


def test_meta_equals_the_jax_packages(tmp_path):
    """The .meta.json of the same configurations is the JAX package's, key
    for key and value for value."""
    kw = dict(n_layers=2, coupling="rncp", n_mixture=2, hidden_sizes=(4,),
              s_clip=3.0)
    tkw = dict(L=8, beta=3.0, beta_init=2.0, beta_anneal_frac=0.5,
               grad_clip=1.0, force_weight=0.5, n_era=3, seed=7)
    jcfg = JCfg(flow=JSpec(**kw), **tkw)
    js = jt.init_train_state(jax.random.PRNGKey(0), jcfg)
    jpath = jck.save_checkpoint(str(tmp_path / "jax"), js, era=2, epoch=5,
                                train_cfg=jcfg)
    cfg = TrainConfig(flow=FlowSpec(**kw), **tkw)
    tpath = save_checkpoint(str(tmp_path / "port"), tt.init_train_state(
        torch.Generator().manual_seed(0), cfg, device="cpu"), era=2,
        epoch=5, train_cfg=cfg)
    assert os.path.basename(tpath) == os.path.basename(jpath)
    with open(jpath + ".meta.json") as f:
        jmeta = json.load(f)
    with open(tpath + ".meta.json") as f:
        tmeta = json.load(f)
    assert tmeta == jmeta
    # and the JAX package's meta reads back into the port's configs
    assert jck.spec_from_meta(tmeta) == JSpec(**kw)


def test_state_npz_reads_as_a_flow(tmp_path):
    """The parameters in state.npz carry weights.save_flow_npz's names, so
    flow_params_from_numpy rebuilds the flow from them."""
    state = _trained(SPEC2)
    path = save_checkpoint(str(tmp_path), state, era=0, epoch=0)
    with np.load(os.path.join(path, STATE_FILE)) as data:
        tree = [[{leaf: data[f"l{i:02d}_c{j}_{leaf}"] for leaf in ("w", "b")}
                 for j in range(2)] for i in range(2)]
    params = flow_params_from_numpy(tree, SPEC2, device="cpu")
    for a, b in zip(tt.param_leaves(params), tt.param_leaves(state.params)):
        assert torch.equal(a, b)
