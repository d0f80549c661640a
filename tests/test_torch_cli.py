"""The port's command line (fthmc_tpu_torch.cli) against the JAX one
(fthmc_tpu.cli), on the CPU: every run passes ``--device cpu``.

Held exactly against fthmc_tpu: every subcommand's options (their flags,
dests, defaults, choices, nargs and types) but the deliberate differences
(``--device``, and ``--cg-backend``'s choices and default); the flow-spec
layering (``_cli_spec_overrides`` / ``_flow_spec``) and the JSON helpers
(``make_configs`` / ``load_json_configs``, ``configs/example.json``
included), compared by ``dataclasses.asdict``. ``_summarize_hmc`` on one
float64 numpy history: within 1e-12 relative. Then mirrors of
tests/test_cli.py and tiny runs of every subcommand, several of them held
to the library calls they wrap on the same seed (bit for bit, or 1e-6
relative where the runs are on other ranks), and the parallel flags on two
gloo ranks (``parallel.launch.spawn``).
This module imports no JAX at its top: the ranks import it.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import cli
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.checkpoint import load_checkpoint_auto, save_checkpoint
from fthmc_tpu_torch.config import (FlowSpec, HMCConfig, LeapfrogConfig,
                                    TrainConfig, config_to_dict,
                                    load_json_configs, make_configs,
                                    with_updates)
from fthmc_tpu_torch.models.flow import flow_reverse
from fthmc_tpu_torch.parallel.launch import spawn
from fthmc_tpu_torch.weights import DATA_DIR, load_flow_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ("hmc", "train", "sample", "fthmc", "schwinger", "pipeline",
               "bench", "queue")
CPU = ["--device", "cpu"]
SCHW = ["schwinger", *CPU, "--L", "4", "--beta", "2.0", "--mass", "0.4",
        "--chains", "2", "--nstep", "4", "--block", "4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the ranks run one too): the suite runs in
    several worker processes that share the cores, and OpenMP's parallel
    regions on these small tensors stall when the workers' threads
    outnumber them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _subparsers(parser):
    return parser._subparsers._group_actions[0].choices


def _options(parser) -> dict:
    """{dest: (flags, default, choices, nargs, type, const)} of a parser's
    options, help left out."""
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.nargs,
                     a.type, a.const)
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


# ---------------------------------------------------------------- parsers

@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_parser_matches_jax(sub):
    """Every option of every subcommand as the JAX CLI has it, but for the
    listed differences: --device (the port's), and --cg-backend, whose
    choices add 'auto', its default."""
    from fthmc_tpu.cli import build_parser as jax_parser
    jax_opts = _options(_subparsers(jax_parser())[sub])
    opts = _options(_subparsers(cli.build_parser())[sub])
    if sub != "queue":
        assert opts.pop("device") == (("--device",), None, None, None, str,
                                      None)
    if sub == "schwinger":
        flags, default, choices, *rest = opts.pop("cg_backend")
        jflags, jdefault, jchoices, *jrest = jax_opts.pop("cg_backend")
        assert (flags, rest) == (jflags, jrest)
        assert jdefault == "xla" and default == "auto"
        assert choices == ("auto", *jchoices)
    assert opts == jax_opts
    assert set(_subparsers(cli.build_parser())) == set(SUBCOMMANDS)


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_help_of_every_subcommand(sub, capsys):
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args([sub, "--help"])
    assert e.value.code == 0
    assert f"usage: fthmc_tpu_torch {sub}" in capsys.readouterr().out


def test_parser_subcommands():
    p = cli.build_parser()
    a = p.parse_args(["hmc", "--beta", "3.0", "--L", "16", "--ntraj", "10"])
    assert a.beta == 3.0 and a.L == 16 and a.ntraj == 10
    assert a.device is None          # the card unless --device says else
    a = p.parse_args(["train", "--n-layers", "8", "--hidden", "4", "4"])
    assert a.n_layers == 8 and a.hidden == [4, 4]
    a = p.parse_args(["fthmc", "--nstep", "32", "--device", "cpu"])
    assert a.nstep == 32 and a.device == "cpu"
    a = p.parse_args(["pipeline", "--transfer-epochs", "0"])
    assert a.transfer_epochs == 0
    a = p.parse_args(["bench", "--which", "all"])
    assert a.which == "all"


def test_parser_restore_mode_flow_flags_default_none():
    """sample/fthmc/pipeline default flow flags to None so a
    self-describing --ckpt's stored spec wins; train keeps real defaults."""
    p = cli.build_parser()
    a = p.parse_args(["fthmc", "--ckpt", "x"])
    assert a.n_layers is None and a.hidden is None and a.coupling is None
    a = p.parse_args(["fthmc", "--coupling", "rncp"])
    assert a.coupling == "rncp"
    a = p.parse_args(["train"])
    assert a.n_layers == 24 and a.coupling == "ncp"
    a = p.parse_args(["pipeline", "--mode", "highbeta", "--beta", "6"])
    assert a.mode == "highbeta" and a.flow_beta == 3.0


def test_parser_schwinger():
    p = cli.build_parser()
    a = p.parse_args(["schwinger", "--beta", "4.0", "--mass", "0.2",
                      "--nstep", "12", "--cg-backend", "mixed"])
    assert a.beta == 4.0 and a.mass == 0.2 and a.nstep == 12
    assert a.integrator == "omelyan" and not a.no_warm_start
    assert a.cg_backend == "mixed"
    assert p.parse_args(["schwinger"]).cg_backend == "auto"


# ------------------------------------------------------ specs and configs

SPEC_CASES = {
    "restore-rncp-clear-clip": dict(
        n_layers=None, n_mixture=None, hidden=None, kernel=None,
        activation=None, coupling="rncp", n_knots=None, s_clip=-1.0,
        conv_dtype=None),
    "all-set": dict(n_layers=4, n_mixture=3, hidden=[6, 6], kernel=3,
                    activation="tanh", coupling="spline", n_knots=5,
                    s_clip=2.5, conv_dtype="bfloat16"),
    "none-set": dict(n_layers=None, n_mixture=None, hidden=None,
                     kernel=None, activation=None, coupling=None,
                     n_knots=None, s_clip=None, conv_dtype=None),
}


@pytest.mark.parametrize("case", SPEC_CASES)
def test_spec_layering_matches_jax(case):
    from fthmc_tpu import cli as jcli
    from fthmc_tpu.config import FlowSpec as JSpec
    ns = argparse.Namespace(**SPEC_CASES[case])
    assert cli._cli_spec_overrides(ns) == jcli._cli_spec_overrides(ns)
    base = dict(n_layers=24, coupling="ncp", s_clip=3.0)
    for tb, jb in ((None, None), (FlowSpec(**base), JSpec(**base))):
        assert (dataclasses.asdict(cli._flow_spec(ns, tb))
                == dataclasses.asdict(jcli._flow_spec(ns, jb)))
    assert (cli._spec_to_args(cli._flow_spec(ns))
            == jcli._spec_to_args(jcli._flow_spec(ns)))


def test_cli_spec_overrides_layering():
    ns = argparse.Namespace(**SPEC_CASES["restore-rncp-clear-clip"])
    ov = cli._cli_spec_overrides(ns)
    assert ov == {"coupling": "rncp", "s_clip": None}
    base = FlowSpec(n_layers=24, coupling="ncp", s_clip=3.0)
    spec = cli._flow_spec(ns, base)
    assert spec.coupling == "rncp" and spec.s_clip is None  # -1 clears
    assert spec.n_layers == 24                              # base preserved


def _same_configs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert type(g).__name__ == type(w).__name__
            assert dataclasses.asdict(g) == dataclasses.asdict(w)


RAW = {
    "L": 16, "beta": 3.0,
    "hmc": {"tau": 1.0, "nstep": 20, "ntraj": 64},
    "train": {"n_era": 2, "n_epoch": 5, "n_layers": 8,
              "n_s_nets": 3, "activation_fn": "relu",
              "hidden_sizes": [4, 4]},
    "fthmc": {"tau": 0.5, "nstep": 16},
    "scheduler": {"factor": 0.7, "patience": 3},
}


def test_json_config_roundtrip(tmp_path):
    from fthmc_tpu.config import load_json_configs as jax_load
    path = os.path.join(str(tmp_path), "c.json")
    with open(path, "w") as f:
        json.dump(RAW, f)
    hmc, train, lf, sched = load_json_configs(path)
    assert hmc.L == 16 and hmc.beta == 3.0 and hmc.nstep == 20
    assert train.n_era == 2 and train.flow.n_layers == 8
    assert train.flow.n_mixture == 3         # reference spelling n_s_nets
    assert train.flow.activation == "relu"   # reference spelling activation_fn
    assert lf.tau == 0.5 and lf.nstep == 16
    assert sched.factor == 0.7 and sched.patience == 3
    _same_configs((hmc, train, lf, sched), jax_load(path))


def test_repo_example_config():
    from fthmc_tpu.config import load_json_configs as jax_load
    path = os.path.join(ROOT, "configs", "example.json")
    hmc, train, lf, sched = load_json_configs(path)
    assert hmc.ntraj == 1024
    assert train.flow == FlowSpec(n_layers=16, n_mixture=2,
                                  hidden_sizes=(8, 8), kernel_size=3,
                                  activation="silu")
    assert lf.nstep == 64 and sched is not None
    _same_configs((hmc, train, lf, sched), jax_load(path))


@pytest.mark.parametrize("raw", [
    {"L": 4, "beta": 1.5, "tau": 3.0},
    {"n_s_nets": 4, "activation_fn": "tanh", "seed": 9, "nstep": 7},
    {"train": {"flow": {"n_layers": 2}, "batch_size": 8}, "hmc": {},
     "scheduler": {}},
])
def test_flat_config_routing_matches_jax(raw):
    from fthmc_tpu.config import make_configs as jax_make
    _same_configs(make_configs(raw), jax_make(raw))


def test_flat_config_routing():
    hmc, train, lf, _ = make_configs({"L": 4, "beta": 1.5, "tau": 3.0})
    assert hmc.L == train.L == 4
    assert hmc.beta == train.beta == 1.5
    assert lf.tau == 3.0


def test_config_helpers_match_jax():
    from fthmc_tpu import config as jc
    cfg = TrainConfig(L=4, flow=FlowSpec(n_layers=3, hidden_sizes=[5]))
    jcfg = jc.TrainConfig(L=4, flow=jc.FlowSpec(n_layers=3,
                                                hidden_sizes=[5]))
    assert config_to_dict(cfg) == jc.config_to_dict(jcfg)
    assert (config_to_dict(with_updates(cfg, beta=3.5, n_era=2))
            == jc.config_to_dict(jc.with_updates(jcfg, beta=3.5, n_era=2)))
    import fthmc_tpu
    import fthmc_tpu_torch
    assert fthmc_tpu_torch.__all__ == fthmc_tpu.__all__


# ------------------------------------------------------------- summaries

def _history(flagged: bool):
    rng = np.random.default_rng(3 if flagged else 4)
    n, B = 64, 8
    plaq = 0.69777 + 0.01 * rng.standard_normal((n, B))
    if flagged:        # a drift, a wrong plaquette and a bad <exp(-dH)>
        plaq += np.linspace(0.0, 0.2, n)[:, None]
    dh = 0.3 * rng.standard_normal((n, B)) + (1.5 if flagged else 0.0)
    q = np.cumsum(rng.integers(-1, 2, (n, B)), axis=0).astype(np.float64)
    return dict(dh=dh, exp_mdh=np.exp(-dh),
                acc=(rng.random((n, B)) < 0.8).astype(np.float64),
                plaq=plaq, q=q, dq=np.abs(np.diff(q, axis=0, prepend=0.0)))


@pytest.mark.parametrize("flagged", [False, True])
def test_summarize_hmc_matches_jax(flagged):
    from fthmc_tpu import cli as jcli
    from fthmc_tpu.hmc import TrajMetrics as JTM
    h = _history(flagged)
    got = cli._summarize_hmc(th.TrajMetrics(**h), plaq_ref=0.69777)
    want = jcli._summarize_hmc(JTM(**h), plaq_ref=0.69777)
    assert got.keys() == want.keys()
    assert got.pop("sanity_flags", None) == want.pop("sanity_flags", None)
    np.testing.assert_allclose([got[k] for k in want],
                               [want[k] for k in want], rtol=1e-12, atol=0)
    assert ("sanity_flags" in cli._summarize_hmc(th.TrajMetrics(**h),
                                                 plaq_ref=0.69777)) == flagged


# ------------------------------------------------------------- tiny runs

def test_cli_hmc_nrun_is_run_hmc_nrun(tmp_path):
    out = cli.main(["hmc", *CPU, "--L", "4", "--ntraj", "8", "--chains",
                    "2", "--nrun", "2", "--tau", "0.5", "--nstep", "4",
                    "--outdir", str(tmp_path)])
    cfg = HMCConfig(beta=2.0, L=4, tau=0.5, nstep=4, ntraj=8, n_chains=2,
                    seed=1331, nrun=2, randinit=True)
    _, runs = th.run_hmc_nrun(cfg, device="cpu")
    assert out["acc"] == pytest.approx(float(runs.acc[:, 2:].mean()),
                                       rel=1e-6)
    assert out["plaq"] == pytest.approx(float(runs.plaq[:, 2:].mean()),
                                        rel=1e-6)
    assert out["plaq_err"] > 0 and out["exact_plaq"] == tl.PLAQ_EXACT[2.0]
    with np.load(tmp_path / "hmc_history.npz") as h:
        assert h["plaq"].shape == (8, 4)       # the runs fold into chains
    with np.load(tmp_path / "hmc_fields.npz") as f:
        assert f["x"].shape == (2, 2, 4, 4)


def test_cli_train_sample_fthmc_from_port_checkpoint(tmp_path):
    """train -> sample -> fthmc, the flow restored from the port's
    self-describing checkpoint; sample and fthmc are the library calls on
    the same seed."""
    tr = cli.main(["train", *CPU, "--L", "4", "--n-layers", "2", "--hidden",
                   "4", "--n-era", "1", "--n-epoch", "4", "--batch-size",
                   "4", "--outdir", str(tmp_path)])
    assert np.isfinite(tr["loss_dkl"]) and tr["outdir"] == str(tmp_path)
    for f in ("train_history.npz", "train_metrics.jsonl"):
        assert (tmp_path / f).exists()
    ck = str(tmp_path / "checkpoints")
    state, meta, spec, _ = load_checkpoint_auto(ck, device="cpu")
    assert meta["era"] == 0 and spec.n_layers == 2
    assert all(torch.equal(a["w"], b["w"]) for na, nb in zip(
        state.params, tr["state"].params) for a, b in zip(na, nb))

    out = cli.main(["sample", *CPU, "--L", "4", "--ckpt", ck,
                    "--ensemble-size", "16", "--batch-size", "4",
                    "--sample-chains", "2", "--seed", "5"])
    from fthmc_tpu_torch.sampling import generate_ensemble
    ref = generate_ensemble(state.params, spec, beta=2.0, L=4,
                            ensemble_size=16, batch_size=4, n_chains=2,
                            generator=torch.Generator().manual_seed(5),
                            device="cpu")
    assert out["accept_rate"] == ref["accept_rate"]
    np.testing.assert_array_equal(out["history"]["q"], ref["history"]["q"])

    out = cli.main(["fthmc", *CPU, "--L", "4", "--ckpt", ck, "--ntraj", "4",
                    "--nstep", "2", "--tau", "0.2", "--chains", "2",
                    "--seed", "6"])
    gen = torch.Generator().manual_seed(6)
    z0 = tl.hot_start(gen, 2, 4, device="cpu")
    _, hist = th.run_fthmc_chunked(
        state.params, spec, LeapfrogConfig(0.2, 2), beta=2.0, ntraj=4,
        z0=z0, generator=gen, device="cpu")
    assert out["acc"] == pytest.approx(float(hist.acc[1:].mean()), rel=1e-6)
    assert out["plaq"] == pytest.approx(float(hist.plaq[1:].mean()),
                                        rel=1e-6)


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_cli_fthmc_exported_npz(backend, tmp_path):
    """--ckpt takes an exported flow .npz; a cold start is z0 = f^-1(0);
    --force-backend's JAX names map onto the port's (on the CPU 'auto' is
    autograd, 'pallas' the kernel chain's plain twins)."""
    npz = str(DATA_DIR / "flow8x8_b2_16l.npz")
    argv = ["fthmc", *CPU, "--L", "4", "--ckpt", npz, "--ntraj", "2",
            "--nstep", "2", "--tau", "0.1", "--chains", "2", "--start",
            "cold", "--integrator", "omelyan", "--force-backend", backend,
            "--outdir", str(tmp_path)]
    out = cli.main(argv)
    params, spec = load_flow_npz(npz, device="cpu")
    z0, _ = flow_reverse(params, torch.zeros((2, 2, 4, 4)), spec)
    z, hist = th.run_fthmc_chunked(
        params, spec, LeapfrogConfig(0.1, 2), beta=2.0, ntraj=2, z0=z0,
        generator=torch.Generator().manual_seed(1331),
        integrator="omelyan", device="cpu",
        force_backend=cli.FORCE_BACKENDS[backend])
    assert out["acc"] == pytest.approx(float(hist.acc.mean()), rel=1e-6)
    assert out["exp_mdh"] == pytest.approx(float(hist.exp_mdh.mean()),
                                           rel=1e-6)
    with np.load(tmp_path / "fthmc_fields.npz") as f:
        np.testing.assert_allclose(f["z"], z.numpy(), rtol=0, atol=1e-6)
    assert cli.FORCE_BACKENDS == {"auto": "auto", "xla": "autograd",
                                  "pallas": "kernel"}


def test_sample_route_by_spec():
    assert cli.sample_route(FlowSpec()) == "auto"
    assert cli.sample_route(FlowSpec(coupling="rncp")) == "auto"
    assert cli.sample_route(FlowSpec(coupling="spline")) == "torch"
    assert cli.sample_route(FlowSpec(conv_dtype="bfloat16")) == "torch"


def test_orbax_ckpt_and_parallel_flags_refused(tmp_path):
    """An orbax checkpoint raises SystemExit naming the export; the
    parallel flags without a process group name torchrun."""
    orbax = tmp_path / "flow_orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(SystemExit, match="save_flow_npz"):
        cli.main(["fthmc", *CPU, "--ckpt", str(orbax), "--ntraj", "1"])
    with pytest.raises(SystemExit, match="orbax"):
        cli.main(["pipeline", *CPU, "--mode", "highbeta", "--ckpt",
                  str(orbax)])
    for flag in ("--devices", "--shard-rows"):
        with pytest.raises(SystemExit, match="torchrun"):
            cli.main(["hmc", *CPU, "--L", "4", "--ntraj", "1", flag, "2"])


def test_cli_schwinger_smoke(tmp_path):
    """Plain dynamical HMC end-to-end through the CLI on CPU (tiny), with
    the condensate; the process-wide CG backend is left as it was."""
    from fthmc_tpu_torch import fermion
    before = fermion._CG_BACKEND
    out = cli.main(SCHW + ["--ntraj", "4", "--condensate", "--cg-backend",
                           "mixed", "--outdir", str(tmp_path)])
    assert fermion._CG_BACKEND == before
    assert 0.0 <= out["acc"] <= 1.0
    assert abs(out["exp_mdh"] - 1.0) < 0.5
    assert np.isfinite(out["psibar_psi"]) and out["psibar_psi_err"] > 0
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "schwinger_history.npz"))


def test_cli_schwinger_state_resume(tmp_path):
    """--state runs through the resilient runner and a re-invocation
    resumes at the persisted block instead of restarting."""
    sp = str(tmp_path / "run_state.npz")
    argv = SCHW + ["--state", sp]
    cli.main(argv + ["--ntraj", "4"])
    with np.load(sp) as data:
        assert int(data["done"]) == 4
        first = {k: data[k] for k in ("acc", "plaq", "dh")}
    out = cli.main(argv + ["--ntraj", "8", "--outdir", str(tmp_path)])
    with np.load(sp) as data:
        assert int(data["done"]) == 8
        assert data["acc"].shape == (8, 2)
        for k, v in first.items():
            np.testing.assert_array_equal(data[k][:4], v)
    assert 0.0 <= out["acc"] <= 1.0
    # --state + --devices is an explicit error, not a silent pick
    with pytest.raises(SystemExit, match="pick one"):
        cli.main(argv + ["--ntraj", "4", "--devices", "2"])
    with pytest.raises(SystemExit, match="shard-rows"):
        cli.main(argv + ["--ntraj", "4", "--shard-rows", "2"])


def test_cli_schwinger_state_ft(tmp_path):
    """FT-HMC --state path (self-describing tiny checkpoint)."""
    from fthmc_tpu_torch.train import init_train_state
    spec = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,))
    cfg = TrainConfig(L=4, beta=2.0, flow=spec)
    st = init_train_state(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, st, era=0, epoch=0, spec=spec)
    sp = str(tmp_path / "ft_state.npz")
    out = cli.main(SCHW + ["--ntraj", "4", "--block", "2", "--state", sp,
                           "--ckpt", ck])
    with np.load(sp) as data:
        assert int(data["done"]) == 4
    assert abs(out["exp_mdh"] - 1.0) < 0.5
    with pytest.raises(SystemExit, match="hasenbusch"):
        cli.main(SCHW + ["--ntraj", "1", "--ckpt", ck, "--hasenbusch-dm",
                         "0.2"])


def test_pipeline_reference_smoke(tmp_path):
    """The reference pipeline at L=4 (and its 2L transfer at 8)."""
    out = cli.main(["pipeline", *CPU, "--L", "4", "--ntraj", "4", "--chains",
                    "2", "--n-era", "1", "--n-epoch", "2", "--n-layers", "2",
                    "--hidden", "4", "--ensemble-size", "8",
                    "--transfer-epochs", "1", "--nstep", "2",
                    "--outdir", str(tmp_path)])
    assert set(out) == {"hmc", "sample", "fthmc", "hmc_2L", "sample_2L",
                        "fthmc_transfer"}
    assert 0.0 <= out["sample_2L"]["accept_rate"] <= 1.0
    with open(tmp_path / "pipeline_results.json") as f:
        assert set(json.load(f)) == set(out)


def test_pipeline_highbeta_smoke(tmp_path):
    """--mode highbeta end-to-end on CPU with a toy flow: train -> FT-HMC
    at the target beta -> plain baseline -> head-to-head stats."""
    out = cli.main(["pipeline", *CPU, "--mode", "highbeta", "--L", "8",
                    "--beta", "2.0", "--flow-beta", "2.0", "--flow-L", "8",
                    "--n-layers", "2", "--hidden", "4", "--n-mixture", "2",
                    "--train-steps", "4", "--flow-batch", "4",
                    "--ntraj", "8", "--ft-nstep", "4", "--ft-chains", "2",
                    "--plain-ntraj", "16", "--plain-nstep", "4",
                    "--plain-chains", "2", "--start", "hot",
                    "--outdir", str(tmp_path)])
    assert "fthmc" in out and "hmc" in out and "train" in out
    assert 0.0 <= out["fthmc"]["acc"] <= 1.0
    assert "tau_int_q_err" in out["hmc"]
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "pipeline_results.json"))
    # the trained flow checkpoint is self-describing
    found = load_checkpoint_auto(
        os.path.join(str(tmp_path), "flow", "checkpoints"), device="cpu")
    assert found is not None and found[2].coupling == "rncp"


def test_pipeline_highbeta_from_exported_flow():
    """--mode highbeta --ckpt <.npz> skips training and returns the
    head-to-head keys."""
    out = cli.main(["pipeline", *CPU, "--mode", "highbeta", "--L", "4",
                    "--beta", "6", "--ckpt",
                    str(DATA_DIR / "flow8x8_b2_16l.npz"), "--ntraj", "4",
                    "--ft-nstep", "2", "--ft-chains", "2", "--plain-ntraj",
                    "8", "--plain-nstep", "2", "--plain-chains", "2"])
    assert "train" not in out
    assert {"fthmc", "hmc", "tau_int_speedup", "tau_int_speedup_err",
            "mode", "L", "beta"} <= set(out)


def test_cli_bench_hmc_small():
    out = cli.main(["bench", *CPU, "--L", "4", "--chains", "2", "--which",
                    "hmc"])
    assert set(out) == {"hmc"}
    assert out["hmc"]["value"] > 0 and 0.0 <= out["hmc"]["acc"] <= 1.0


def test_cli_queue_status(tmp_path):
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps({
        "marker_dir": str(tmp_path / "m"),
        "stages": [{"name": "s1", "cmd": ["true"]}]}))
    res = cli.main(["queue", "--queue", str(qf), "--status"])
    assert res == {"s1": "pending"}


def test_module_run_exits_zero(tmp_path):
    """python -m fthmc_tpu_torch.cli exits 0 on success (the JAX console
    script exits 1: sys.exit of main's dict)."""
    r = subprocess.run(
        [sys.executable, "-m", "fthmc_tpu_torch.cli", "hmc", *CPU, "--L",
         "4", "--ntraj", "2", "--chains", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "s_per_traj=" in r.stdout


# ------------------------------------------------- the parallel flags

def _cli_rank(rank, outdir):
    """Each rank runs the commands; rank 0 writes the files."""
    os.nice(10)
    torch.set_num_threads(1)
    chains = cli.main(SCHW + ["--chains", "8", "--ntraj", "4", "--block",
                              "2", "--devices", "2"])
    rows = cli.main(["hmc", *CPU, "--L", "8", "--ntraj", "8", "--chains",
                     "4", "--nstep", "4", "--tau", "0.5", "--shard-rows",
                     "2", "--outdir", outdir])
    return chains, rows


def test_parallel_flags_on_two_gloo_ranks(tmp_path):
    """schwinger --devices 2 and hmc --shard-rows 2 on two gloo ranks: the
    ranks agree, the chain-sharded run is each rank's single-device run on
    its chains with rank_generator(g, rank), and the row-sharded run's
    fields are written once, whole."""
    from fthmc_tpu_torch.parallel.mesh import rank_generator
    from fthmc_tpu_torch.schwinger import (SchwingerConfig,
                                           run_hmc_dyn_chunked)
    out = str(tmp_path / "rows")
    (c0, r0), (c1, r1) = spawn(_cli_rank, 2, out, workdir=str(tmp_path))
    for a, b in ((c0, c1), (r0, r1)):       # the history is global
        assert a.pop("s_per_traj") > 0 and b.pop("s_per_traj") > 0
        assert a == b
    cfg = SchwingerConfig(L=4, beta=2.0, mass=0.4, tau=0.5, nstep=4,
                          n_chains=4, ntraj=4)
    gen = torch.Generator().manual_seed(1331)
    x0 = tl.hot_start(gen, 8, 4, device="cpu")
    hists = [run_hmc_dyn_chunked(
        cfg, block=2, x0=x0[4 * r:4 * r + 4], device="cpu",
        generator=rank_generator(gen, r))[1] for r in range(2)]
    ref = cli._summarize_hmc(th.TrajMetrics(
        *[torch.cat(f, dim=1) for f in zip(*hists)]))
    for k in ("acc", "plaq", "exp_mdh", "dh_abs"):
        assert c0[k] == pytest.approx(ref[k], rel=1e-6), k
    assert 0.0 <= r0["acc"] <= 1.0 and abs(r0["exp_mdh"] - 1.0) < 0.5
    with np.load(os.path.join(out, "hmc_fields.npz")) as f:
        assert f["x"].shape == (4, 2, 8, 8)
    with np.load(os.path.join(out, "hmc_history.npz")) as h:
        assert h["plaq"].shape == (8, 4)


def jax_reference_readings() -> dict:
    """The JAX package's reading, on the CPU, of the configuration
    tests/test_torch_card_entry.py runs through `schwinger --state`: plain
    dynamical HMC at 16^2, beta=2, m=0.2, tau=1, 8 Omelyan steps, 64
    chains from a hot start, 160 trajectories in blocks of 40; <plaq> and
    <exp(-dH)> over the last 120 (the CLI's summary), <plaq>'s blocked
    standard error (10 blocks)."""
    import time

    import jax
    from fthmc_tpu import schwinger as jsw
    cfg = jsw.SchwingerConfig(L=16, beta=2.0, mass=0.2, tau=1.0, nstep=8,
                              n_chains=64, ntraj=160)
    t0 = time.perf_counter()
    _, hist = jsw.run_hmc_dyn_chunked(cfg, block=40,
                                      key=jax.random.PRNGKey(0))
    per = np.asarray(hist.plaq)[40:].mean(axis=1)
    return {"schwinger_16_b2_m02": {
        "chains": 64, "trajectories": 160, "measured": 120,
        "plaq": float(per.mean()),
        "plaq_stderr_blocked": float(per.reshape(10, -1).mean(axis=1)
                                     .std(ddof=1) / np.sqrt(10)),
        "exp_mdh": float(np.asarray(hist.exp_mdh)[40:].mean()),
        "acceptance": float(np.asarray(hist.acc)[40:].mean()),
        "cpu_seconds": time.perf_counter() - t0}}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_cli.py
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(jax_reference_readings()))
