"""The command line, the API facade and the entry points on the card, at
full width: each subcommand of fthmc_tpu_torch.cli in this process, one in
a process of its own, the facade's force and the profiler's trace, the
bench entry, entry()'s step, dryrun_multichip(1) and the three demos. Each
run's launch counters are set to 0 just before it and held to its count,
with no plain twin.

Marked ``cuda``: each test skips without a card. Imports only torch, numpy
and the port (tests/test_torch_cuda.py gives the command)."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import LeapfrogConfig
from fthmc_tpu_torch.hmc import TrajMetrics, ft_force
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.schwinger import SchwingerConfig, force_evaluations
from fthmc_tpu_torch.weights import FLAGSHIP_NPZ
from test_torch_card_samplers import DYN, MIN_ACCEPTANCE
from test_torch_card_training import REF_TRAIN
from test_torch_cuda import (FT_B, FT_BETA, FT_L, FT_NSTEP,  # noqa: F401
                             FT_TAU, HEADLINE_CFG, _counted, _expect,
                             _ft_launches, card, flagship, near_equilibrium)

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# `fthmc` at the flagship and `hmc` at the headline, cold starts:
# trajectories (the CLI's summary drops the first quarter, which at the
# headline must cover the cold start's relaxation, some 500 trajectories:
# over trajectories 10-40 <exp(-dH)> reads 1.12); `hmc --nrun` at 16^2 x
# 64 chains: (trajectories a run, runs)
CLI_FT_TRAJ, CLI_HMC_TRAJ, CLI_NRUN = 48, 2000, (400, 2)
# plain `schwinger` at the JAX package's sharded test configuration (16^2,
# beta=2, m=0.2, tau=1, 8 Omelyan steps; 64 chains, maxiter 1000) through
# --state from a hot start: (trajectories of the first call, in all), the
# block, and the JAX package's reading of this protocol on the CPU
# (`python tests/test_torch_cli.py`, jax_reference_readings: <plaq> over
# the last 120 trajectories and its blocked standard error)
CLI_SCHW = SchwingerConfig(L=16, beta=2.0, mass=0.2, tau=1.0, nstep=8,
                           n_chains=64, cg_maxiter=1000)
CLI_SCHW_TRAJ, CLI_SCHW_BLOCK = (80, 160), 40
CLI_SCHW_PLAQ = (0.7109524607658386, 0.00047828661536474844)
# `schwinger --ckpt` at path C's configuration: trajectories; after `train`
# at the reference configuration, one era: `sample` (ensemble size,
# chains, block) and `fthmc` (trajectories, leapfrog steps); `pipeline
# --mode highbeta` with the flagship flow at 16^2, beta=6, tau=0.5: (FT
# trajectories, Omelyan steps, chains, plain trajectories, leapfrog
# steps, chains)
CLI_SCHW_FT_TRAJ = 16
CLI_SAMPLE, CLI_TRAINED_FT = (4096, 64, 64), (4, 64)
CLI_HIGHBETA = (16, 8, 64, 64, 16, 128)
# The demos in this process at their default widths, their run lengths
# cut: demo_highbeta's trajectories (128 by default), demo_schwinger's of
# each leg (512), demo_2d_u1's FT and transfer trajectories (1024, 256)
DEMO_HIGHBETA_NTRAJ = 32
DEMO_SCHWINGER_NTRAJ = 48
DEMO_2D_U1_CUT = {"ft_ntraj": 128, "transfer_ntraj": 32}


def _hold_launches(launches: dict, plain: dict, expect: dict) -> None:
    assert launches == _expect(**expect)
    assert not any(plain.values()), plain


def _cli(argv: list, expect: dict) -> dict:
    """fthmc_tpu_torch.cli.main(argv) in this process, its launches held
    to ``expect`` (kernel -> count, the rest 0) with no plain twin run."""
    from fthmc_tpu_torch import cli
    out, launches, plain = _counted(lambda: cli.main(argv))
    _hold_launches(launches, plain, expect)
    return out


# ---------------------------------------------------------------------------
# the command line and the API facade
# ---------------------------------------------------------------------------

def test_cli_fthmc_at_the_flagship(card, flagship):
    """`fthmc` with the exported flow at the flagship from z0 = f^-1(0):
    the flagship run's launches a trajectory and its physics gates."""
    spec = flagship[1]
    n = CLI_FT_TRAJ
    out = _cli(["fthmc", "--ckpt", str(FLAGSHIP_NPZ), "--L", str(FT_L),
                "--beta", str(FT_BETA), "--tau", str(FT_TAU), "--nstep",
                str(FT_NSTEP), "--integrator", "omelyan", "--chains",
                str(FT_B), "--start", "cold", "--ntraj", str(n)],
               _ft_launches(2 * FT_NSTEP + 1, spec.n_layers, n))
    assert out["acc"] >= MIN_ACCEPTANCE, out["acc"]
    assert abs(out["plaq"] - lattice.PLAQ_EXACT[FT_BETA]) <= 0.003
    assert abs(out["exp_mdh"] - 1.0) <= 0.1, out["exp_mdh"]


def test_cli_hmc_at_the_headline(card):
    """`hmc` at the headline from a cold start: K2 and K12 a trajectory,
    <exp(-dH)> within 0.05 of 1."""
    hc, n = HEADLINE_CFG, CLI_HMC_TRAJ
    out = _cli(["hmc", "--L", str(hc.L), "--beta", str(hc.beta), "--tau",
                str(hc.tau), "--nstep", str(hc.nstep), "--chains",
                str(hc.n_chains), "--start", "cold", "--ntraj", str(n)],
               {"K2": n, "K12": n})
    assert abs(out["exp_mdh"] - 1.0) <= 0.05, out["exp_mdh"]


def test_cli_hmc_nrun(card):
    """`hmc --nrun 2` at 16^2 x 64 ('auto': K3 and K12 a trajectory): an
    error from the runs, <exp(-dH)> within 0.05 of 1."""
    hc = HEADLINE_CFG
    n, runs = CLI_NRUN
    out = _cli(["hmc", "--L", "16", "--beta", str(hc.beta), "--tau",
                str(hc.tau), "--nstep", str(hc.nstep), "--chains", "64",
                "--start", "cold", "--ntraj", str(n), "--nrun", str(runs)],
               {"K3": n * runs, "K12": n * runs})
    assert out["plaq_err"] > 0 and abs(out["exp_mdh"] - 1.0) <= 0.05, out


def test_cli_schwinger_resumes_through_its_state(card, tmp_path):
    """Plain `schwinger` at beta=2, m=0.2 through --state, in two calls
    (the second resumes at the first's end and measures the condensate):
    one K11 launch a solve (a force and the Metropolis solve a trajectory;
    the condensate's solve counted alone first), K1 a force; the resume
    keeps the first call's rows; <plaq> over the last 120 trajectories
    within max(0.004, 5 blocked errors) of the JAX package's reading of
    the same protocol, <exp(-dH)> within 0.05 of 1."""
    cfg = CLI_SCHW
    n1, n2 = CLI_SCHW_TRAJ
    state = str(tmp_path / "schwinger_state.npz")
    argv = ["schwinger", "--L", str(cfg.L), "--beta", str(cfg.beta),
            "--mass", str(cfg.mass), "--tau", str(cfg.tau), "--nstep",
            str(cfg.nstep), "--chains", str(cfg.n_chains), "--start", "hot",
            "--block", str(CLI_SCHW_BLOCK), "--state", state]
    nf = force_evaluations(cfg)["dyn"]
    # the condensate's launches alone, on configurations of this shape
    x = near_equilibrium(torch.Generator(card).manual_seed(90),
                         cfg.n_chains, cfg.L, cfg.beta, card)
    _, cond, _ = _counted(lambda: tf.chiral_condensate(
        torch.Generator(card).manual_seed(91), x, cfg.mass, n_noise=8))
    _cli(argv + ["--ntraj", str(n1)], {"K1": nf * n1, "K11": (nf + 1) * n1})
    with np.load(state) as d:
        first = {k: d[k] for k in TrajMetrics._fields}
        assert int(d["done"]) == n1
    out = _cli(argv + ["--ntraj", str(n2), "--condensate"],
               {"K1": nf * (n2 - n1),
                "K11": (nf + 1) * (n2 - n1) + cond["K11"]})
    with np.load(state) as d:
        assert int(d["done"]) == n2
        assert all(np.array_equal(d[k][:n1], v) for k, v in first.items())
        per = d["plaq"][n2 // 4:].mean(axis=1)
    stderr = float(per.reshape(10, -1).mean(axis=1).std(ddof=1)
                   / math.sqrt(10))
    bound = max(0.004, 5 * stderr)
    assert abs(out["plaq"] - CLI_SCHW_PLAQ[0]) <= bound, (out["plaq"], bound)
    assert abs(out["exp_mdh"] - 1.0) <= 0.05, out["exp_mdh"]


def test_cli_schwinger_with_the_flow_at_path_c(card, flagship):
    """`schwinger --ckpt` with the flagship flow at path C's shape from z0
    = f^-1(0): K1, K6-K8 and K11 as path C counts them, <exp(-dH)>
    finite."""
    cfg, n = DYN["C"], CLI_SCHW_FT_TRAJ
    nf = force_evaluations(cfg)["dyn"]
    out = _cli(["schwinger", "--ckpt", str(FLAGSHIP_NPZ), "--L", str(cfg.L),
                "--beta", str(cfg.beta), "--mass", str(cfg.mass), "--tau",
                str(cfg.tau), "--nstep", str(cfg.nstep), "--chains",
                str(cfg.n_chains), "--start", "cold", "--ntraj", str(n)],
               {**_ft_launches(nf, flagship[1].n_layers, n),
                "K11": (nf + 1) * n})
    assert np.isfinite(out["exp_mdh"])


def test_cli_train_then_sample_and_fthmc(card, tmp_path):
    """`train` at the reference configuration for one era (no launch),
    then `sample` (K6 exactly once a layer a block; acceptance in (0, 1])
    and `fthmc` (position Verlet: nstep forces a trajectory) from its
    checkpoints, <exp(-dH)> finite."""
    cfg = REF_TRAIN
    outdir = str(tmp_path / "train")
    _cli(["train", "--n-layers", str(cfg.flow.n_layers), "--hidden",
          *map(str, cfg.flow.hidden_sizes), "--L", str(cfg.L), "--beta",
          str(cfg.beta), "--n-era", "1", "--n-epoch", str(cfg.n_epoch),
          "--outdir", outdir], {})
    ck = os.path.join(outdir, "checkpoints")
    size, chains, batch = CLI_SAMPLE
    nl = cfg.flow.n_layers
    sm = _cli(["sample", "--ckpt", ck, "--L", str(cfg.L), "--beta",
               str(cfg.beta), "--ensemble-size", str(size),
               "--sample-chains", str(chains), "--batch-size", str(batch)],
              {"K6": nl * (-(-(size - 1) // batch) + 1)})
    assert 0.0 < sm["accept_rate"] <= 1.0, sm["accept_rate"]
    n, nstep = CLI_TRAINED_FT
    ft = _cli(["fthmc", "--ckpt", ck, "--L", str(cfg.L), "--beta",
               str(cfg.beta), "--ntraj", str(n), "--nstep", str(nstep)],
              _ft_launches(nstep, nl, n))
    assert np.isfinite(ft["exp_mdh"])


def test_cli_pipeline_highbeta(card, flagship):
    """`pipeline --mode highbeta` with the flagship flow at 16^2, beta=6:
    FT-HMC (cold, Omelyan) then plain HMC ('auto': K3 and K12 at 16^2),
    the head-to-head keys returned."""
    ft_n, ft_nstep, ft_chains, pl_n, pl_nstep, pl_chains = CLI_HIGHBETA
    out = _cli(["pipeline", "--mode", "highbeta", "--ckpt",
                str(FLAGSHIP_NPZ), "--L", str(FT_L), "--beta", str(FT_BETA),
                "--tau", str(FT_TAU), "--ntraj", str(ft_n), "--ft-nstep",
                str(ft_nstep), "--ft-chains", str(ft_chains),
                "--plain-ntraj", str(pl_n), "--plain-nstep", str(pl_nstep),
                "--plain-chains", str(pl_chains)],
               {**_ft_launches(2 * ft_nstep + 1, flagship[1].n_layers,
                               ft_n), "K3": pl_n, "K12": pl_n})
    assert {"mode", "L", "beta", "fthmc", "hmc", "tau_int_speedup",
            "tau_int_speedup_err"} <= set(out), sorted(out)


def test_cli_runs_in_a_process_of_its_own(card):
    """`python3 -m fthmc_tpu_torch.cli hmc` in a process of its own (the
    card by default) exits 0."""
    r = subprocess.run([sys.executable, "-m", "fthmc_tpu_torch.cli", "hmc",
                        "--L", "16", "--ntraj", "16", "--chains", "64"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_facade_force_and_trace(card, flagship, tmp_path):
    """api.FieldTransformation's force (K1, and K7/K8 a layer) against
    hmc.ft_force (autograd) within 2e-3 x max(1, max|F|), the kernel force
    chain's tolerance; utils.profiling.trace around two flagship
    trajectories writes a Chrome trace naming K6/K7's and K8's kernels."""
    from fthmc_tpu_torch import api
    from fthmc_tpu_torch.utils.profiling import trace
    params, spec, z = flagship
    ft = api.FieldTransformation(params, spec, FT_BETA,
                                 LeapfrogConfig(tau=FT_TAU, nstep=FT_NSTEP))
    with full_fp32():
        f_k, launches, _ = _counted(lambda: ft.force(z))
        f_a = ft_force(params, spec, z, FT_BETA, device=card)
    nl = spec.n_layers
    assert {k: v for k, v in launches.items() if v} == \
        {"K1": 1, "K7": nl, "K8": nl}
    assert float((f_k - f_a).abs().max()) <= 2e-3 * max(
        1.0, float(f_a.abs().max()))
    with trace(str(tmp_path / "trace")):
        ft.run(torch.Generator(card).manual_seed(95), z, num_trajs=2)
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    for k in ("coupling_fwd_kernel", "coupling_bwd_kernel"):
        assert any(k in n for n in kernels), k


# ---------------------------------------------------------------------------
# the entry points and the demos
# ---------------------------------------------------------------------------

def test_bench_entry_at_its_defaults(card, tmp_path):
    """`python3 -m fthmc_tpu_torch.bench` at its defaults in a process of
    its own: exit 0, one stdout line, a JSON object with the JAX script's
    four keys."""
    r = subprocess.run([sys.executable, "-m", "fthmc_tpu_torch.bench",
                        "--extra-json", str(tmp_path / "bench_extra.json")],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1 and list(json.loads(lines[0])) == [
        "metric", "value", "unit", "vs_baseline"], lines


def test_entry_step(card):
    """entry()'s FT-HMC step once: K7, K1, K8 a force, K6 a layer an energy
    flow; its force against the autograd force on the same z within 2e-3 x
    max(1, max|F|); dH finite."""
    from fthmc_tpu_torch import entry as pentry
    from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel
    fn, args = pentry.entry()
    params, _, z, _ = args
    spec, n = pentry.ENTRY_SPEC, pentry.ENTRY_NSTEP
    nl = spec.n_layers
    (_, _, _, m), launches, plain = _counted(lambda: fn(*args))
    _hold_launches(launches, plain, {"K1": n, "K6": 2 * nl, "K7": n * nl,
                                     "K8": n * nl})
    with full_fp32():
        f_k = ft_force_kernel(params, spec, z, pentry.ENTRY_BETA)
        f_a = ft_force(params, spec, z, pentry.ENTRY_BETA, device=card)
    assert float((f_k - f_a).abs().max()) <= 2e-3 * max(
        1.0, float(f_a.abs().max()))
    assert bool(torch.isfinite(m.dh).all())


def test_dryrun_multichip_on_one_rank(card):
    """dryrun_multichip(1) on a group of one NCCL rank, with its launches:
    the chain-sharded runs' kernels (K3 and K12 at 8^2; the FT steps' K1,
    K6-K8; the dynamical runs' K11 a solve and K1 a force); the training
    and the row-sharded stages launch none."""
    from fthmc_tpu_torch import entry as pentry
    _, launches, plain = _counted(lambda: pentry.dryrun_multichip(1))
    nf = force_evaluations(SchwingerConfig(L=8, beta=2.0, mass=0.3, tau=0.5,
                                           nstep=2))["dyn"]
    # (leapfrog forces, trajectories) of the FT step and run, the
    # dynamical runs' trajectories, the dry run's flow's layers
    ft_runs, dyn_n, nl = ((2, 1), (2, 3)), 2, 2
    k7 = nl * (sum(a * b for a, b in ft_runs) + nf * dyn_n)
    _hold_launches(launches, plain, {
        "K1": sum(a * b for a, b in ft_runs) + 2 * nf * dyn_n,
        "K3": 4, "K12": 4,
        "K6": nl * (2 + (2 * 3 + 1) + (2 * dyn_n + 1)),
        "K7": k7, "K8": k7, "K11": 2 * (nf + 1) * dyn_n})


def test_demo_highbeta(card, flagship):
    """demo_highbeta at its defaults (16^2, 64 chains, 128 Omelyan steps,
    the beta=3 flow at beta=6, hot start) for DEMO_HIGHBETA_NTRAJ
    trajectories: <exp(-dH)> within 0.1 of 1, acceptance >= 0.5; K1, K7,
    K8 a force, K6 a layer an energy flow (two a trajectory and one a
    block)."""
    from fthmc_tpu_torch.examples import demo_highbeta
    n = DEMO_HIGHBETA_NTRAJ
    out, launches, plain = _counted(
        lambda: demo_highbeta.main(["--ntraj", str(n)]))
    nf, nl = 2 * 128 + 1, flagship[1].n_layers
    blocks = -(-n // demo_highbeta.BLOCK)
    _hold_launches(launches, plain, {
        "K1": nf * n, "K6": nl * (2 * n + blocks), "K7": nf * nl * n,
        "K8": nf * nl * n})
    assert abs(out["exp_mdh"] - 1.0) <= 0.1, out["exp_mdh"]
    assert out["acc"] >= 0.5, out["acc"]


def test_demo_schwinger(card, flagship):
    """demo_schwinger at its default widths (8^2, 32 chains, beta=3,
    m=0.2, 'auto': K11) for DEMO_SCHWINGER_NTRAJ trajectories a leg:
    gamma_5-hermiticity <= 1e-8, the plain leg's <exp(-dH)> within 0.05 of
    1. K11 a solve and K1 a force in both legs, K7/K8 a layer a force and
    K6 a layer an energy flow in the FT leg, and the pion correlator's
    solve (counted alone first, on links of its shape)."""
    from fthmc_tpu_torch.examples import demo_schwinger
    n, L, chains = DEMO_SCHWINGER_NTRAJ, 8, 32
    x = near_equilibrium(torch.Generator(card).manual_seed(92), 4, L, 3.0,
                         card)
    _, pion, _ = _counted(lambda: tf.pion_correlator(x, 0.2))
    out, launches, plain = _counted(
        lambda: demo_schwinger.main(["--ntraj", str(n)]))
    nf = force_evaluations(SchwingerConfig(L=L, beta=3.0, mass=0.2,
                                           tau=1.0, nstep=16))["dyn"]
    nf_ft = force_evaluations(SchwingerConfig(L=L, beta=3.0, mass=0.2,
                                              tau=0.5, nstep=8))["dyn"]
    nl = flagship[1].n_layers
    _hold_launches(launches, plain, {
        "K1": (nf + nf_ft) * n,
        "K11": (nf + 1 + nf_ft + 1) * n + pion["K11"],
        "K6": nl * (2 * n + 1), "K7": nf_ft * nl * n, "K8": nf_ft * nl * n})
    assert out["chains"] == chains, out
    assert out["g5_hermiticity"] <= 1e-8, out["g5_hermiticity"]
    assert abs(out["plain"]["exp_mdh"] - 1.0) <= 0.05


def test_demo_2d_u1(card):
    """demo_2d_u1 at its defaults (8^2, beta=2, 64 HMC chains, the
    16-layer flow trained 10 x 100 epochs, 8192 flow samples, 16 FT chains
    with 64 leapfrog steps), the FT and transfer trajectories cut
    (DEMO_2D_U1_CUT): the HMC's and FT-HMC's <plaq> within max(0.004, 5
    sigma) of exact (sigma over the chains). K3 and K12 a plain
    trajectory; K6 a layer a sampling block and the initial draw; K1, K7,
    K8 a force and K6 a layer an energy flow in FT-HMC."""
    from fthmc_tpu_torch.examples import demo_2d_u1
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in DEMO_2D_U1_CUT.items()]
    out, launches, plain = _counted(lambda: demo_2d_u1.main(argv))
    n = out["lengths"]
    nl, nstep = 16, 64
    blocks = max(1, -(-(n["ensemble_size"] - 1) // 64))
    ft = n["ft_ntraj"] + n["transfer_ntraj"]
    _hold_launches(launches, plain, {
        "K3": n["hmc_ntraj"], "K12": n["hmc_ntraj"], "K1": nstep * ft,
        "K6": nl * (blocks + 1) + nl * (2 * ft + 2),
        "K7": nstep * nl * ft, "K8": nstep * nl * ft})
    exact = lattice.PLAQ_EXACT[2.0]
    for leg in ("hmc", "fthmc"):
        r = out[leg]
        assert abs(r["plaq"] - exact) <= max(0.004, 5 * r["plaq_err"]), \
            (leg, r["plaq"])
