"""The sampling paths on the card at their production shapes and physics:
flagship FT-HMC with the trained flow, plain HMC on K2, K4, K5 and K3, the
dynamical paths A-G, the normal operator's own entry point, the fermion
observables, the mobility probes, the resilient runner, the diagnostics
and the JAX package's bf16 recipe. Each run's launch counters are set to
0 just before it and held to the path's own count, with no plain twin.

Marked ``cuda``: each test skips without a card. Imports only torch, numpy
and the port (tests/test_torch_cuda.py gives the command)."""
import dataclasses
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
from fthmc_tpu_torch.hmc import (TrajMetrics, leapfrog, resolve_force_backend,
                                 run_fthmc, run_hmc)
from fthmc_tpu_torch.models.flow import (flow_forward, flow_reverse,
                                         init_flow_params)
from fthmc_tpu_torch.ops import fermion_kernels as fk
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.schwinger import (SchwingerConfig, force_evaluations,
                                       run_fthmc_dyn, run_hmc_dyn)
from test_torch_cuda import (  # noqa: F401
    FT_B, FT_BETA, FT_L, FT_NSTEP, FT_TAU, HEADLINE_CFG, _counted, _expect,
    _ft_launches, _wrapped, card, flagship, near_equilibrium)

pytestmark = pytest.mark.cuda

# Flagship FT-HMC: thermalizing and measured trajectories. The JAX
# package's own run of this configuration (trained flow, 16^2, beta=6,
# tau=0.5, 8 Omelyan steps, 64 chains, cold start, 4608 measured
# trajectories; artifacts/round3/tauint_b6_ft_t05n8.json) accepted 0.827
# with <exp(-dH)> = 0.955. A mean over 96 x 64 accept flips has a standard
# error near 0.005 if independent; 0.78 leaves room for correlation. It is
# the loosest check here: a wrong force shows first in the kernel and
# force comparisons of tests/test_torch_cuda.py.
N_THERM, N_MEAS = 32, 96
MIN_ACCEPTANCE = 0.78
# Plain HMC at the headline (HEADLINE_CFG) and K3's run at 32^2 with the
# same beta and dt. From the cold start the plaquette's excess over its
# equilibrium falls over some 500 trajectories (slow modes of fixed-length
# trajectories), so 600 thermalize; 1000 are measured, in 10 blocks for
# the error. The JAX package's acceptance at the headline (BENCH_extra.json,
# 20 trajectories x 1024 chains after 100 from a cold start): a physics
# reading the port must reproduce. 1000 x 1024 accept flips have a
# standard error near 0.0004 if independent; the margin leaves room for
# correlation and for the JAX reading's own 20 trajectories. A smaller
# lattice accepts more at the same dt (<dH> grows with the volume), so
# K3's 32^2 run is held to the floor only.
CL_L = 32
H_THERM, H_MEAS = 600, 1000
JAX_ACCEPTANCE, ACC_MARGIN = 0.843, 0.02
# Dynamical fermions (fthmc_tpu_torch.schwinger): the JAX package's own
# production runs, which used its fused CG, and what they read
# (acceptance, <exp(-dH)>, <plaq>):
#  A  artifacts/round3/schw_mts_L64b6.json, row plain:16:0:tau=2.0: 64^2,
#     beta=6, m=0.1, 64 chains, tau=2, 16 Omelyan steps, maxiter 2000;
#  B  artifacts/round3/probe_b6_plain.json, row plain:10:0:tau=2.0: 16^2,
#     128 chains, tau=2, 10 steps, maxiter 1500 (run here on K10 by name);
#  C  artifacts/round4/ferm_16b6.json, second row: FT-HMC with the trained
#     flagship flow, 16^2, 128 chains, tau=0.5, 4 steps, maxiter 1500, from
#     z0 = f^-1(0);
#  D  artifacts/round3/schw_mts_L64b6.json, row plain:8:2:tau=2.0: nested
#     plain HMC, 64^2, beta=6, m=0.1, 64 chains, tau=2, 8 outer Omelyan
#     steps, n_inner 2, maxiter 2000;
#  E  artifacts/round3/schw_mts_L32m002.json, row plain:4:2:tau=1.0:hb=0.2x2:
#     Hasenbusch, 32^2, beta=6, m=0.02, 64 chains, tau=1, nstep 4, n_mid 2,
#     n_inner 2, dm 0.2, maxiter 4000;
#  F  artifacts/round3/schw_mts_scan_b5_part2.json, row ft:8:3 with the
#     flagship flow flow8x8_b3_rncp24_ftb6: nested FT-HMC, 16^2, beta=5,
#     m=0.1, 64 chains, tau=0.5, 8 outer steps, n_inner 3, maxiter 1500;
#  G  artifacts/round3/cgab_L64_mixed.json, row plain:12:0:tau=2.0: the
#     mixed CG (cg_backend 'mixed'), 64^2, beta=6, m=0.1, 64 chains, tau=2,
#     12 Omelyan steps, maxiter 2000.
# All eo-preconditioned and warm-started, force solves at 1e-9 and the
# Metropolis solve at 1e-12 on |r|^2/|b|^2. The JAX runs started from
# thermalized states that are not in the repo; here near-equilibrium
# links, or z0 = f^-1(0) for FT, then thermalized.
MASS = 0.1
_DYN_TOL = dict(cg_tol_force=1e-9, cg_tol_mh=1e-12)
DYN = {
    "A": SchwingerConfig(L=64, beta=6.0, mass=MASS, tau=2.0, nstep=16,
                         n_chains=64, cg_maxiter=2000, **_DYN_TOL),
    "B": SchwingerConfig(L=16, beta=6.0, mass=MASS, tau=2.0, nstep=10,
                         n_chains=128, cg_maxiter=1500, cg_layout="cl",
                         **_DYN_TOL),
    "C": SchwingerConfig(L=16, beta=6.0, mass=MASS, tau=0.5, nstep=4,
                         n_chains=128, cg_maxiter=1500, **_DYN_TOL),
    "D": SchwingerConfig(L=64, beta=6.0, mass=MASS, tau=2.0, nstep=8,
                         n_inner=2, n_chains=64, cg_maxiter=2000,
                         **_DYN_TOL),
    "E": SchwingerConfig(L=32, beta=6.0, mass=0.02, tau=1.0, nstep=4,
                         n_mid=2, n_inner=2, hasenbusch_dm=0.2, n_chains=64,
                         cg_maxiter=4000, **_DYN_TOL),
    "F": SchwingerConfig(L=16, beta=5.0, mass=MASS, tau=0.5, nstep=8,
                         n_inner=3, n_chains=64, cg_maxiter=1500,
                         **_DYN_TOL),
    "G": SchwingerConfig(L=64, beta=6.0, mass=MASS, tau=2.0, nstep=12,
                         n_chains=64, cg_maxiter=2000, **_DYN_TOL)}
DYN_READING = {"A": (0.95458984375, 0.999826192855835, 0.9147999286651611),
               "B": (0.9369964599609375, 1.0002156496047974,
                     0.9148625135421753),
               "C": (0.6754817962646484, 0.884468674659729,
                     0.914852499961853),
               "D": (0.7928059697151184, 0.9980745911598206,
                     0.9148449897766113),
               "E": (0.9874267578125, 1.000128984451294,
                     0.9155676364898682),
               "F": (0.7916666865348816, 0.9873201847076416,
                     0.8967482447624207),
               "G": (0.895263671875, 1.0111162662506104,
                     0.9148247241973877)}
# (thermalizing, measured) trajectories, cut for the time a run may take
# (D was 30 + 60, E-G 30 + 40), and the start: (seed of near-equilibrium
# links, or None for z0 = f^-1(0) with the flow)
DYN_TRAJ = {"A": (30, 60), "B": (50, 150), "C": (100, 100), "D": (20, 40),
            "E": (20, 20), "F": (20, 30), "G": (20, 30)}
DYN_START = {"A": 51, "B": 52, "C": None, "D": 53, "E": 54, "F": None,
             "G": 56}
# the CG backend of a path other than the default 'auto' (K11)
DYN_CG = {"G": "mixed"}
# FT paths: acceptance floors (C: the first port's; F: the JAX package's
# 0.79 less the margin C's gate leaves its own reading)
MIN_FT_ACCEPTANCE = {"C": 0.60, "F": 0.72}
# (chains, L, chains-last) of the operator comparisons: the paths' shapes
# and operators (C's 'auto' operator, K9 at 16^2)
FERMION_SHAPES = {"A": (64, 64, False), "B": (128, 16, True),
                  "C": (128, 16, False)}
# The mobility probes at the production selection regime
# (experiments/finetune_force.py:66-100): 16^2, beta=6, 128 chains,
# tau=0.5, 4 Omelyan steps, the trained flagship flow; the trajectories
# cut (therm, timed, call block). The dynamical probe (m=0.1) is path C's
# configuration; its blocks of 4 give exactly 52 and 64. The floor
# extension: a small plain budget under an event floor it cannot meet.
PROBE = dict(L=16, beta=6.0, n_chains=128, tau=0.5, nstep=4)
PROBE_QUENCHED = dict(therm=64, ntraj=256, call_block=64)
PROBE_DYN = dict(mass=MASS, therm=52, ntraj=64, call_block=4,
                 cg_maxiter=1500)
PROBE_FLOOR = dict(therm=8, ntraj=16, call_block=8, min_events=1e9,
                   max_extra_blocks=2)
# The resilient runner over run_fthmc blocks at the flagship FT path: the
# block, (trajectories before the restart, in all)
RUNNER_BLOCK, RUNNER_TRAJ = 8, (16, 32)
# reversibility_error against the CPU port: chains and steps
REV_CHAINS, REV_NSTEP = 4, 4
# The JAX package's FT-HMC recipe at L >= 64 (fthmc_tpu/bench.py:111-156,
# bench_fthmc_flagship(L=64, chains=32, conv_dtype='bfloat16')): the
# flagship spec with bf16 convs and fresh weights at 64^2, 32 chains,
# beta=6, tau=0.5, 8 Omelyan steps from z0 = 0, the force by autograd (the
# kernels refuse bf16); (thermalizing, measured) trajectories
BF16_L, BF16_CHAINS, BF16_TRAJ = 64, 32, (8, 8)


def _finite(hist) -> bool:
    return all(bool(torch.isfinite(torch.as_tensor(t)).all()) for t in hist)


def _on_cpu(params):
    return [[{k: t.detach().cpu() for k, t in c.items()} for c in net]
            for net in params]


# ---------------------------------------------------------------------------
# flagship FT-HMC with the trained flow, from z0 = f^-1(0)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_run(card, flagship):
    """N_THERM + N_MEAS flagship trajectories through run_fthmc with the
    default (kernel) force backend: (final z, history, launches, plain
    twin calls)."""
    params, spec, z0 = flagship
    lf = LeapfrogConfig(tau=FT_TAU, nstep=FT_NSTEP)
    (z, hist), launches, plain = _counted(lambda: run_fthmc(
        params, spec, lf, beta=FT_BETA, ntraj=N_THERM + N_MEAS, z0=z0,
        generator=torch.Generator(device=card).manual_seed(7),
        integrator="omelyan", device=card))
    return z, hist, launches, plain


def test_flagship_fthmc_physics(flagship_run):
    """Acceptance >= MIN_ACCEPTANCE, <plaq> within 0.003 of exact and
    <exp(-dH)> within 0.1 of 1 over the measured trajectories."""
    z, hist, _, _ = flagship_run
    meas = slice(N_THERM, None)
    assert _finite(hist) and z.shape == (FT_B, 2, FT_L, FT_L)
    acc = float(hist.acc[meas].mean())
    plaq = float(hist.plaq[meas].mean(dim=1).mean())
    exp_mdh = float(hist.exp_mdh[meas].mean())
    assert acc >= MIN_ACCEPTANCE, acc
    assert abs(plaq - lattice.PLAQ_EXACT[FT_BETA]) <= 0.003, plaq
    assert abs(exp_mdh - 1.0) <= 0.1, exp_mdh


def test_flagship_fthmc_launches(flagship, flagship_run):
    """K1, K7 and K8 a force (K7/K8 a layer; 2 nstep + 1 Omelyan forces a
    trajectory), K6 a layer an energy flow (two a trajectory and the
    start's charge), nothing else, no plain twin."""
    _, spec, _ = flagship
    _, _, launches, plain = flagship_run
    want = _ft_launches(2 * FT_NSTEP + 1, spec.n_layers, N_THERM + N_MEAS)
    assert launches == _expect(**want)
    assert not any(plain.values()), plain


# ---------------------------------------------------------------------------
# plain HMC through run_hmc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,kernel,L", [
    ("auto", "K2", HEADLINE_CFG.L), ("fused", "K4", HEADLINE_CFG.L),
    ("fused_hostrng", "K5", HEADLINE_CFG.L), ("pallas_cl", "K3", CL_L)])
def test_plain_hmc_path(card, backend, kernel, L):
    """run_hmc at the headline from a cold start (K3 at 32^2): one launch
    of the backend's kernel a trajectory (and one K12 after K2 or K3), no
    plain twin; <plaq> within min(0.002, 5 sigma + 1 / (beta V)) of exact,
    sigma the blocked standard error of the measured per-trajectory means
    (10 blocks) and 1 / (beta V) twice the shift of <plaq> when topology
    stays frozen at Q = 0 from the cold start (2 pi^2 <Q^2> / V^2, <Q^2> =
    V / (4 pi^2 beta)); <exp(-dH)> within 0.02 of 1; acceptance within
    ACC_MARGIN of the JAX package's at the headline, above its floor at
    CL_L^2."""
    cfg = dataclasses.replace(HEADLINE_CFG, L=L, ntraj=H_THERM + H_MEAS)
    gen = torch.Generator(device=card).manual_seed(17)
    (x, hist), launches, plain = _counted(
        lambda: run_hmc(cfg, generator=gen, backend=backend, device=card))
    expect = _expect(**{kernel: cfg.ntraj})
    if kernel in ("K2", "K3"):   # the step's epilogue, one a trajectory
        expect["K12"] = cfg.ntraj
    meas = slice(H_THERM, None)
    ptraj = hist.plaq[meas].mean(dim=1)
    stderr = float(ptraj.reshape(10, -1).mean(dim=1).std() / math.sqrt(10))
    bound = min(0.002, 5 * stderr + 1.0 / (cfg.beta * L * L))
    plaq, acc = float(ptraj.mean()), float(hist.acc[meas].mean())
    assert _finite(hist) and bool(torch.isfinite(x).all())
    assert launches == expect
    assert not any(plain.values()), plain
    assert abs(plaq - lattice.PLAQ_EXACT[cfg.beta]) <= bound, (plaq, bound)
    assert abs(float(hist.exp_mdh[meas].mean()) - 1.0) <= 0.02
    if L == HEADLINE_CFG.L:
        assert abs(acc - JAX_ACCEPTANCE) <= ACC_MARGIN, acc
    else:
        assert acc >= JAX_ACCEPTANCE - ACC_MARGIN, acc


# ---------------------------------------------------------------------------
# the dynamical paths A-G through run_hmc_dyn / run_fthmc_dyn
# ---------------------------------------------------------------------------

def _blocked(t: torch.Tensor) -> tuple[float, float]:
    """Mean and blocked standard error (10 blocks) of per-trajectory values
    (ntraj, B)."""
    per = t.mean(dim=1)
    return (float(per.mean()),
            float(per.reshape(10, -1).mean(dim=1).std() / math.sqrt(10)))


def dyn_expected(name: str, cfg, log, n_layers: int | None) -> dict:
    """The launches a run of path ``name`` must make: K1 a gauge force of
    force_evaluations (single scale: every force); with the flow K7 and K8
    a layer a force of any scale and K6 a layer an energy flow (two a
    trajectory and the start charge); one K11 launch a solve, or with the
    mixed CG one K9 / K10 residual a host read (a refinement cycle and the
    start) and one K11_bf16 a cycle."""
    n = force_evaluations(cfg)
    expect = _expect(K1=(n.get("dyn", 0) + n.get("gauge", 0)) * cfg.ntraj)
    if DYN_CG.get(name) == "mixed":
        op = "K10" if fk.resolve_layout(cfg.cg_layout, cfg.L,
                                        cfg.L) == "cl" else "K9"
        expect[op] = log.reads()
        expect["K11_bf16"] = log.reads() - log.count()
    else:
        expect["K11"] = log.count()
    if n_layers is not None:
        flows = sum(n.values()) * cfg.ntraj
        expect.update({"K6": n_layers * (2 * cfg.ntraj + 1),
                       "K7": n_layers * flows, "K8": n_layers * flows})
    return expect


@pytest.fixture(scope="module")
def dyn_runs():
    """The dynamical paths' runs, by name, for the tests that read them."""
    return {}


def _dyn_run(name, card, flagship, runs):
    """Path ``name`` through run_hmc_dyn (run_fthmc_dyn with the flow from
    z0 = f^-1(0)) on the path's CG backend, the default set back after:
    (final links, history, CGLog, launches, plain twin calls), kept in
    ``runs``."""
    if name in runs:
        return runs[name]
    cfg = DYN[name]
    therm, meas = DYN_TRAJ[name]
    cfg = dataclasses.replace(cfg, ntraj=therm + meas)
    if DYN_START[name] is None:
        params, spec, _ = flagship
        x0, _ = flow_reverse(params, torch.zeros(
            (cfg.n_chains, 2, cfg.L, cfg.L), device=card), spec)
    else:
        params = spec = None
        x0 = near_equilibrium(torch.Generator(device=card).manual_seed(
            DYN_START[name]), cfg.n_chains, cfg.L, 6.0, card)
    log = tf.CGLog()
    gen = torch.Generator(device=card).manual_seed(41)

    def run():
        tf.set_cg_backend(DYN_CG.get(name, "auto"))
        try:
            if params is None:
                return run_hmc_dyn(cfg, x0=x0, generator=gen, device=card,
                                   cg_log=log)
            return run_fthmc_dyn(params, spec, cfg, z0=x0, generator=gen,
                                 device=card, cg_log=log)
        finally:
            tf.set_cg_backend("auto")
    (x, hist), launches, plain = _counted(run)
    runs[name] = (x, hist, log, launches, plain)
    return runs[name]


@pytest.mark.parametrize("name", sorted(DYN))
def test_dynamical_path(card, flagship, dyn_runs, name):
    """Path ``name``, its launches held to dyn_expected, no plain twin, and
    its physics against the JAX package's reading: acceptance within 0.03
    of it (plain paths) or at least MIN_FT_ACCEPTANCE (FT); <plaq> within
    min(0.002, 5 sigma + 1 / (beta V)) of it (plain: sigma the blocked
    standard error of the run, 10 blocks; 1 / (beta V) the thermalization
    allowance, twice the plaquette's shift when topology stays frozen from
    the start) or 0.003 (FT); exactness: <exp(-dH)> within 0.03 of 1
    (plain) and, for FT, whose exp(-dH) has tails too heavy for a mean
    over a few hundred trajectories (single trajectories reach exp(-dH) ~
    10^3; the JAX package read 0.884 over 4096 at C), the same identity in
    a bounded form: reversibility and area preservation give p(-dH) =
    exp(-dH) p(dH), hence <(1 - exp(-dH)) h(dH)> = 0 for every even h;
    with h = exp(-|dH|) the summand lies in [-1, 1/4], and its mean must
    lie within 5 blocked standard errors of 0."""
    x, hist, log, launches, plain = _dyn_run(name, card, flagship, dyn_runs)
    ft = DYN_START[name] is None
    therm, meas = DYN_TRAJ[name]
    cfg = dataclasses.replace(DYN[name], ntraj=therm + meas)
    expect = dyn_expected(name, cfg, log,
                          flagship[1].n_layers if ft else None)
    sl = slice(therm, None)
    plaq, stderr = _blocked(hist.plaq[sl])
    acc_j, _, plaq_j = DYN_READING[name]
    bound = 0.003 if ft else min(0.002, 5 * stderr
                                 + 1.0 / (cfg.beta * cfg.L * cfg.L))
    acc = float(hist.acc[sl].mean())
    assert _finite(hist) and bool(torch.isfinite(x).all())
    assert launches == expect
    assert not any(plain.values()), plain
    if not ft:
        assert abs(acc - acc_j) <= 0.03, (acc, acc_j)
        assert abs(float(hist.exp_mdh[sl].mean()) - 1.0) <= 0.03
    else:
        dh = hist.dh[sl]
        bounded, bounded_se = _blocked(torch.where(
            dh > 0, torch.exp(-dh) - torch.exp(-2 * dh), torch.exp(dh) - 1))
        assert acc >= MIN_FT_ACCEPTANCE[name], acc
        assert abs(bounded) <= 5 * bounded_se, (bounded, bounded_se)
    assert abs(plaq - plaq_j) <= bound, (plaq, plaq_j, bound)


def test_pion_correlator_on_path_b(card, flagship, dyn_runs):
    """The pion correlator on path B's final 128 configurations (16^2,
    beta=6, m=0.1): finite and positive at every t."""
    x = _dyn_run("B", card, flagship, dyn_runs)[0]
    c = tf.pion_correlator(x, MASS, tol=1e-10).double()
    mean = c.mean(dim=0).cpu().numpy()
    assert np.isfinite(mean).all() and (mean > 0).all(), mean


def _fermion_inputs(card):
    """Near-equilibrium links at beta=6 at each shape of FERMION_SHAPES,
    their link planes and an eo plane, in the shape's layout."""
    g = torch.Generator(device=card).manual_seed(2028)
    out = {}
    for key, (B, L, cl) in FERMION_SHAPES.items():
        x = near_equilibrium(g, B, L, 6.0, card)
        even, _ = fk.parity_masks(L, L, 1, card)
        psi = torch.complex(torch.randn((B, L, L, 2), generator=g,
                                        device=card),
                            torch.randn((B, L, L, 2), generator=g,
                                        device=card))
        ur, ui = fk.link_planes(x)
        p4 = fk.pack_spinor(psi * even).contiguous()
        if cl:
            ur, ui, p4 = (t.permute(1, 2, 3, 0).contiguous()
                          for t in (ur, ui, p4))
        out[key] = (x, ur, ui, p4, cl)
    return out


def test_fused_mdagm_launches_one_operator_an_application(card):
    """The normal operator's own entry point, fused_mdagm (the counterpart
    of pallas_mdagm; K11 holds the whole solve, so it is the path that
    launches K9 and K10): at each of FERMION_SHAPES in its layout, eo, 10
    applications, one K9 or K10 launch an application and no twin, each
    result within 1e-6 x max|ref| of the twin's on the same planes."""
    n_apply = 10
    inp = _fermion_inputs(card)

    def complex_of(p4, cl):
        return fk.unpack_spinor(p4.permute(3, 0, 1, 2) if cl else p4)

    psi = {k: complex_of(p4, cl) for k, (_, _, _, p4, cl) in inp.items()}
    out, launches, plain = _counted(lambda: {
        k: [fk.fused_mdagm(x, psi[k], MASS, eo=True,
                           layout="cl" if cl else "cf")
            for _ in range(n_apply)]
        for k, (x, _, _, _, cl) in inp.items()})
    expect = _expect()
    for _, _, _, _, cl in inp.values():
        expect["K10" if cl else "K9"] += n_apply
    assert launches == expect
    assert not any(plain.values()), plain
    for k, (_, ur, ui, p4, cl) in inp.items():
        twin = fk.mdagm_cl_plain if cl else fk.mdagm_plain
        ref = complex_of(twin(ur, ui, p4, MASS, True), cl)
        err = max(float((o - ref).abs().max()) for o in out[k])
        assert err <= 1e-6 * float(ref.abs().max()), (k, err)


def test_fermion_observables_on_the_card_are_the_cpus(card):
    """chiral_condensate (8 noises) and pion_correlator on the card against
    the CPU port on the same links (16^2, 8 near-equilibrium chains) and
    the same noise: 1e-4 relative in norm (solves at 1e-10 / 1e-12)."""
    x = near_equilibrium(torch.Generator(device=card).manual_seed(61), 8, 16,
                         6.0, card)
    g = torch.Generator().manual_seed(62)
    eta = torch.complex(torch.randn((8, 8, 16, 16, 2), generator=g),
                        torch.randn((8, 8, 16, 16, 2), generator=g)) \
        * math.sqrt(0.5)

    def rel(a, b):
        return float((a.cpu() - b).abs().norm() / b.abs().norm())

    cc = tf.chiral_condensate_from(eta.to(card), x, MASS, tol=1e-10)
    cc_cpu = tf.chiral_condensate_from(eta, x.cpu(), MASS, tol=1e-10)
    pc = tf.pion_correlator(x, MASS, tol=1e-12)
    pc_cpu = tf.pion_correlator(x.cpu(), MASS, tol=1e-12)
    assert rel(cc, cc_cpu) <= 1e-4 and rel(pc, pc_cpu) <= 1e-4


# ---------------------------------------------------------------------------
# the mobility probes
# ---------------------------------------------------------------------------

def _probe_expected(kw, cfg_forces: dict, n_layers: int | None) -> dict:
    """The launches of a probe of ``kw`` whose trajectory makes the forces
    ``cfg_forces`` (by kind): K1 a gauge or single-scale force; with the
    flow K7 and K8 a layer a force and K6 a layer an energy flow (two a
    trajectory and one a block's start charge); K11 (dynamical) one a
    solve: a force's and the Metropolis solve; plain quenched HMC one K12
    a trajectory."""
    block = min(kw["call_block"], kw["ntraj"])
    blocks = -(-kw["therm"] // block) + -(-kw["ntraj"] // block)
    n = blocks * block
    forces = sum(cfg_forces.values())
    expect = _expect(K1=(cfg_forces.get("dyn", 0) + cfg_forces.get("gauge", 0)
                         + cfg_forces.get("quenched", 0)) * n)
    if kw.get("mass", 0.0) > 0:
        expect["K11"] = (forces + 1) * n
    elif n_layers is None:   # plain HMC: K12 ends each step
        expect["K12"] = n
    if n_layers is not None:
        expect.update({"K6": n_layers * (2 * n + blocks),
                       "K7": n_layers * forces * n,
                       "K8": n_layers * forces * n})
    return expect


@pytest.mark.parametrize("name", ["ft", "plain", "ft_dyn"])
def test_mobility_probe(card, flagship, name):
    """The probes at PROBE with the trained flow, each with its exact
    launch counts, no plain twin and finite timed histories: FT quenched
    (<plaq> within 0.003 of exact, <exp(-dH)> within 0.1 of 1), plain
    quenched, and FT at m = 0.1 with path C's configuration (acceptance >=
    path C's floor, <plaq> within 0.003 of the JAX package's path-C
    reading)."""
    from fthmc_tpu_torch.mobility import mobility_probe
    params, spec, _ = flagship
    n_q = {"quenched": 2 * PROBE["nstep"] + 1}
    dyn_cfg = SchwingerConfig(L=PROBE["L"], beta=PROBE["beta"], mass=MASS,
                              tau=PROBE["tau"], nstep=PROBE["nstep"],
                              n_chains=PROBE["n_chains"])
    p, s, sampler, kw, forces, seed = {
        "ft": (params, spec, "ft", PROBE_QUENCHED, n_q, 71),
        "plain": (None, None, "plain", PROBE_QUENCHED, n_q, 72),
        "ft_dyn": (params, spec, "ft", PROBE_DYN,
                   force_evaluations(dyn_cfg), 73)}[name]
    kw = {**PROBE, **kw, "sampler": sampler}
    blocks = []
    st, launches, plain = _counted(lambda: mobility_probe(
        p, s, **kw, on_block=blocks.append,
        generator=torch.Generator(card).manual_seed(seed), device=card))
    hist = TrajMetrics(*[torch.cat(f).cpu() for f in zip(*blocks)])
    assert launches == _probe_expected(kw, forces,
                                       None if p is None else len(p))
    assert not any(plain.values()), plain
    assert _finite(hist)
    if name == "ft":
        exact = lattice.PLAQ_EXACT[PROBE["beta"]]
        assert abs(st["plaq"] - exact) <= 0.003, st["plaq"]
        assert abs(float(hist.exp_mdh.mean()) - 1.0) <= 0.1
    elif name == "ft_dyn":
        assert st["acc"] >= MIN_FT_ACCEPTANCE["C"], st["acc"]
        assert abs(st["plaq"] - DYN_READING["C"][2]) <= 0.003, st["plaq"]


def test_mobility_probe_floor_extension(card):
    """A small plain probe under an event floor it cannot meet: ntraj grows
    by exactly max_extra_blocks blocks and the reading is not valid."""
    from fthmc_tpu_torch.mobility import mobility_probe
    kw = {**PROBE, **PROBE_FLOOR, "sampler": "plain"}
    st = mobility_probe(None, None, **kw,
                        generator=torch.Generator(card).manual_seed(79),
                        device=card)
    block = min(kw["call_block"], kw["ntraj"])
    grown = st["ntraj"] - -(-kw["ntraj"] // block) * block
    assert grown == kw["max_extra_blocks"] * block and not st["valid"], st


# ---------------------------------------------------------------------------
# the resilient runner, the diagnostics
# ---------------------------------------------------------------------------

def test_runner_resumes_the_flagship_bit_for_bit(card, flagship, tmp_path):
    """run_resilient over run_fthmc blocks of RUNNER_BLOCK at the flagship
    FT path ('auto': the kernels), state in a file: the first
    RUNNER_TRAJ[0] trajectories, then the same state file to
    RUNNER_TRAJ[1], bit for bit an uninterrupted run from the same
    generator seed (K6-K8 sum in a fixed order), with the launches of
    RUNNER_TRAJ[1] trajectories in blocks."""
    from fthmc_tpu_torch.runner import run_resilient
    params, spec, z0 = flagship
    lf = LeapfrogConfig(tau=FT_TAU, nstep=FT_NSTEP)

    def step(g, z, n):
        return run_fthmc(params, spec, lf, beta=FT_BETA, ntraj=n, z0=z,
                         generator=g, integrator="omelyan", device=card)

    first, total = RUNNER_TRAJ
    seed = 81
    sp = str(tmp_path / "state.npz")

    def resumed():
        run_resilient(step, z0, generator=torch.Generator(card).manual_seed(
            seed), ntraj=first, block=RUNNER_BLOCK, state_path=sp,
            max_retries=0)
        return run_resilient(
            step, z0, generator=torch.Generator(card).manual_seed(seed + 1),
            ntraj=total, block=RUNNER_BLOCK, state_path=sp, max_retries=0)
    (z_r, h_r, _), launches, _ = _counted(resumed)
    z_w, h_w, _ = run_resilient(
        step, z0, generator=torch.Generator(card).manual_seed(seed),
        ntraj=total, block=RUNNER_BLOCK, max_retries=0)
    assert torch.equal(z_r, z_w) and all(np.array_equal(h_r[k], h_w[k])
                                         for k in h_w)
    n_force = 2 * FT_NSTEP + 1
    assert launches == _expect(
        K1=n_force * total,
        K6=spec.n_layers * (2 * total + total // RUNNER_BLOCK),
        K7=spec.n_layers * n_force * total,
        K8=spec.n_layers * n_force * total)


def test_runner_watchdog_fires_on_the_card(card):
    """A host-sleeping step under block_timeout=1 and max_retries=1 raises
    BlockTimeout."""
    from fthmc_tpu_torch.runner import BlockTimeout, run_resilient

    def sleeping(g, z, n):
        time.sleep(5)
        return z, {}

    with pytest.raises(BlockTimeout):
        run_resilient(sleeping, torch.zeros((1, 2, 4, 4), device=card),
                      generator=torch.Generator(card), ntraj=2, block=2,
                      hist_fields=(), block_timeout=1, retry_sleep=0.1,
                      max_retries=1)


# A step that fires a device-side assert (an index past the end), driven by
# run_resilient with max_retries=None in a process of its own: run_resilient
# must re-raise the CUDA error and exit, not retry forever.
_ASSERT_CHILD = """
import torch
from fthmc_tpu_torch.runner import run_resilient
def step(generator, z, n):
    bad = torch.full((1,), 1 << 30, dtype=torch.long, device=z.device)
    return z + z.flatten()[bad].sum(), {}
run_resilient(step, torch.zeros((1, 2, 4, 4), device="cuda"),
              generator=torch.Generator("cuda"), ntraj=2, block=2,
              hist_fields=(), retry_sleep=0.5, max_retries=None)
print("returned")
"""


def test_runner_device_assert_ends_its_process(card):
    """A step that fires a device-side assert under max_retries=None makes
    its process exit non-zero within 120 s, without a retry."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.run([sys.executable, "-c", _ASSERT_CHILD],
                           capture_output=True, text=True, timeout=120,
                           cwd=root)
    assert child.returncode != 0 and "returned" not in child.stdout \
        and "retry" not in child.stdout \
        and "device-side assert" in child.stderr, \
        (child.returncode, child.stdout[-300:], child.stderr[-300:])


def test_diagnostics_on_the_samplers_fields(card, flagship, flagship_run):
    """The diagnostics with the trained flow on the sampler's own fields:
    z the flagship run's final latent fields (16^2 x 64, thermalized at
    beta = 6) and y = f(z). flow_inverse_residual of y below max(5e-5, 2x
    the CPU port's reading on the same flow and fields); reversibility_error
    with the kernel FT force (REV_CHAINS chains of z, REV_NSTEP steps)
    within 1e-4 of the field scale, and within that of the CPU port's
    reading on the same inputs (its plain twins);
    leapfrog_with_diagnostics against hmc.leapfrog on the same force, x
    and v within 1e-6."""
    from fthmc_tpu_torch.diagnostics import (flow_inverse_residual,
                                             leapfrog_with_diagnostics,
                                             reversibility_error)
    from fthmc_tpu_torch.ops.coupling_kernels import kernel_flow_forward
    from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel
    params, spec, _ = flagship
    z = flagship_run[0]
    g = torch.Generator(card).manual_seed(91)
    v = torch.randn(z.shape, generator=g, device=card)
    cpu = _on_cpu(params)
    with torch.no_grad():
        y, _ = kernel_flow_forward(params, z, spec)
    res = flow_inverse_residual(params, spec, y)
    res_cpu = flow_inverse_residual(cpu, spec, y.cpu())
    assert res <= max(5e-5, 2 * res_cpu), (res, res_cpu)
    dt = FT_TAU / FT_NSTEP
    zr, vr = z[:REV_CHAINS], v[:REV_CHAINS]
    with full_fp32():
        rev = reversibility_error(zr, vr, dt, REV_NSTEP, lambda zz:
                                  ft_force_kernel(params, spec, zz, FT_BETA))
    rev_cpu = reversibility_error(zr.cpu(), vr.cpu(), dt, REV_NSTEP,
                                  lambda zz: ft_force_kernel(cpu, spec, zz,
                                                             FT_BETA))
    rev_tol = 1e-4 * math.pi
    assert rev <= rev_tol and abs(rev - rev_cpu) <= rev_tol, (rev, rev_cpu)

    def force_fn(zz):
        return ft_force_kernel(params, spec, zz, FT_BETA)

    def action_fn(zz):
        yk, ld = kernel_flow_forward(params, zz, spec)
        return lattice.batch_action(yk, FT_BETA) - ld

    xd, vd, _ = leapfrog_with_diagnostics(z, v, dt, FT_NSTEP, force_fn,
                                          action_fn)
    xl, vl = leapfrog(z, v, dt, FT_NSTEP, force_fn)
    assert max(float((xd - xl).abs().max()),
               float((vd - vl).abs().max())) <= 1e-6


# ---------------------------------------------------------------------------
# the JAX package's bf16 FT-HMC recipe at 64^2
# ---------------------------------------------------------------------------

def test_bf16_flagship_recipe(card):
    """The flagship spec with bf16 convs and fresh weights at BF16_L^2 x
    BF16_CHAINS, beta=6, tau=0.5, 8 Omelyan steps from z0 = 0:
    force_backend 'auto' and 'kernel' refuse the spec; 'autograd' runs
    BF16_TRAJ trajectories, histories finite, <exp(-dH)> over the measured
    ones within 0.1 of 1, no K6-K8 launch. The flow's round trip on the
    run's final fields within max(5e-4, 2x the CPU port's on the same flow
    and fields): 5e-4 is the JAX package's bound for a 2-layer bf16 flow
    (tests/test_mixed_precision.py); at 24 layers a bf16 rounding of a
    conditioner output flips between the forward and the reverse pass
    where the bisection's 1e-6 moves its input, and the JAX package itself
    reads ~1e-3 (9.6e-4 at 16^2 on the CPU)."""
    spec = FlowSpec(n_layers=24, coupling="rncp", n_mixture=8,
                    hidden_sizes=(32, 32), s_clip=3.0, conv_dtype="bfloat16")
    params = init_flow_params(spec, torch.Generator(card).manual_seed(0),
                              device=card)
    z0 = torch.zeros((BF16_CHAINS, 2, BF16_L, BF16_L), device=card)
    for fb in ("auto", "kernel"):
        with pytest.raises(ValueError):
            resolve_force_backend(fb, spec, z0.shape, z0.dtype, card)
    therm, meas = BF16_TRAJ
    lf = LeapfrogConfig(tau=FT_TAU, nstep=FT_NSTEP)
    (z, hist), launches, _ = _counted(lambda: run_fthmc(
        params, spec, lf, beta=FT_BETA, ntraj=therm + meas, z0=z0,
        generator=torch.Generator(card).manual_seed(61),
        integrator="omelyan", force_backend="autograd", device=card))
    emdh = float(hist.exp_mdh[therm:].mean())
    assert _finite(hist)
    assert math.isfinite(emdh) and abs(emdh - 1.0) <= 0.1, emdh
    assert not any(launches[k] for k in ("K6", "K7", "K8")), launches

    def roundtrip_of(p, zz):
        with torch.no_grad(), full_fp32():
            yy, _ = flow_forward(p, zz, spec, remat=False)
        x2, _ = flow_reverse(p, yy, spec)
        return _wrapped(x2, zz)

    roundtrip = roundtrip_of(params, z)
    roundtrip_cpu = roundtrip_of(_on_cpu(params), z.cpu())
    assert roundtrip <= max(5e-4, 2 * roundtrip_cpu), \
        (roundtrip, roundtrip_cpu)
