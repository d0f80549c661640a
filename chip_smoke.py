#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fthmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. build the CUDA kernels (K1-K11) from fthmc_tpu_torch/csrc with nvcc for
     sm_90a, one nvcc per source, all at once;
  2. the card's name and power limit, as nvidia-smi gives them;
  3. each kernel against its plain PyTorch twin on the card: K1 at the
     shapes the paths give it (FT 16^2 x 64, path A 64^2 x 64, path B 16^2
     x 128, the headline 64^2 x 1024, and 20^2 x 3); K6, K7, K8 at the
     flagship FT-HMC shapes (16^2, 64 chains, 24-layer rncp, hidden
     (32, 32), 8 components, s_clip 3) on every layer of the flow (all eight
     (mu, off) masks), also at path C's (16^2, 128 chains) on every
     layer and at 64^2, 8 chains on one, TF32 off, then the whole kernel
     force chain against the autograd force; K2, K4, K5 at the plain-HMC
     headline shapes (64^2, 1024 chains, beta=6, dt=0.04, 25 steps), and
     at 128^2 and 256^2 (16 chains, bands in a cluster), and K3 at 32^2,
     8^2 and 48^2 with 1024 chains, 16^2 with 1000 and 64^2 with 16, bit
     for bit; K5 also against hmc_step's 'xla' path on the same draws;
  4. the FT-HMC path: flagship FT-HMC with the trained flow at 16^2,
     beta=6, tau=0.5, 8 Omelyan steps, 64 chains, from z0 = f^-1(0),
     through run_fthmc with the default (kernel) force backend; physics
     checks;
  5. the launch counters of that run against the path's own count;
  6. the plain-HMC paths: run_hmc at the headline configuration of
     fthmc_tpu/bench.py (64^2, beta=6, tau=1, 25 steps, 1024 chains, cold
     start) with the default backend (K2), 'fused' (K4) and 'fused_hostrng'
     (K5), and K3's 'pallas_cl' at 32^2; each run's launch counters (set to
     0 just before it) and physics checks;
  7. timings with CUDA events: every kernel and its plain twin (K1 as the
     card's time, graph_ms, at the FT, path A, path B and headline shapes
     under every band plan, beside an empty kernel's launch on the same
     grid, its floor), the
     kernel force chain against the autograd force, K6-K8 at the three shapes of
     phase 3 (launched on prepared pointers, and through their wrappers)
     beside cuDNN running the same layer's convs (a yardstick) and the
     host's microseconds a wrapper call, K6-K8 under every band plan at
     those shapes (the "band_plans" line), the flagship FT-HMC's device
     busy share over two trajectories, K2, K4 and K5 under every band plan
     (traj_plans) at 64^2 x 1024, 128^2 x 256 and 256^2 x 64 chains, each
     held against its twin, with their bounds (the "traj_plans" line), K3
     under every plan of chain tiles at 8^2-64^2 x 1024 chains, each held
     bit for bit to its twin (the "k3_plans" line), K2 against K3 over L
     and chain counts (the 'auto' rule), FT-HMC chain-steps/s, and the
     headline's chain-steps/s
     as fthmc_tpu/bench.py defines it for 'auto' and 'fused', with a
     profiler pass for the device's busy share;
  8. dynamical fermions: K9 (64^2, 64 chains; 16^2, 128 chains) and K10
     (16^2, 128 chains) against their twins, eo and not; K11, the whole CG
     solve, against its twin (cg_solve_fused_plain) and the torch 'xla' CG
     at paths A's, B's and C's shapes and at 128^2 and 256^2 (4 chains),
     both layouts, eo and not, cold and warm, two launches bit-equal and
     one launch a solve (the "compare_k11" line); K9 and K10 under every
     band plan and chain tile at the three paths' shapes, each held
     against its twin (the "fermion_band_plans" line); then paths A
     (plain dynamical HMC, 64^2, K11 + K1), B (16^2, K11 on chains-last
     planes by name + K1) and C (FT-HMC with the trained flow, 16^2, K6-K8
     + K1 + K11) through run_hmc_dyn / run_fthmc_dyn at the JAX package's
     production configurations, each with its launch counters (set to 0
     just before it: one K11 launch a solve, no operator launch) and its
     physics against the JAX package's reading (DYN_READING); the
     operator's own entry point, fused_mdagm, the path that launches K9
     and K10, with its counters (the "operator_path" line); timings of
     K9-K11 (the card's time, a CUDA graph of launches replayed; events
     beside), their twins, K11 a solve of 40 iterations and a set-up at
     A's, B's and C's shapes and under every band plan (the
     "cg_plans" line), K9 against K10 over L (the 'auto' layout rule),
     s/trajectory, chain-steps/s, CG iterations a solve, and the device
     busy share of paths A, B and C;
  9. flow training and flow sampling: K6 against its twin on every layer
     at the sampler's shapes (8^2 x 4096 chains, the exported 16-layer
     flow8x8_b2_16l_long; 8^2 x 512, the flagship's width,
     flow8x8_b3_rncp24), timed there beside its bound; one training step's
     loss and gradients at the flagship's width (batch 512) on the card
     against the CPU; the reference configuration (ncp, 16 layers, hidden
     (8, 8), 8^2, beta=2, batch 64, 1000 epochs) trained through train(),
     then generate_ensemble with 64 chains (acceptance >= 0.15, the loss
     falling); the flagship's TrainConfig from fresh weights for one era of
     100 epochs (its host synchronisations counted), save_checkpoint,
     load_checkpoint_auto and a second era (the step count and the beta
     schedule continuing); D_KL of flow8x8_b3_rncp24 at beta=3 over 8192
     draws against the JAX package's CPU reading; flow sampling with
     flow8x8_b2_16l_long (8^2, beta=2, 64 chains x 4096 samples, blocks of
     64) with its counters (set to 0 just before it: K6 exactly once a
     layer a block), acceptance against the JAX package's CPU reading,
     chain-samples/s, tau_int(Q) and effective samples/s; bench_train and
     bench_flow_sampling at their defaults;
  10. the rest of the dynamical sector: K11_bf16 (K11 on bf16 storage, the
     mixed CG's inner solve) against its twin (cg_planes_bf16_plain) at
     G's, E's and B's shapes, eo and not (sweeps within 2, d within 5e-2
     relative, two launches bit-equal; the band plans beside fp32 K11's,
     128^2 and 256^2 too); whole mixed solves (cg_solve_mixed) at G's and
     B's shapes, tol 1e-9 and 1e-12, cold and warm, each chain's fp32 true
     residual recomputed by K9 / K10 within tol, their iterations and host
     reads; paths D (nested plain HMC, 64^2), E (Hasenbusch, 32^2, m=0.02),
     F (nested FT-HMC with the trained flow, 16^2, beta=5) and G (the
     mixed CG, 64^2) through run_hmc_dyn / run_fthmc_dyn at the JAX
     package's production rows (DYN, DYN_READING), each with its launch
     counters (set to 0 just before it, held to dyn_expected: K1 a gauge
     force as force_evaluations counts them, K7/K8 a layer a force of
     either scale, one K11 launch a solve, the mixed CG one K9 a host read
     and one K11_bf16 a cycle) and its physics gates; K11_bf16 against
     fp32 K11 at 64^2 x 64 in turns (ms an iteration); s/trajectory,
     chain-steps/s, CG iterations and host reads a solve, busy shares;
     chiral_condensate and pion_correlator on the card against the CPU
     port (1e-4), and the pion correlator on path B's final 128
     configurations beside the JAX package's (pulls printed, not gated);
     fermion-aware training (ferm_mass 0.1, force_weight 0.5) at 8^2: one
     step's loss and gradients against the CPU (1e-4), then an era of 10
     epochs (eager: train.FERM_ERA_GRAPHED);
  11. the slice around the samplers: the JAX package's bf16 recipe at
     64^2 (BF16_SPEC, fresh weights, 32 chains, beta=6, 8 Omelyan steps
     from z0 = 0): 'auto' and 'kernel' refuse it, 'autograd' runs 8 + 8
     trajectories (<exp(-dH)> within 0.1 of 1, the flow's round trip on
     the final fields within 5e-4, no K6-K8 launch), and its bench beside
     fp32's (autograd, and the kernels where they take the shape); the
     mobility probes at 16^2, beta=6, 128 chains with the trained flow (FT
     quenched: <plaq> within 0.003 of exact, <exp(-dH)> within 0.1; plain;
     FT at m=0.1 with path C's gates; each with exact launch counts) and
     the floor extension, B*mob/s +- err and busy shares; run_resilient
     over run_fthmc blocks (a resumed run bit-equal to an uninterrupted
     one, the watchdog, a device-side assert that ends its process
     instead of being retried); diagnostics (the flow's inverse residual
     and reversibility against the CPU port, leapfrog_with_diagnostics
     against leapfrog); a spline flow (one step's gradients against the
     CPU, train() with one host sync an era, flow sampling through
     flow_backend='torch', 'auto' refusing it);
  12. the parallel drivers (fthmc_tpu_torch.parallel) at world size 1 on
     an NCCL group made from a HashStore (no TCP port), destroyed at the
     end: sharded_run_hmc at the headline ('auto': K2), sharded_run_fthmc
     at the flagship and sharded_run_hmc_dyn at path B, each bit-equal to
     its single-device driver run with rank_generator(g, 0) and with its
     launches (in turns, for the time); train(cfg, mesh=) for one era of
     the reference configuration against train_era on the same draws
     (the first step's loss and gradients, then the era's losses, within
     1e-5 relative); the row-sharded drivers, every halo row through the
     all-gather: one HMC step at 64^2 x 64 against hmc_step's 'xla' path
     on the same draws, a run's <exp(-dH)> within 0.05 of 1,
     ft_force_sharded at the flagship against the autograd force (1e-4 x
     max), a few row-sharded FT trajectories, and row-sharded dynamical
     HMC at the JAX package's sharded test configuration, 16^2, beta=2,
     m=0.2 (<exp(-dH)> within 0.05 of 1, <plaq> beside the JAX package's
     sharded reading 0.706-0.708), each with its s a
     trajectory beside the single-device driver's, its collectives a
     trajectory and no kernel launched;
  13. the command line (fthmc_tpu_torch.cli.main, in this process) and
     the API facade on the card, each run's launch counters set to 0 just
     before it and held to its count: `fthmc` at the flagship (the
     exported flow, 48 trajectories from a cold start; phase 4's gates,
     phase 5's launches a trajectory; s/trajectory beside phase 7's), `hmc`
     at the headline (K2 a trajectory, <exp(-dH)> within 0.05 of 1) and
     `hmc --nrun 2` at 16^2 (K3), plain `schwinger` at 16^2, beta=2, m=0.2
     through --state in two calls (the resume keeps the first call's rows;
     K11 a solve, the condensate's included; <plaq> within max(0.004, 5
     blocked errors) of the JAX package's CPU reading of the same
     protocol, 0.7110), `schwinger --ckpt` at path C's shape,
     `train` at the reference configuration then `sample` (K6 once a layer
     a block) and `fthmc` from its checkpoints, `pipeline --mode highbeta`
     with the flagship flow, one `python3 -m fthmc_tpu_torch.cli hmc`
     subprocess (exit 0), the facade's force against autograd (phase 3's
     chain tolerance) and utils.profiling.trace around two flagship
     trajectories (the trace names the coupling kernels);
  14. the entry points, each run's launch counters set to 0 just before
     it and held to its count: `python3 -m fthmc_tpu_torch.bench` at its
     defaults in a subprocess (exit 0, one stdout line, the JAX script's
     four keys; the headline and the two flagship extras' times), one
     step of entry.entry() (its force against autograd at phase 3's chain
     tolerance, dH finite), entry.dryrun_multichip(1) on one NCCL rank
     (its stages' asserts), and the three demos in this process at their
     default widths, their run lengths cut: demo_highbeta (<exp(-dH)>
     within 0.1 of 1, acceptance >= 0.5, <plaq> beside exact),
     demo_schwinger (gamma_5-hermiticity <= 1e-8, the plain leg's
     <exp(-dH)> within 0.05 of 1) and demo_2d_u1 (the HMC's and FT-HMC's
     <plaq> within max(0.004, 5 sigma) of exact);
  15. a {"kernels": [...]} JSON line, K1-K11 and K11_bf16 (K6's launches
     those of the FT path and the sampling path, K9's the operator path's
     and path G's; K1, K6-K8 and K11 with the probes', the runner's and
     phase 12's added; every kernel phases 13's and 14's);
  16. last, {"ok": true, "device": {...}}.
Any failed phase raises, so the script exits non-zero without the last line.
It needs a CUDA device and the fthmc_tpu_torch package beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.checkpoint import load_checkpoint_auto, save_checkpoint
from fthmc_tpu_torch.config import (FlowSpec, HMCConfig, LeapfrogConfig,
                                    TrainConfig)
from fthmc_tpu_torch.diagnostics import (flow_inverse_residual,
                                         leapfrog_with_diagnostics,
                                         reversibility_error,
                                         summarize_step_info)
from fthmc_tpu_torch.hmc import (TrajMetrics, ft_force, hmc_step,
                                 leapfrog, resolve_backend,
                                 resolve_force_backend, run_fthmc, run_hmc,
                                 run_leapfrog)
from fthmc_tpu_torch.mobility import mobility_probe
from fthmc_tpu_torch.models.flow import (flow_forward, flow_reverse,
                                         init_flow_params)
from fthmc_tpu_torch.models import priors
from fthmc_tpu_torch.models.masks import layer_mask_params, plaq_masks
from fthmc_tpu_torch.ops import _build, rng
from fthmc_tpu_torch.ops import fermion_kernels as fk
from fthmc_tpu_torch.ops import lattice_kernels as lk
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_kernels import (band_plan,
                                                  coupling_forward,
                                                  coupling_forward_plain,
                                                  forward_call, kernel_fits,
                                                  kernel_flow_forward,
                                                  launch_args, scratch_for,
                                                  sm_count)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (bwd_call,
                                                      coupling_bwd,
                                                      coupling_bwd_plain,
                                                      coupling_fwd_res,
                                                      coupling_fwd_res_plain,
                                                      ft_force_kernel)
from fthmc_tpu_torch.ops.lattice_kernels import force, force_plain
from fthmc_tpu_torch.schwinger import (SchwingerConfig, force_evaluations,
                                       run_fthmc_dyn, run_hmc_dyn)
from fthmc_tpu_torch import bench as tbench
from fthmc_tpu_torch import observables as tobs
from fthmc_tpu_torch import sampling as tsample
from fthmc_tpu_torch import train as ttrain
from fthmc_tpu_torch.parallel import domain as pdom
from fthmc_tpu_torch.parallel import domain_fermion as pdferm
from fthmc_tpu_torch.parallel import domain_flow as pdflow
from fthmc_tpu_torch.parallel import mesh as pmesh
from fthmc_tpu_torch.runner import BlockTimeout, run_resilient
from fthmc_tpu_torch.weights import FLAGSHIP_NPZ, load_flow_npz

B, L, BETA, TAU, NSTEP = 64, 16, 6.0, 0.5, 8
N_THERM, N_MEAS = 32, 96
TIMED_LAYER = 1               # the coupling layer the kernels are timed on
# (chains, L, layers) at which K6-K8 are held against their twins and
# timed: the flagship's shape and path C's on every layer of the flow, and
# 64^2 (8-row bands) on the timed layer; each shape a band plan of its own
COUPLING_SHAPES = {"flagship": (B, L, None), "path_C": (128, 16, None),
                   "L64": (8, 64, (TIMED_LAYER,))}
# The JAX package's own run of this configuration (trained flow, 16^2,
# beta=6, tau=0.5, 8 Omelyan steps, 64 chains, cold start, 4608 measured
# trajectories; artifacts/round3/tauint_b6_ft_t05n8.json) accepted 0.827
# with <exp(-dH)> = 0.955. A mean over 96 x 64 accept flips has a standard
# error near 0.005 if independent; 0.78 leaves room for correlation. It is
# the loosest check here: a wrong force shows first in phase 3's kernel and
# force comparisons.
MIN_ACCEPTANCE = 0.78
# The plain-HMC headline, fthmc_tpu/bench.py:42-76: 64^2, beta=6, tau=1,
# 25 steps (dt=0.04), 1024 chains, cold start; timed as 5 repeats of 20
# chained trajectories after a 20-trajectory warm-up. K3's run: 32^2, the
# same beta and dt, inside K3's envelope.
HMC_CFG = HMCConfig(beta=6.0, L=64, tau=1.0, nstep=25, n_chains=1024,
                    randinit=False, seed=0)
CL_L = 32
# K1 at the shapes the paths give it: FT (16^2 x 64), path A (64^2 x 64),
# path B (16^2 x 128), the headline's 'xla' step (64^2 x 1024), and an odd
# lattice with a ragged band (20^2 x 3), each held to its twin (phase 3),
# the first four also timed under every plan beside an empty kernel's
# launch on the same grid, its floor (phase 7)
K1_SHAPES = {"FT": (64, 16), "A": (64, 64), "B": (128, 16),
             "headline": (1024, 64), "odd": (3, 20)}
# K3 held bit-equal to its twin (phase 3): CL_L^2 x 1024, 8^2 and 48^2 at
# 1024 chains, a chain count no tile divides, and 64^2, which the old body
# could not take; K3's plans of chain tiles timed at 1024 chains at these L
# (phase 7), and K2 against K3 over L (the 'auto' rule) at 1024 chains and
# at 128 for the small lattices
K3_SHAPES = {"32^2x1024": (1024, 32), "8^2x1024": (1024, 8),
             "48^2x1024": (1024, 48), "16^2x1000": (1000, 16),
             "64^2x16": (16, 64)}
K3_PLAN_L = (8, 16, 32, 48, 64)
AUTO_RULE_SHAPES = ((1024, 8), (1024, 16), (1024, 32), (1024, 48),
                    (1024, 64), (128, 8), (128, 16))
# K2, K4 and K5 above what one CTA holds (bands in a cluster): held against
# their twins at these L with LARGE_CHAINS chains, the headline's beta, dt
# and steps; the plan sweep runs each plan of traj_plans at these (chains,
# L), each a launch of the headline's sites
LARGE_L, LARGE_CHAINS = (128, 256), 16
PLAN_SHAPES = ((1024, 64), (256, 128), (64, 256))
# K12's wide kernel (above the band plans' reach, after the K1 loop): the
# (chains, L) it is checked at in phase 3, and those it is timed at (each
# ~4x the headline's sites)
K12_WIDE_SHAPE = (4, 512)
K12_WIDE_TIMED = ((64, 512), (16, 1024))
# From the cold start the plaquette's excess over its equilibrium falls
# over some 500 trajectories (slow modes of fixed-length trajectories), so
# 600 thermalize; 1000 are measured, in 10 blocks for the error.
H_THERM, H_MEAS = 600, 1000
BENCH_NTRAJ, BENCH_REPEATS = 20, 5
# The JAX package's acceptance at the headline (BENCH_extra.json, 20
# trajectories x 1024 chains after 100 from a cold start): a physics
# reading the port must reproduce. 1000 x 1024 accept flips have a
# standard error near 0.0004 if independent; the margin leaves room for
# correlation and for the JAX reading's own 20 trajectories.
# A smaller lattice accepts more at the same dt (<dH> grows with the
# volume), so K3's 32^2 run is held to the floor only.
JAX_ACCEPTANCE, ACC_MARGIN = 0.843, 0.02
PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SOURCES = {
    "K1": ("fthmc_tpu_torch/csrc/force.cu",
           "fthmc_tpu/ops/pallas_lattice.py:53"),
    "K2": ("fthmc_tpu_torch/csrc/leapfrog.cu",
           "fthmc_tpu/ops/pallas_lattice.py:79"),
    "K3": ("fthmc_tpu_torch/csrc/leapfrog.cu",
           "fthmc_tpu/ops/pallas_lattice.py:166"),
    "K4": ("fthmc_tpu_torch/csrc/hmc_traj.cu",
           "fthmc_tpu/ops/pallas_lattice.py:268"),
    "K5": ("fthmc_tpu_torch/csrc/hmc_traj.cu",
           "fthmc_tpu/ops/pallas_lattice.py:351"),
    "K6": ("fthmc_tpu_torch/csrc/coupling_fwd.cu",
           "fthmc_tpu/ops/pallas_coupling.py:131"),
    "K7": ("fthmc_tpu_torch/csrc/coupling_fwd.cu",
           "fthmc_tpu/ops/pallas_coupling_vjp.py:182"),
    "K8": ("fthmc_tpu_torch/csrc/coupling_bwd.cu",
           "fthmc_tpu/ops/pallas_coupling_vjp.py:255"),
    "K9": ("fthmc_tpu_torch/csrc/fermion.cu",
           "fthmc_tpu/ops/pallas_fermion.py:175"),
    "K10": ("fthmc_tpu_torch/csrc/fermion.cu",
            "fthmc_tpu/ops/pallas_fermion.py:192"),
    "K11": ("fthmc_tpu_torch/csrc/fermion.cu",
            "fthmc_tpu/ops/pallas_fermion.py:321"),
    # K11 on bf16 storage: the mixed CG's inner solve, an XLA while_loop in
    # the JAX package (_cg_solve_mixed's inner), no Pallas kernel
    "K11_bf16": ("fthmc_tpu_torch/csrc/fermion.cu",
                 "fthmc_tpu/fermion.py:259"),
    # the plain step's epilogue after K2, K3 or the K1 loop: no Pallas
    # kernel, XLA fuses hmc_step's ops
    "K12": ("fthmc_tpu_torch/csrc/hmc_traj.cu", "fthmc_tpu/hmc.py:195"),
}
# Dynamical fermions (fthmc_tpu_torch.schwinger): the JAX package's own
# production runs, which used its fused CG, and what they read (acceptance,
# <exp(-dH)>, <plaq>):
#  A  artifacts/round3/schw_mts_L64b6.json, row plain:16:0:tau=2.0: 64^2,
#     beta=6, m=0.1, 64 chains, tau=2, 16 Omelyan steps, maxiter 2000;
#  B  artifacts/round3/probe_b6_plain.json, row plain:10:0:tau=2.0: 16^2,
#     128 chains, tau=2, 10 steps, maxiter 1500 (run here on K10 by name);
#  C  artifacts/round4/ferm_16b6.json, second row: FT-HMC with the trained
#     flagship flow, 16^2, 128 chains, tau=0.5, 4 steps, maxiter 1500, from
#     z0 = f^-1(0).
# All eo-preconditioned and warm-started, force solves at 1e-9 and the
# Metropolis solve at 1e-12 on |r|^2/|b|^2, the default CG backend.
MASS = 0.1
DYN = {
    "A": SchwingerConfig(L=64, beta=6.0, mass=MASS, tau=2.0, nstep=16,
                         n_chains=64, cg_tol_force=1e-9, cg_tol_mh=1e-12,
                         cg_maxiter=2000),
    "B": SchwingerConfig(L=16, beta=6.0, mass=MASS, tau=2.0, nstep=10,
                         n_chains=128, cg_tol_force=1e-9, cg_tol_mh=1e-12,
                         cg_maxiter=1500, cg_layout="cl"),
    "C": SchwingerConfig(L=16, beta=6.0, mass=MASS, tau=0.5, nstep=4,
                         n_chains=128, cg_tol_force=1e-9, cg_tol_mh=1e-12,
                         cg_maxiter=1500),
}
DYN_READING = {"A": (0.95458984375, 0.999826192855835, 0.9147999286651611),
               "B": (0.9369964599609375, 1.0002156496047974,
                     0.9148625135421753),
               "C": (0.6754817962646484, 0.884468674659729,
                     0.914852499961853)}
# (chains, L, chains-last) of the kernel comparisons: the paths' shapes
# and operators (C's 'auto' operator, K9 at 16^2)
FERMION_SHAPES = {"A": (64, 64, False), "B": (128, 16, True),
                  "C": (128, 16, False)}
# K10's chain tiles in the band-plan sweep
K10_TILES = (8, 16, 32)
# K11's comparisons: (chains, L) of paths A, B and C, and 128^2 and 256^2
# at a few chains (a cluster of bands, and device scratch), each in both
# layouts
K11_SHAPES = {"A": (64, 64), "BC": (128, 16), "L128": (4, 128),
              "L256": (4, 256)}
# K11 timed a solve of this many iterations (tol 0), cold; beside it the
# iteration of the host-loop CG it replaced (a K9 or K10 launch and an
# update launch, graph_ms on an H100 80GB HBM3 at 700 W, as PERF.md
# records it)
K11_TIMED_ITERS = 40
HOST_LOOP_ITERATION_MS = {"A": 0.0262, "B": 0.0270}
# K9 against K10 (the 'auto' layout rule): these L, this many chains
LAYOUT_RULE_L, LAYOUT_RULE_B = (8, 16, 32, 64), 128
# (thermalizing, measured) trajectories, sized against the time limit (C's
# configuration runs again in phase 11's dynamical probe)
DYN_TRAJ = {"A": (30, 60), "B": (50, 150), "C": (100, 100)}
# The rest of the dynamical sector (phase 10): the JAX package's production
# rows of its nested, Hasenbusch and mixed-CG samplers, run from a
# thermalized state that is not in the repo (here: near-equilibrium links,
# or z0 = f^-1(0) for FT, then thermalized), eo, warm-started, force solves
# at 1e-9 and the Metropolis solves at 1e-12:
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
DYN.update({
    "D": SchwingerConfig(L=64, beta=6.0, mass=MASS, tau=2.0, nstep=8,
                         n_inner=2, n_chains=64, cg_tol_force=1e-9,
                         cg_tol_mh=1e-12, cg_maxiter=2000),
    "E": SchwingerConfig(L=32, beta=6.0, mass=0.02, tau=1.0, nstep=4,
                         n_mid=2, n_inner=2, hasenbusch_dm=0.2, n_chains=64,
                         cg_tol_force=1e-9, cg_tol_mh=1e-12,
                         cg_maxiter=4000),
    "F": SchwingerConfig(L=16, beta=5.0, mass=MASS, tau=0.5, nstep=8,
                         n_inner=3, n_chains=64, cg_tol_force=1e-9,
                         cg_tol_mh=1e-12, cg_maxiter=1500),
    "G": SchwingerConfig(L=64, beta=6.0, mass=MASS, tau=2.0, nstep=12,
                         n_chains=64, cg_tol_force=1e-9, cg_tol_mh=1e-12,
                         cg_maxiter=2000)})
DYN_READING.update({"D": (0.7928059697151184, 0.9980745911598206,
                          0.9148449897766113),
                    "E": (0.9874267578125, 1.000128984451294,
                          0.9155676364898682),
                    "F": (0.7916666865348816, 0.9873201847076416,
                          0.8967482447624207),
                    "G": (0.895263671875, 1.0111162662506104,
                          0.9148247241973877)})
# (thermalizing, measured) trajectories, cut for the time limit (D was
# 30 + 60, E-G 30 + 40)
DYN_TRAJ.update({"D": (20, 40), "E": (20, 20), "F": (20, 30),
                 "G": (20, 30)})
# the CG backend of a path other than the default 'auto' (K11)
DYN_CG = {"G": "mixed"}
# FT paths: acceptance floors (C: the first port's; F: the JAX package's
# 0.79 less the margin C's gate leaves its own reading)
MIN_FT_ACCEPTANCE = {"C": 0.60, "F": 0.72}
# K11_bf16 held against its twin (chains, L, layout): G's shape (64^2,
# chains-first), E's (32^2), B's (16^2 chains-last); each eo and not
K11_BF16_SHAPES = {"G": (64, 64, "cf"), "E": (64, 32, "cf"),
                   "B": (128, 16, "cl")}
# whole mixed solves (chains, L, layout) at the force's and the Metropolis
# tolerance, their fp32 residual recomputed by K9 / K10
MIXED_SHAPES = {"G": (64, 64, "cf"), "B": (128, 16, "cl")}
# The JAX package's pion correlator on its plain 16^2, beta=6, m=0.1
# ensemble (128 configurations; artifacts/round3/pion_b6_crosscheck.json,
# "plain"): C(t) and its error, t = 0..15
JAX_PION_B6 = (
    (0.5264300107955933, 0.12561459839344025, 0.06197701394557953,
     0.035227857530117035, 0.02128889411687851, 0.01345006376504898,
     0.009099602699279785, 0.007000624667853117, 0.006377531215548515,
     0.007019390352070332, 0.009147072210907936, 0.013374602422118187,
     0.02084498666226864, 0.03425975143909454, 0.060413211584091187,
     0.12462140619754791),
    (0.0018140056636184454, 0.0007972432649694383, 0.0006234035827219486,
     0.0004501506336964667, 0.00033686906681396067, 0.000260732980677858,
     0.00020981949637643993, 0.00017777641187421978, 0.0001686097530182451,
     0.00018088241631630808, 0.00020874812616966665, 0.0002578975399956107,
     0.0003282017132733017, 0.0004068039415869862, 0.0005124892923049629,
     0.000706827559042722))
# Flow training and flow sampling (phase 9). K6 at the sampler's shapes:
# (exported flow, chains) at 8^2, held to its twin on every layer.
SAMPLER_K6 = {"16l_long": ("flow8x8_b2_16l_long", 4096),
              "flagship": ("flow8x8_b3_rncp24", 512)}
# The flagship flow's training settings (artifacts/flow8x8_b3_rncp24_ftb6
# .meta.json: 8^2, batch 512, lr 1e-3, grad_clip 1, beta annealed 2 -> 3
# over half of the steps), cut to 2 eras of 100 epochs.
FLAGSHIP_TRAIN = TrainConfig(
    L=8, beta=3.0, beta_init=2.0, beta_anneal_frac=0.5, n_era=2,
    n_epoch=100, batch_size=512, base_lr=1e-3, grad_clip=1.0, seed=7,
    flow=FlowSpec(n_layers=24, coupling="rncp", n_mixture=8,
                  hidden_sizes=(32, 32), s_clip=3.0))
# The reference configuration (fthmc_tpu/bench.py bench_train's flow: ncp,
# 16 layers, hidden (8, 8), 2 components; 8^2, beta=2, batch 64, lr 1e-3,
# TrainConfig's 10 eras of 100 epochs), then flow sampling with 64 chains:
# the JAX package read an acceptance of 0.202 after the same training, the
# reference code 0.21-0.25 (BENCH.md:1459).
REF_TRAIN = TrainConfig(L=8, beta=2.0, batch_size=64, base_lr=1e-3,
                        flow=FlowSpec(n_layers=16, n_mixture=2,
                                      hidden_sizes=(8, 8)))
MIN_TRAINED_ACCEPTANCE = 0.15
# The JAX package's readings on a CPU (tests/test_torch_sampling.py,
# jax_reference_readings): D_KL = mean(logq - logp) of flow8x8_b3_rncp24
# at 8^2, beta=3 over 8192 draws, and flow sampling with
# flow8x8_b2_16l_long at 8^2, beta=2, 64 chains x 4096 samples, blocks of
# 64.
JAX_DKL_RNCP24 = (-335.28973388671875, 0.020102684869653945)  # mean, stderr
DKL_DRAWS = 8192
JAX_SAMPLING_ACC, SAMPLING_ACC_MARGIN = 0.25147247314453125, 0.02
SAMPLING = dict(beta=2.0, L=8, batch_size=64, num_samples=4096, n_chains=64)
# Phase 11. The JAX package's FT-HMC recipe at L >= 64
# (fthmc_tpu/bench.py:111-156, bench_fthmc_flagship(L=64, chains=32,
# conv_dtype='bfloat16')): the flagship spec with bf16 convs and fresh
# weights at 64^2, 32 chains, beta=6, tau=0.5, 8 Omelyan steps from z0 = 0,
# the force by autograd (the kernels refuse bf16); (thermalizing,
# measured) trajectories, cut for the time limit (16 + 16 before); the
# bench's (trajectories a repeat, repeats).
BF16_SPEC = dataclasses.replace(FLAGSHIP_TRAIN.flow, conv_dtype="bfloat16")
BF16_L, BF16_CHAINS, BF16_TRAJ, BF16_BENCH = 64, 32, (8, 8), (1, 2)
# The mobility probes at the production selection regime
# (experiments/finetune_force.py:66-100): 16^2, beta=6, 128 chains,
# tau=0.5, 4 Omelyan steps, the trained flagship flow; the trajectories
# cut (therm, timed, call block). The dynamical probe (m=0.1) is path C's
# configuration; its blocks of 4 give exactly 52 and 64 (100 and 128
# before the cut for the time limit). The floor extension: a small plain budget under an event
# floor it cannot meet.
PROBE = dict(L=16, beta=6.0, n_chains=128, tau=0.5, nstep=4)
PROBE_QUENCHED = dict(therm=64, ntraj=256, call_block=64)
PROBE_DYN = dict(mass=MASS, therm=52, ntraj=64, call_block=4,
                 cg_maxiter=1500)
PROBE_FLOOR = dict(therm=8, ntraj=16, call_block=8, min_events=1e9,
                   max_extra_blocks=2)
# The resilient runner over run_fthmc blocks at the flagship FT path: the
# block, (trajectories before the restart, in all)
RUNNER_BLOCK, RUNNER_TRAJ = 8, (16, 32)
# Splines: the reference training configuration (REF_TRAIN) with the
# spline coupling, 8 knots, s_clip 3, cut to 2 eras of 100 epochs; flow
# sampling with (chains, samples a chain)
SPLINE_TRAIN = dataclasses.replace(
    REF_TRAIN, n_era=2, flow=FlowSpec(n_layers=16, coupling="spline",
                                      n_knots=8, hidden_sizes=(8, 8),
                                      s_clip=3.0))
SPLINE_ENSEMBLE = (64, 1024)
# reversibility_error against the CPU port: chains and steps
REV_CHAINS, REV_NSTEP = 4, 4
# Phase 12, the parallel drivers at world size 1 on an NCCL group. The
# chain-sharded runs held bit for bit to their single-device drivers:
# trajectories of the headline ('auto': K2), of the flagship FT path and
# of path B (K11 on chains-last planes).
PAR_TRAJ = {"hmc": 20, "fthmc": 6, "hmc_dyn": 4}
# the reference training configuration, one era of 100 epochs
PAR_TRAIN = dataclasses.replace(REF_TRAIN, n_era=1)
# row-sharded HMC at 64^2 x 64 chains with the headline's beta, dt and
# steps: trajectories thermalizing near-equilibrium links on one device
# ('auto', K2; the plaquette's slow modes need some 500), then row-sharded
# trajectories measured
PAR_DOMAIN_HMC = HMCConfig(beta=6.0, L=64, tau=1.0, nstep=25, n_chains=64)
PAR_DOMAIN_HMC_TRAJ = (500, 40)
# row-sharded FT-HMC with the trained flow at the flagship's shape
# (leapfrog, as the JAX domain step integrates): trajectories
PAR_DOMAIN_FT_TRAJ = 2
# row-sharded dynamical HMC at the JAX package's sharded test configuration
# (tests/test_domain_fermion.py: 16^2, beta=2, m=0.2, tau=1, 8 Omelyan
# steps, maxiter 2000; 16 chains here), where the JAX package's sharded
# run of 8 chains x 96 trajectories read <exp(-dH)> 1.000 and <plaq>
# 0.706-0.708: (trajectories thermalizing near-equilibrium links on one
# device (K11), row-sharded trajectories measured from there), the block
PAR_DOMAIN_DYN = SchwingerConfig(L=16, beta=2.0, mass=0.2, tau=1.0, nstep=8,
                                 n_chains=16, cg_maxiter=2000)
PAR_DOMAIN_DYN_TRAJ, PAR_DOMAIN_DYN_BLOCK = (40, 10), 7
PAR_DYN_PLAQ = (0.706, 0.708)
# Phase 13, the command line on the card. `fthmc` at the flagship (phase
# 4's configuration) and `hmc` at the headline (HMC_CFG), cold starts:
# trajectories (the CLI's summary drops the first quarter, which at the
# headline must cover the cold start's relaxation, some 500 trajectories:
# over trajectories 10-40 <exp(-dH)> reads 1.12); `hmc --nrun` at 16^2 x
# 64 chains: (trajectories a run, runs); plain `schwinger` at the JAX
# package's sharded test configuration (PAR_DOMAIN_DYN's physics, 64
# chains) through --state from a hot start: (trajectories of the first
# call, in all), the block, and the JAX package's reading of this
# protocol on the CPU (`python tests/test_torch_cli.py`,
# jax_reference_readings: <plaq> over the last 120 trajectories and its
# blocked standard error; the 0.706-0.708 of the JAX notes came from 8
# chains x 96 trajectories with no thermalizing cut, low); `schwinger
# --ckpt` at path C's configuration: trajectories; after `train` at the
# reference configuration, one era: `sample` (ensemble size, chains,
# block) and `fthmc` (trajectories, leapfrog steps); `pipeline --mode
# highbeta` with the flagship flow at 16^2, beta=6, tau=0.5: (FT
# trajectories, Omelyan steps, chains, plain trajectories, leapfrog steps,
# chains)
CLI_FT_TRAJ, CLI_HMC_TRAJ, CLI_NRUN = 48, 2000, (400, 2)
CLI_SCHW = dataclasses.replace(PAR_DOMAIN_DYN, n_chains=64, cg_maxiter=1000)
CLI_SCHW_TRAJ, CLI_SCHW_BLOCK = (80, 160), 40
CLI_SCHW_PLAQ = (0.7109524607658386, 0.00047828661536474844)
CLI_SCHW_FT_TRAJ = 16
CLI_SAMPLE, CLI_TRAINED_FT = (4096, 64, 64), (4, 64)
CLI_HIGHBETA = (16, 8, 64, 64, 16, 128)
# Phase 14, the entry points: the bench entry at its defaults in a
# subprocess; entry()'s step; dryrun_multichip(1); the three demos in this
# process at their default widths, their run lengths cut: demo_highbeta's
# trajectories (128 by default, ~0.5 s each), demo_schwinger's of each
# leg (512), demo_2d_u1's FT and transfer trajectories (1024, 256)
DEMO_HIGHBETA_NTRAJ = 32
DEMO_SCHWINGER_NTRAJ = 48
DEMO_2D_U1_CUT = {"ft_ntraj": 128, "transfer_ntraj": 32}


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def wrapped_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((torch.remainder(a - b + math.pi, 2 * math.pi)
                  - math.pi).abs().max())


def cuda_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``reps`` calls, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def graph_ms(make, reps: int = 20, repeats: int = 5) -> float:
    """The card's time of one launch, the host's pacing left out: a CUDA
    graph of ``reps`` launches, each bound by ``make()`` on the capturing
    stream, replayed and timed as cuda_ms times a call (median of
    ``repeats`` replays after one warm-up), over reps. A bound launch a
    call costs the host ~10 us (ctypes), as long as the fermion kernels at
    16^2 take, so cuda_ms of back-to-back calls times the host there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        make()()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch = make()
        for _ in range(reps):
            launch()
    return cuda_ms(graph.replay, reps=1, repeats=repeats) / reps


def _dilate(m: np.ndarray) -> np.ndarray:
    """Sites within one step (3x3, periodic) of a site of ``m``."""
    return np.logical_or.reduce([np.roll(m, (dy, dx), axis=(0, 1))
                                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def _taps(need: np.ndarray, nonzero: np.ndarray) -> int:
    """(site, tap) pairs of a periodic 3x3 conv whose output site is in
    ``need`` and whose input site is in ``nonzero``."""
    return sum(int((need & np.roll(nonzero, (dy, dx), axis=(0, 1))).sum())
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def coupling_macs(widths, mu: int, off: int, lat: int = L) -> dict:
    """Conv multiply-adds per chain that one coupling layer's outputs depend
    on, from its stripe masks. Forward (K6, K7): the raw conditioner output
    is read on the active stripe only, each earlier conv's output where the
    next conv reads it (one site further out) and, for K7, also where K8
    reads it as an activation gate; every input may be nonzero (the cos
    channel is 1 off the frozen stripe). K8: cotangents enter the
    transposed chain on the active stripe and spread one site a conv; the
    chain's result is read on the frozen stripe (the conditioner's input),
    each earlier transposed conv's where the next one reads it."""
    frozen, active, _ = (m.astype(bool) for m in plaq_masks((lat, lat), mu,
                                                            off))
    n = len(widths) - 1
    need_in = [frozen]          # where conv l's input cotangent is read
    for _ in range(1, n):
        need_in.append(_dilate(need_in[-1]))
    nz_out = [active] * n       # where conv l's output cotangent may be != 0
    for li in range(n - 2, -1, -1):
        nz_out[li] = _dilate(nz_out[li + 1])
    k6, k7 = [active] * n, [active] * n     # where conv l's output is read
    for li in range(n - 2, -1, -1):
        k6[li] = _dilate(k6[li + 1])
        k7[li] = _dilate(k7[li + 1]) | (need_in[li + 1] & nz_out[li])
    cc = [widths[li] * widths[li + 1] for li in range(n)]
    return {"K6": sum(c * 9 * int(m.sum()) for c, m in zip(cc, k6)),
            "K7": sum(c * 9 * int(m.sum()) for c, m in zip(cc, k7)),
            "K8": sum(c * _taps(need_in[li], nz_out[li])
                      for li, c in enumerate(cc))}


def bounds(spec, layer_params: int, mu: int, off: int) -> dict:
    """Least time (ms) the card could take for each kernel's work at the
    flagship shapes, layer (mu, off): the larger of bytes / peak bandwidth
    (each input read once, each output written once) and flops / peak fp32
    rate. The coupling kernels' flops are the conv multiply-adds (2 flops
    each) that their outputs depend on (``coupling_macs``); their
    elementwise transform work is not counted."""
    widths = [2, *spec.hidden_sizes, 2 * spec.n_mixture + 1]
    sites = B * L * L
    field = 4 * 2 * sites                      # one (B, 2, L, L) fp32 field
    macs = coupling_macs(widths, mu, off)
    resid = 4 * sites * sum(widths[1:])
    weights = 4 * layer_params                 # one layer's convs
    work = {
        "K1": (2 * field, 8 * sites),          # P, sin, 2 subs, 2 muls a site
        "K6": (2 * field + weights + 4 * B, 2 * B * macs["K6"]),
        "K7": (2 * field + weights + 4 * B + resid, 2 * B * macs["K7"]),
        "K8": (3 * field + weights + 4 * B + resid, 2 * B * macs["K8"]),
    }
    return {k: _bound(nbytes, flops) for k, (nbytes, flops) in work.items()}


def _bound(nbytes: int, flops: int) -> dict:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "bytes": nbytes, "flops": flops}


# Operations a site of the trajectory kernels' bodies does
# (csrc/traj_common.cuh, csrc/philox.cuh), counting sinf, cosf and logf as
# 20 each and sqrtf as 4 (their range reduction and polynomial), and
# Philox's integer operations at the fp32 rate (a lower rate would only
# raise the bound):
STEP_OPS = 35        # a step: plaquette 3, sinf 20, force 4, kick 4, drift 4
HALF_DRIFT_OPS = 8   # the two half drifts: 2 links x 2 ops x 2
ENERGY_OPS = 64      # 2 plaquettes 6, 2 cosf 40, 2 sums; kinetic 2 x 4;
                     # wrap and select 2 x 4
DRAW_OPS = 310       # 2 momenta x (Philox4x32-10 100, 2 uniforms 8, logf,
                     # sqrtf, cosf 44, 3 muls)
EPILOGUE_OPS = 78    # K12: 2 plaquettes 6, 2 cosf 40, wraps of 2 links and
                     # 2 plaquettes 16, kinetic 2 x 4, 6 sums, select 2


def traj_bounds(B: int, L: int, nstep: int) -> dict:
    """Least time (ms) of K2-K5 for B chains of L^2 sites over nstep steps,
    and of K12 after one: the larger of bytes / peak bandwidth (each input
    read once, each output written once) and the operations above / peak
    fp32 rate. K4 draws each momentum once (and keeps it for the kinetic
    term)."""
    sites = B * L * L
    field = 4 * 2 * sites                      # one (B, 2, L, L) fp32 field
    lf = sites * (STEP_OPS * nstep + HALF_DRIFT_OPS)
    work = {"K2": (4 * field, lf),             # x, v in; x', v' out
            "K3": (4 * field, lf),
            "K4": (2 * field + 4 + 8 * B,      # x, seed in; x', dh, acc out
                   lf + sites * (ENERGY_OPS + DRAW_OPS)),
            "K5": (3 * field + 12 * B,         # x, v0, u in; x', dh, acc out
                   lf + sites * ENERGY_OPS),
            # x, x1, v1, v0, u, q_old in; x', the (6, B) rows out
            "K12": (5 * field + 32 * B, sites * EPILOGUE_OPS)}
    return {k: _bound(nbytes, flops) for k, (nbytes, flops) in work.items()}


def coupling_inputs(g: torch.Generator, B: int, L: int, dev):
    """Uniform links x, cotangents gy (links) and gl (logJ) of B chains."""
    x = (torch.rand((B, 2, L, L), generator=g, device=dev) * 2 - 1) * math.pi
    gy = torch.randn((B, 2, L, L), generator=g, device=dev)
    gl = torch.randn((B,), generator=g, device=dev)
    return x, gy, gl


def compare_coupling(params, spec, x, gy, gl, layers=None) -> dict:
    """K6, K7, K8 against their twins on ``layers`` (default every layer,
    so every (mu, off) of the path): (error, tolerance) pairs by kernel.
    fx within 1e-4 wrapped, logJ 1e-4 x max(1, max|ref|), each residual
    1e-4 x max(1, max|ref|), gx 2e-3 x max(1, max|ref|); K6's and K7's
    logJ equal (one kernel, a fixed summation order)."""
    pairs = {"K6": [], "K7": [], "K8": []}
    for li in (range(len(params)) if layers is None else layers):
        layer, (mu, off) = params[li], layer_mask_params(li)
        fx, lj = coupling_forward(layer, x, mu, off, spec)
        fx_p, lj_p = coupling_forward_plain(layer, x, mu, off, spec)
        lscale = max(1.0, float(lj_p.abs().max()))
        pairs["K6"] += [(wrapped_err(fx, fx_p), 1e-4),
                        (float((lj - lj_p).abs().max()), 1e-4 * lscale)]
        fx7, lj7, res = coupling_fwd_res(layer, x, mu, off, spec)
        fx7_p, lj7_p, res_p = coupling_fwd_res_plain(layer, x, mu, off, spec)
        require(torch.equal(lj, lj7), f"K6 and K7 logJ differ, layer {li}")
        pairs["K7"] += [(wrapped_err(fx7, fx7_p), 1e-4),
                        (float((lj7 - lj7_p).abs().max()), 1e-4 * lscale)]
        pairs["K7"] += [(float((r - r_p).abs().max()),
                         1e-4 * max(1.0, float(r_p.abs().max())))
                        for r, r_p in zip(res, res_p)]
        gx = coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
        gx_p = coupling_bwd_plain(layer, x, res_p, gy, gl, mu, off, spec)
        pairs["K8"].append((float((gx - gx_p).abs().max()),
                            2e-3 * max(1.0, float(gx_p.abs().max()))))
    for k, pr in pairs.items():
        require(all(e <= t for e, t in pr), f"{k} vs plain: {pr}")
    return pairs


def conv_chain_cudnn_ms(layer, B: int, L: int, dev) -> float:
    """A yardstick only, never called by the port: one layer's convs as
    cuDNN F.conv2d calls on circularly padded inputs, TF32 off, no
    activations (no single library call computes K6-K8)."""
    h = torch.randn((B, 2, L, L), device=dev)

    def run():
        a = h
        for p in layer:
            a = F.conv2d(F.pad(a, (1, 1, 1, 1), mode="circular"), p["w"],
                         p["b"])
        return a
    with full_fp32():
        return cuda_ms(run)


def coupling_card_ms(layer, spec, x, gy, gl, mu: int, off: int,
                     plan=None) -> dict:
    """The card's time (ms) of K6, K7 and K8 on one layer under the band
    plan ``plan`` (C, row0), by default band_plan's: each launched through
    ``forward_call`` / ``bwd_call`` on outputs allocated once, as the FT
    force and the energy flows launch them, so no wrapper's host time paces
    the loop."""
    a = launch_args("chip_smoke K6-K8 timing", layer, x, spec, plan)
    fx, logj, gx = torch.empty_like(x), x.new_empty(a.B), torch.empty_like(x)
    res = tuple(x.new_empty(s) for s in a.res_shapes)
    _keep, scratch = scratch_for(a, x)
    rp, stream = _build.ptr_array(res), _build.stream_handle(x)
    ptrs = (x.data_ptr(), fx.data_ptr(), logj.data_ptr())
    return {"K6": cuda_ms(lambda: forward_call(a, *ptrs, None, scratch, mu,
                                               off, stream)),
            "K7": cuda_ms(lambda: forward_call(a, *ptrs, rp, scratch, mu,
                                               off, stream)),
            "K8": cuda_ms(lambda: bwd_call(a, x.data_ptr(), gy.data_ptr(),
                                           gl.data_ptr(), gx.data_ptr(), rp,
                                           scratch, mu, off, stream))}


def coupling_wrapper_ms(layer, spec, x, gy, gl, mu: int, off: int) -> dict:
    """K6, K7 and K8 timed through their public wrappers (new outputs every
    call, the host's time included where it exceeds the card's), as the
    kernels' first CUDA versions were timed."""
    _, _, res = coupling_fwd_res(layer, x, mu, off, spec)
    return {"K6": cuda_ms(lambda: coupling_forward(layer, x, mu, off, spec)),
            "K7": cuda_ms(lambda: coupling_fwd_res(layer, x, mu, off, spec)),
            "K8": cuda_ms(lambda: coupling_bwd(layer, x, res, gy, gl, mu, off,
                                               spec))}


def band_plan_sweep(layer, spec, cin, mu: int, off: int, n_sm: int) -> dict:
    """coupling_card_ms under every band plan of C = 1, 2, 4, 8 even bands
    (of at least 2 rows) at each shape of COUPLING_SHAPES, beside the C
    band_plan picks: the measurement behind band_plan's rule."""
    out = {}
    for name, (cb, cl, _) in COUPLING_SHAPES.items():
        row = {"chains": cb, "L": cl, "picked": band_plan(cl, cb, n_sm)[0]}
        for C in (1, 2, 4, 8):
            if cl // C >= 2:
                plan = (C, tuple(r * cl // C for r in range(C + 1)))
                row[C] = coupling_card_ms(layer, spec, *cin[name], mu, off,
                                          plan)
        out[name] = row
    return out


def host_us_per_call(fn, n: int = 200) -> float:
    """Host time of one call (enqueue, no synchronize inside), over n."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def near_equilibrium(g: torch.Generator, B: int, L: int, beta: float,
                     dev) -> torch.Tensor:
    """Links with Gaussian angles of variance 1 / (4 beta), so a plaquette
    (four links) has about the variance of beta's equilibrium: trajectories
    from here are accepted or rejected as the main path's are."""
    return torch.randn((B, 2, L, L), generator=g, device=dev) / \
        math.sqrt(4 * beta)


def traj_check(what: str, got, ref, x0, v0, u, cfg) -> dict:
    """K4/K5-style output (x', dH, acc) against a reference on the same
    draws: dH within ``dh_tolerance``, the accept equal except where u lies
    within that of exp(-dH), x' (wrapped) within 1e-4 where it is equal."""
    tol = lk.dh_tolerance(x0, v0, cfg.beta, cfg.dt, cfg.nstep)
    (xk, dhk, acck), (xp, dhp, accp) = got, ref
    torch.cuda.synchronize()
    err = (dhk - dhp).abs()
    same = acck == accp
    border = (u - torch.exp(-dhp)).abs() <= tol * torch.exp(-dhp)
    out = {"dh_max_abs_err": float(err.max()),
           "dh_err_over_tolerance": float((err / tol).max()),
           "dh_tolerance_min": float(tol.min()),
           "accepted": int(accp.sum()), "accept_flips": int((~same).sum()),
           "x_max_wrapped_err": wrapped_err(xk[same], xp[same])}
    require(bool((err <= tol).all()), f"{what} dH: {out}")
    require(bool((same | border).all()), f"{what} accept: {out}")
    require(out["x_max_wrapped_err"] <= 1e-4, f"{what} x: {out}")
    return out


def leapfrog_check(what: str, got, ref) -> dict:
    """K2's output (x', v') against the twin's: x' within 1e-4
    wrapped, v' within 1e-4 x max|v'| (the kernels repeat the twin op for
    op)."""
    torch.cuda.synchronize()
    ex = wrapped_err(got[0], ref[0])
    ev = float((got[1] - ref[1]).abs().max())
    out = {"x_max_wrapped_err": ex, "v_max_abs_err": ev,
           "v_tolerance": 1e-4 * float(ref[1].abs().max())}
    require(ex <= 1e-4 and ev <= out["v_tolerance"], f"{what} vs plain: {out}")
    return out


def traj_inputs(g: torch.Generator, B: int, L: int, dev):
    """Near-equilibrium links, momenta, accept draws and a K4 seed."""
    x = near_equilibrium(g, B, L, HMC_CFG.beta, dev)
    v = torch.randn(x.shape, generator=g, device=dev)
    u = torch.rand((B,), generator=g, device=dev)
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=g, device=dev,
                         dtype=torch.int32)
    return x, v, u, seed


def check_band_kernels(x, v, u, seed, plan=None) -> dict:
    """K2, K5 and K4 under ``plan`` (default: traj_plan's) against their
    twins at the headline's beta, dt and steps."""
    cfg = HMC_CFG
    args = (cfg.beta, cfg.dt, cfg.nstep)
    B, _, L, _ = x.shape
    out = {"K2": leapfrog_check("K2", lk.leapfrog(x, v, *args, plan=plan),
                                lk.leapfrog_plain(x, v, *args)),
           "K5": traj_check("K5", lk.hmc_traj_hostrng(x, v, u, *args,
                                                      plan=plan),
                            lk.hmc_traj_hostrng_plain(x, v, u, *args),
                            x, v, u, cfg)}
    v4, u4 = rng.momenta(seed, B, L), rng.accept_uniforms(seed, B)
    out["K4"] = traj_check("K4", lk.hmc_traj(x, seed, *args, plan=plan),
                           lk.hmc_traj_plain(x, seed, *args), x, v4, u4, cfg)
    return out


def compare_large_lattices(dev) -> dict:
    """Phase 3: K2, K4, K5 at LARGE_L (bands in a cluster) against their
    twins, LARGE_CHAINS chains from near-equilibrium links."""
    g = torch.Generator(device=dev).manual_seed(2028)
    out = {}
    for L in LARGE_L:
        inp = traj_inputs(g, LARGE_CHAINS, L, dev)
        n_sm = sm_count(torch.cuda.current_device())
        out[L] = {"chains": LARGE_CHAINS,
                  "plans": {k: list(lk.traj_plan(L, LARGE_CHAINS, n_sm, k))
                            for k in ("K2", "K4", "K5")},
                  **check_band_kernels(*inp)}
    return out


def traj_plan_sweep(dev, n_sm: int) -> dict:
    """Phase 7: K2, K4 and K5 under every plan of traj_plans at each of
    PLAN_SHAPES, each held against its twin, then timed (card ms, CUDA
    events), beside the plan traj_plan picks and the bounds."""
    cfg = HMC_CFG
    args = (cfg.beta, cfg.dt, cfg.nstep)
    g = torch.Generator(device=dev).manual_seed(2029)
    out = {}
    for B, L in PLAN_SHAPES:
        x, v, u, seed = traj_inputs(g, B, L, dev)
        row = {"chains": B, "L": L,
               "picked": {k: list(lk.traj_plan(L, B, n_sm, k))
                          for k in ("K2", "K4", "K5")},
               "bound_ms": {k: b["bound_ms"] for k, b in
                            traj_bounds(B, L, cfg.nstep).items()
                            if k != "K3"},
               "plans": []}
        for plan in lk.traj_plans(L):
            check_band_kernels(x, v, u, seed, plan)
            row["plans"].append({
                "plan": list(plan),
                "K2": cuda_ms(lambda: lk.leapfrog(x, v, *args, plan=plan)),
                "K4": cuda_ms(lambda: lk.hmc_traj(x, seed, *args,
                                                  plan=plan)),
                "K5": cuda_ms(lambda: lk.hmc_traj_hostrng(x, v, u, *args,
                                                          plan=plan))})
        out[f"{L}^2"] = row
    return out


def k12_wide_times(dev) -> dict:
    """Phase 7: K12's wide kernel (above the band plans' reach) after a
    trajectory of the K1 loop at each of K12_WIDE_TIMED, held against its
    fp64 twin, then timed (card ms, CUDA events), beside its bound: six
    fields of traffic (four read, the chosen one read again, x_new
    written)."""
    cfg = HMC_CFG
    g = torch.Generator(device=dev).manual_seed(2031)
    out = {}
    for B, L in K12_WIDE_TIMED:
        x, v, u, _ = traj_inputs(g, B, L, dev)
        x1, v1 = run_leapfrog(x, v, cfg.beta, cfg.dt, cfg.nstep,
                              backend="xla", device=dev)
        q = torch.zeros(B, device=dev)
        field = 4 * 2 * B * L * L
        out[f"{L}^2 x {B}"] = {
            "check": k12_check(x, x1, v1, v, u, q, cfg.beta),
            "K12": cuda_ms(lambda: lk.hmc_epilogue(x, x1, v1, v, u, q,
                                                   cfg.beta)),
            **_bound(6 * field + 32 * B, B * L * L * EPILOGUE_OPS)}
    return out


def k12_plan_sweep(dev, n_sm: int) -> dict:
    """Phase 7: K12 after a K2 trajectory under every plan of traj_plans at
    each of PLAN_SHAPES, each held against its fp64 twin, then timed (card
    ms, CUDA events), beside the plan traj_plan picks and the bound."""
    cfg = HMC_CFG
    g = torch.Generator(device=dev).manual_seed(2030)
    out = {}
    for B, L in PLAN_SHAPES:
        x, v, u, _ = traj_inputs(g, B, L, dev)
        x1, v1 = lk.leapfrog(x, v, cfg.beta, cfg.dt, cfg.nstep)
        q = torch.zeros(B, device=dev)
        row = {"chains": B, "L": L,
               "picked": list(lk.traj_plan(L, B, n_sm, "K12")),
               "bound_ms": traj_bounds(B, L, cfg.nstep)["K12"]["bound_ms"],
               "plans": []}
        for plan in lk.traj_plans(L):
            k12_check(x, x1, v1, v, u, q, cfg.beta, plan)
            row["plans"].append({"plan": list(plan), "K12": cuda_ms(
                lambda: lk.hmc_epilogue(x, x1, v1, v, u, q, cfg.beta,
                                        plan=plan))})
        out[f"{L}^2"] = row
    return out


def compare_k1(dev) -> tuple[float, float, dict]:
    """Phase 3: K1 at each of K1_SHAPES (uniform links) against its twin,
    within 1e-4 x max(1, max|F|) (PERF.md section 2), and two launches
    bit-equal. Returns (worst error, tightest tolerance, by shape)."""
    g = torch.Generator(device=dev).manual_seed(2030)
    out = {}
    for name, (b, n) in K1_SHAPES.items():
        x = (torch.rand((b, 2, n, n), generator=g, device=dev) * 2 - 1) \
            * math.pi
        got, ref = force(x, BETA), force_plain(x, BETA)
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        out[name] = {"chains": b, "L": n, "plan": list(lk.force_plan(n)),
                     "max_abs_err": float((got - ref).abs().max()),
                     "tolerance": tol, "bit_equal": torch.equal(got, ref),
                     "repeat_bit_equal": torch.equal(got, force(x, BETA))}
        require(out[name]["max_abs_err"] <= tol
                and out[name]["repeat_bit_equal"], f"K1 {name}: {out[name]}")
    return (max(r["max_abs_err"] for r in out.values()),
            min(r["tolerance"] for r in out.values()), out)


def k3_check(what: str, x, v, plan=None) -> float:
    """K3 (under ``plan``) against its twin at the headline's beta, dt and
    steps: bit-equal, and two launches bit-equal. Returns the largest
    difference (0.0)."""
    args = (HMC_CFG.beta, HMC_CFG.dt, HMC_CFG.nstep)
    got = lk.leapfrog_cl(x, v, *args, plan=plan)
    again = lk.leapfrog_cl(x, v, *args, plan=plan)
    ref = lk.leapfrog_cl_plain(x, v, *args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    require(all(torch.equal(a, b) for a, b in zip(got, ref)),
            f"K3 {what} plan {plan}: not bit-equal to its twin (max diff "
            f"{err})")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"K3 {what} plan {plan}: two launches differ")
    return err


def compare_k3(dev) -> dict:
    """Phase 3: K3 at each of K3_SHAPES from near-equilibrium links,
    bit-equal to its twin (k3_check)."""
    g = torch.Generator(device=dev).manual_seed(2031)
    n_sm = sm_count(torch.cuda.current_device())
    out = {}
    for name, (b, n) in K3_SHAPES.items():
        x = near_equilibrium(g, b, n, HMC_CFG.beta, dev)
        v = torch.randn(x.shape, generator=g, device=dev)
        out[name] = {"chains": b, "L": n,
                     "plan": list(lk.traj_plan(n, b, n_sm, "K3")),
                     "max_abs_err": k3_check(name, x, v)}
    return out


def k3_plan_sweep(dev, n_sm: int) -> dict:
    """Phase 7: K3 under every plan of traj_plans(L, K3_TILES) at
    K3_PLAN_L x 1024 chains, each held bit-equal to its twin, then timed as
    the card's time (graph_ms: at 8^2 and 16^2 back-to-back wrapper calls
    time the host's call), beside K2's and the bound."""
    cfg = HMC_CFG
    args = (cfg.beta, cfg.dt, cfg.nstep)
    g = torch.Generator(device=dev).manual_seed(2032)
    out = {}
    for n in K3_PLAN_L:
        x = near_equilibrium(g, cfg.n_chains, n, cfg.beta, dev)
        v = torch.randn(x.shape, generator=g, device=dev)
        row = {"chains": cfg.n_chains, "L": n,
               "picked": list(lk.traj_plan(n, cfg.n_chains, n_sm, "K3")),
               "bound_ms": traj_bounds(cfg.n_chains, n,
                                       cfg.nstep)["K3"]["bound_ms"],
               "K2_ms": graph_ms(lambda: lambda: lk.leapfrog(x, v, *args)),
               "plans": []}
        for plan in lk.traj_plans(n, lk.K3_TILES):
            k3_check(f"{n}^2", x, v, plan)
            row["plans"].append({"plan": list(plan), "ms": graph_ms(
                lambda: lambda: lk.leapfrog_cl(x, v, *args, plan=plan))})
        out[f"{n}^2"] = row
    return out


def auto_rule_sweep(dev) -> dict:
    """Phase 7: K2 against K3 at AUTO_RULE_SHAPES, default plans, as the
    card's time (graph_ms; the verdict, "faster") and through their
    wrappers (CUDA events over back-to-back calls, host-bound at 8^2 and
    16^2), and what 'auto' picks."""
    cfg = HMC_CFG
    args = (cfg.beta, cfg.dt, cfg.nstep)
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for b, n in AUTO_RULE_SHAPES:
        x = near_equilibrium(g, b, n, cfg.beta, dev)
        v = torch.randn(x.shape, generator=g, device=dev)
        r = {"auto": resolve_backend("auto", "leapfrog", x.dtype, dev,
                                     x.shape)}
        for k, fn in (("K2", lk.leapfrog), ("K3", lk.leapfrog_cl)):
            r[k] = cuda_ms(lambda: fn(x, v, *args))
            r[k + "_graph"] = graph_ms(lambda: lambda: fn(x, v, *args))
        r["faster"] = min(("K2", "K3"), key=lambda k: r[k + "_graph"])
        r["rule_agrees"] = (r["auto"] == "pallas_cl") == (r["faster"] == "K3")
        out[f"{n}^2x{b}"] = r
    return out


def k1_timings(dev) -> dict:
    """Phase 7: K1 at the first four of K1_SHAPES (near-equilibrium links):
    the card's time (graph_ms; events over back-to-back calls time the
    host's ctypes call at 16^2) under the default plan and every plan of
    force_plans(L), each held to its twin, an empty kernel's launch on the
    default plan's grid in the same harness (the floor), events beside,
    and the bound (2 fields moved, 8 flops a site)."""
    lib = _build.library("force")
    out = {}
    for name in ("FT", "A", "B", "headline"):
        b, n = K1_SHAPES[name]
        xs = near_equilibrium(torch.Generator(device=dev).manual_seed(53), b,
                              n, BETA, dev)
        ref = force_plain(xs, BETA)
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        plan = lk.force_plan(n)

        def empty():
            a = (-(-n // plan.rows), b, plan.threads,
                 _build.stream_handle(xs))
            return lambda: _build.check(lib.ft_empty_launch(*a),
                                        "empty kernel", lib)
        by_plan = []
        for p in lk.force_plans(n):
            err = float((force(xs, BETA, plan=p) - ref).abs().max())
            require(err <= tol, f"K1 {name} plan {p}: {err}")
            by_plan.append({"plan": list(p), "graph_ms": graph_ms(
                lambda p=p: lambda: force(xs, BETA, plan=p))})
        sites = b * n * n
        out[name] = {
            "chains": b, "L": n, "plan": list(plan),
            "graph_ms": graph_ms(lambda: lambda: force(xs, BETA)),
            "floor_graph_ms": graph_ms(empty),
            "event_ms": cuda_ms(lambda: force(xs, BETA)),
            "plain_ms": cuda_ms(lambda: force_plain(xs, BETA)),
            **_bound(2 * 4 * 2 * sites, 8 * sites), "by_plan": by_plan}
    return out


def k12_check(x, x1, v1, v0, u, q_old, beta, plan=None) -> dict:
    """K12 against its twin run in float64 on the same fp32 inputs: dH
    within lk.epilogue_dh_tolerance (2^-19 of beta sum|cos P1 - cos P0| +
    beta sum(|sin P0| + |sin P1|) + 1/2 sum|(v1 - v0)(v1 + v0)|), the
    accept equal wherever log u lies further than the dH gap (and 1e-6)
    from -dH, and the largest plaquette and charge gaps where the accept is
    equal. Beside them the share of chains on which the control, the
    twin's dH with each cos P rounded to bfloat16, breaks that bound."""
    got = lk.hmc_epilogue(x, x1, v1, v0, u, q_old, beta, plan=plan)
    d = [t.double().cpu() for t in (x, x1, v1, v0, u, q_old)]
    xr, rr = lk.hmc_epilogue_plain(*d, beta)
    tol = lk.epilogue_dh_tolerance(*d[:4], beta)
    c0, c1 = (lk._plaq_of(f).cos().bfloat16().double()
              for f in (d[0], torch.remainder(d[1] + math.pi, 2 * math.pi)
                        - math.pi))
    ctrl = (-beta * (c1 - c0).sum((1, 2))
            + 0.5 * ((d[2] - d[3]) * (d[2] + d[3])).sum((1, 2, 3)))
    rk = got[1].double().cpu()
    decided = ((torch.log(d[4]) + rr[0]).abs()
               > (rk[0] - rr[0]).abs() + 1e-6)
    same = rk[2] == rr[2]
    r = {"dh_max_abs_err": float((rk[0] - rr[0]).abs().max()),
         "dh_within_tolerance": bool(((rk[0] - rr[0]).abs() <= tol).all()),
         "dh_tolerance_min": float(tol.min()),
         "bf16_cos_control_over_tolerance": float(
             ((ctrl - rr[0]).abs() > tol).double().mean()),
         "decided": int(decided.sum()), "chains": len(decided),
         "acc_flips_decided": int((rk[2] != rr[2])[decided].sum()),
         "x_max_wrapped_err": wrapped_err(got[0].cpu()[same], xr[same]),
         "plaq_max_abs_err": float((rk[3] - rr[3]).abs()[same].max()),
         "q_max_abs_err": float((rk[4] - rr[4]).abs()[same].max())}
    require(r["dh_within_tolerance"] and r["acc_flips_decided"] == 0
            and r["x_max_wrapped_err"] < 1e-5 and r["q_max_abs_err"] < 0.01,
            f"K12 vs its fp64 twin: {r}")
    return r


def compare_trajectory_kernels(dev):
    """Phase 3, plain HMC: K2, K4, K5 at the headline shapes, each against
    its plain twin from near-equilibrium links (K3: compare_k3); K5
    against hmc_step's 'xla' path (the torch loop with K1) on the same
    generator draws; K12 after K2's trajectory against its fp64 twin.
    Returns (errors, tolerances, details, inputs, with K3's timed CL_L^2
    links and momenta)."""
    cfg = HMC_CFG
    B, L, beta, dt, n = cfg.n_chains, cfg.L, cfg.beta, cfg.dt, cfg.nstep
    g = torch.Generator(device=dev).manual_seed(2027)
    x, v, u, seed = traj_inputs(g, B, L, dev)
    x3 = near_equilibrium(g, B, CL_L, beta, dev)
    v3 = torch.randn(x3.shape, generator=g, device=dev)
    info = {"K2": leapfrog_check("K2", lk.leapfrog(x, v, beta, dt, n),
                                 lk.leapfrog_plain(x, v, beta, dt, n))}
    errs = {"K2": max(info["K2"]["x_max_wrapped_err"],
                      info["K2"]["v_max_abs_err"])}
    tols = {"K2": min(1e-4, info["K2"]["v_tolerance"])}
    info["K5"] = traj_check("K5", lk.hmc_traj_hostrng(x, v, u, beta, dt, n),
                            lk.hmc_traj_hostrng_plain(x, v, u, beta, dt, n),
                            x, v, u, cfg)
    v4, u4 = rng.momenta(seed, B, L), rng.accept_uniforms(seed, B)
    info["K4"] = traj_check("K4", lk.hmc_traj(x, seed, beta, dt, n),
                            lk.hmc_traj_plain(x, seed, beta, dt, n),
                            x, v4, u4, cfg)
    # K5 against hmc_step('xla') from the same generator state: both draw
    # v0 = randn(x.shape), then u = rand(B)
    xa, _, ma = hmc_step(torch.Generator(device=dev).manual_seed(11), x,
                         torch.zeros(B, device=dev), beta, dt, n,
                         backend="xla", device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    va = torch.randn(x.shape, generator=gen, device=dev)
    ua = torch.rand((B,), generator=gen, device=dev)
    info["K5_vs_xla_hmc_step"] = traj_check(
        "K5 vs hmc_step('xla')", lk.hmc_traj_hostrng(x, va, ua, beta, dt, n),
        (xa, ma.dh, ma.acc), x, va, ua, cfg)
    for k in ("K4", "K5"):
        errs[k], tols[k] = (info[k]["dh_max_abs_err"],
                            info[k]["dh_tolerance_min"])
    x1, v1 = lk.leapfrog(x, v, beta, dt, n)
    info["K12"] = k12_check(x, x1, v1, v, u, torch.zeros(B, device=dev),
                            beta)
    # above the band plans' reach, after the K1 loop: K12's wide kernel
    xw, vw, uw, _ = traj_inputs(g, *K12_WIDE_SHAPE, dev)
    x1w, v1w = run_leapfrog(xw, vw, beta, dt, n, backend="xla", device=dev)
    info["K12_wide"] = k12_check(xw, x1w, v1w, vw, uw,
                                 torch.zeros(len(uw), device=dev), beta)
    errs["K12"] = max(info[k]["dh_max_abs_err"] for k in ("K12", "K12_wide"))
    tols["K12"] = min(info[k]["dh_tolerance_min"]
                      for k in ("K12", "K12_wide"))
    return errs, tols, info, (x, v, u, seed, x3, v3)


def plain_hmc_runs(dev) -> dict:
    """Phase 6: each plain-HMC path through run_hmc, its launch counters
    set to 0 just before it and read just after, and its physics: <plaq>
    within min(0.002, 5 sigma + 1 / (beta V)) of the exact value, sigma the
    blocked standard error of the run's per-trajectory means (10 blocks)
    and 1 / (beta V) twice the shift of <plaq> when topology stays frozen
    at Q=0 from the cold start (2 pi^2 <Q^2> / V^2, <Q^2> = V / (4 pi^2
    beta)); <exp(-dH)> within 0.02 of 1; acceptance within ACC_MARGIN of
    the JAX package's at the headline, above its floor at CL_L^2."""
    runs = {}
    for backend, kernel, L in (("auto", "K2", HMC_CFG.L),
                               ("fused", "K4", HMC_CFG.L),
                               ("fused_hostrng", "K5", HMC_CFG.L),
                               ("pallas_cl", "K3", CL_L)):
        cfg = dataclasses.replace(HMC_CFG, L=L, ntraj=H_THERM + H_MEAS)
        gen = torch.Generator(device=dev).manual_seed(17)
        _build.reset_counts()
        t0 = time.perf_counter()
        x, hist = run_hmc(cfg, generator=gen, backend=backend, device=dev)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        expect = {k: cfg.ntraj if k == kernel else 0 for k in _build.KERNELS}
        if kernel in ("K2", "K3"):   # the step's epilogue, one a trajectory
            expect["K12"] = cfg.ntraj
        meas = slice(H_THERM, None)
        ptraj = hist.plaq[meas].mean(dim=1)
        stderr = float(ptraj.reshape(10, -1).mean(dim=1).std()
                       / math.sqrt(10))
        excess = (hist.plaq.mean(dim=1).reshape(-1, 100).mean(dim=1)
                  - lattice.PLAQ_EXACT[cfg.beta])
        bound = min(0.002, 5 * stderr + 1.0 / (cfg.beta * L * L))
        r = {"backend": backend, "kernel": kernel, "L": L,
             "chains": cfg.n_chains, "beta": cfg.beta, "tau": cfg.tau,
             "nstep": cfg.nstep, "therm": H_THERM, "measured": H_MEAS,
             "acceptance": float(hist.acc[meas].mean()),
             "plaq": float(ptraj.mean()), "plaq_stderr_blocked": stderr,
             "plaq_bound": bound, "plaq_exact": lattice.PLAQ_EXACT[cfg.beta],
             "exp_mdh": float(hist.exp_mdh[meas].mean()),
             "plaq_first_traj": float(hist.plaq[0].mean()),
             "plaq_excess_by_100_traj": excess.tolist(),
             "run_s": t_run, "launches": launches, "plain_calls": plain}
        say("hmc", **r)
        require(all(bool(torch.isfinite(t).all()) for t in hist)
                and bool(torch.isfinite(x).all()), f"{backend}: not finite")
        require(launches == expect, f"{backend} launches {launches}")
        require(not any(plain.values()), f"{backend}: plain twins ran")
        require(abs(r["plaq"] - r["plaq_exact"]) <= bound,
                f"{backend} plaq {r['plaq']} vs {r['plaq_exact']}")
        require(abs(r["exp_mdh"] - 1.0) <= 0.02,
                f"{backend} <exp(-dH)> {r['exp_mdh']}")
        if L == HMC_CFG.L:
            require(abs(r["acceptance"] - JAX_ACCEPTANCE) <= ACC_MARGIN,
                    f"{backend} acceptance {r['acceptance']}")
        else:
            require(r["acceptance"] >= JAX_ACCEPTANCE - ACC_MARGIN,
                    f"{backend} acceptance {r['acceptance']}")
        runs[kernel] = r
    return runs


def headline_rate(dev, backend: str) -> dict:
    """Chain-steps/s of run_hmc at the headline as fthmc_tpu/bench.py
    defines it: chains x ntraj x nstep / the median of BENCH_REPEATS runs of
    BENCH_NTRAJ trajectories, each from the last one's state, after a
    warm-up run; each run ends in a reduction read on the host."""
    cfg = dataclasses.replace(HMC_CFG, ntraj=BENCH_NTRAJ)
    x, _ = run_hmc(cfg, backend=backend, device=dev)
    float(x.sum())
    times = []
    for i in range(BENCH_REPEATS):
        gen = torch.Generator(device=dev).manual_seed(1000 + i)
        t0 = time.perf_counter()
        x, hist = run_hmc(cfg, x0=x, generator=gen, backend=backend,
                          device=dev)
        float(x.sum())
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"chain_steps_per_s": cfg.n_chains * cfg.ntraj * cfg.nstep / med,
            "s_per_traj": med / cfg.ntraj, "times_s": times,
            "acceptance": float(hist.acc.mean())}


def profile_busy(run, ntraj: int, s_per_traj: float) -> dict:
    """The card's kernel time over ``run()`` (ntraj trajectories), from
    torch.profiler, as a share of ``s_per_traj`` x ntraj, an unprofiled
    wall time (the profiler's own host cost stretches the profiled wall
    time, also reported), and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        # the device-side mirrors of host spans (the samplers'
        # ``fthmc.step`` ranges) are no device work
        rows = [(e.key, e.self_device_time_total) for e in events
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        host = sorted(((e.key, e.self_cpu_time_total, e.count)
                       for e in events), key=lambda r: -r[1])[:6]
    except (RuntimeError, AttributeError) as e:
        return {"busy_share": "not measured", "error": repr(e)}
    rows = sorted([r for r in rows if r[1] > 0], key=lambda r: -r[1])
    busy_s = sum(t for _, t in rows) / 1e6
    if busy_s == 0:
        return {"busy_share": "not measured", "error": "no device time"}
    return {"busy_share": busy_s / (s_per_traj * ntraj),
            "busy_share_profiled": busy_s / wall,
            "device_s_per_traj": busy_s / ntraj, "kernels": len(rows),
            "top_ms_per_traj": {k[:60]: t / 1e3 / ntraj
                                for k, t in rows[:6]},
            "host_top_ms_and_calls_per_traj": {
                k[:60]: [t / 1e3 / ntraj, n / ntraj] for k, t, n in host}}


def device_busy(dev, backend: str, s_per_traj: float) -> dict:
    """profile_busy of one BENCH_NTRAJ-trajectory headline run against
    ``s_per_traj`` from headline_rate."""
    cfg = dataclasses.replace(HMC_CFG, ntraj=BENCH_NTRAJ)
    x, _ = run_hmc(cfg, backend=backend, device=dev)
    torch.cuda.synchronize()
    return profile_busy(lambda: run_hmc(cfg, x0=x, backend=backend,
                                        device=dev), cfg.ntraj, s_per_traj)


# ---------------------------------------------------------------------------
# dynamical fermions: K9, K10, K11 and paths A, B, C
# ---------------------------------------------------------------------------

# the kernels' wrapper and plain twin
OPERATORS = {"K9": (fk.mdagm, fk.mdagm_plain),
             "K10": (fk.mdagm_cl, fk.mdagm_cl_plain)}


def _complex_field(g: torch.Generator, B: int, L: int, dev) -> torch.Tensor:
    return torch.complex(torch.randn((B, L, L, 2), generator=g, device=dev),
                         torch.randn((B, L, L, 2), generator=g, device=dev))


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.permute(1, 2, 3, 0).contiguous()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().norm() / b.abs().norm())


def fermion_inputs(dev):
    """Near-equilibrium links at beta=6 at each shape of FERMION_SHAPES,
    their link planes and planes (even-masked for eo), in the shape's
    layout."""
    g = torch.Generator(device=dev).manual_seed(2028)
    out = {}
    for key, (B, L, chains_last) in FERMION_SHAPES.items():
        x = near_equilibrium(g, B, L, 6.0, dev)
        even, _ = fk.parity_masks(L, L, 1, dev)
        psi = _complex_field(g, B, L, dev)
        ur, ui = fk.link_planes(x)
        p4 = {eo: fk.pack_spinor(psi * even if eo else psi).contiguous()
              for eo in (True, False)}
        if chains_last:
            ur, ui = _cl(ur), _cl(ui)
            p4 = {eo: _cl(v) for eo, v in p4.items()}
        out[key] = {"x": x, "ur": ur, "ui": ui, "p4": p4,
                    "cl": chains_last}
    return out


def _worst(pairs):
    """The (error, tolerance) pair nearest its tolerance."""
    return max(pairs, key=lambda et: et[0] / et[1])


def compare_fermion(dev, inp) -> tuple[dict, dict, dict]:
    """K9 (paths A's and C's shapes) and K10 (path B's) against their
    twins, eo and not: 1e-6 x max|ref| (they repeat the twins' arithmetic
    op for op)."""
    errs, tols, info = {}, {}, {}
    for key, d in inp.items():
        k = "K10" if d["cl"] else "K9"
        op, plain = OPERATORS[k]
        pairs = []
        for eo in (True, False):
            got = op(d["ur"], d["ui"], d["p4"][eo], MASS, eo)
            ref = plain(d["ur"], d["ui"], d["p4"][eo], MASS, eo)
            torch.cuda.synchronize()
            pairs.append((float((got - ref).abs().max()),
                          1e-6 * float(ref.abs().max())))
        info[f"{k}_{key}"] = pairs
        require(all(e <= t for e, t in pairs), f"{k} {key} vs plain: "
                f"{pairs}")
        errs[k], tols[k] = _worst(pairs + ([(errs[k], tols[k])]
                                           if k in errs else []))
    return errs, tols, info


def compare_k11(dev) -> tuple[float, float, dict]:
    """K11, the whole solve, against its twin (cg_solve_fused_plain) and
    the torch 'xla' CG at each shape of K11_SHAPES (near-equilibrium links
    at beta = 6, phi from the heatbath), in both layouts, eo and not, cold
    and warm (from a 20-iteration solve), tol 1e-9, maxiter 2000:
    solutions within 1e-3 relative in norm (two fp32 CGs stopped at a
    relative residual of 3e-5 on operators of condition up to ~10^3),
    iters within 1 (rsq may cross its stop one iteration apart), rsq <=
    tol; max|x - x_twin| within 1e-3 max|x_twin| at every case; two
    launches bit-equal; one K11 launch a solve and no other. Returns the
    (max|x - x_twin|, 1e-3 max|x_twin|) pair nearest its tolerance and the
    cases."""
    g = torch.Generator(device=dev).manual_seed(2029)
    cases, pairs = {}, []
    one = dict.fromkeys(_build.KERNELS, 0) | {"K11": 2}
    for key, (B, n) in K11_SHAPES.items():
        x = near_equilibrium(g, B, n, 6.0, dev)
        for eo in (True, False):
            phi, _ = tf.pf_refresh(torch.Generator(device=dev).manual_seed(3),
                                   x, MASS, eo=eo)
            for layout in ("cf", "cl"):
                kw = dict(tol=1e-9, maxiter=2000, eo=eo, layout=layout)
                warm = fk.cg_solve_fused(x, phi, MASS, tol=1e-9, maxiter=20,
                                         eo=eo, layout=layout).x
                for start, x0 in (("cold", None), ("warm", warm)):
                    _build.reset_counts()
                    k = [fk.cg_solve_fused(x, phi, MASS, x0, **kw)
                         for _ in (0, 1)]
                    launches = dict(_build.LAUNCHES)
                    t = fk.cg_solve_fused_plain(x, phi, MASS, x0, **kw)
                    xla = tf.cg_solve(x, phi, MASS, x0, tol=1e-9,
                                      maxiter=2000, eo=eo, backend="xla")
                    r = {"iters": [k[0].iters, t.iters, xla.iters],
                         "rel_vs_twin": _rel(k[0].x, t.x),
                         "rel_vs_xla": _rel(k[0].x, xla.x),
                         "bit_equal": torch.equal(k[0].x, k[1].x)
                         and torch.equal(k[0].rsq, k[1].rsq),
                         "rsq_max": [float(v.rsq.max()) for v in (k[0], t,
                                                                  xla)],
                         "plan": list(fk.cg_plan(eo, B, n, n, dev)[:3])}
                    name = f"{key}_{layout}_{'eo' if eo else 'full'}_{start}"
                    cases[name] = r
                    pairs.append((float((k[0].x - t.x).abs().max()),
                                  1e-3 * float(t.x.abs().max())))
                    require(pairs[-1][0] <= pairs[-1][1],
                            f"K11 max|x - x_twin| {name}: {pairs[-1]}")
                    require(r["rel_vs_twin"] <= 1e-3
                            and r["rel_vs_xla"] <= 1e-3, f"K11 {name}: {r}")
                    require(abs(k[0].iters - t.iters) <= 1
                            and abs(k[0].iters - xla.iters) <= 1,
                            f"K11 iters {name}: {r}")
                    require(max(r["rsq_max"]) <= 1e-9, f"K11 rsq {name}: {r}")
                    require(r["bit_equal"], f"K11 repeat {name}: {r}")
                    require(launches == one,
                            f"K11 launches {name}: {launches}")
    err, tol = _worst(pairs)
    return err, tol, cases


def operator_path(inp, n_apply: int = 10) -> dict:
    """The normal operator's own entry point, fused_mdagm (the counterpart
    of pallas_mdagm; since K11 holds the whole solve, it is the path that
    launches K9 and K10): at each shape of FERMION_SHAPES in its layout
    (K9 chains-first at A's and C's, K10 chains-last at B's), eo,
    ``n_apply`` applications to the shape's complex field, the launch
    counters set to 0 just before and read just after (one K9 or K10
    launch an application, no twin), each result held against the twin's
    on the same planes within 1e-6 x max|ref|."""
    def complex_of(p4, cl):
        return fk.unpack_spinor(p4.permute(3, 0, 1, 2) if cl else p4)

    psi = {k: complex_of(d["p4"][True], d["cl"]) for k, d in inp.items()}
    _build.reset_counts()
    out = {k: [fk.fused_mdagm(d["x"], psi[k], MASS, eo=True,
                              layout="cl" if d["cl"] else "cf")
               for _ in range(n_apply)] for k, d in inp.items()}
    torch.cuda.synchronize()
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    expect = dict.fromkeys(_build.KERNELS, 0)
    for d in inp.values():
        expect["K10" if d["cl"] else "K9"] += n_apply
    errs = {}
    for k, d in inp.items():
        twin = OPERATORS["K10" if d["cl"] else "K9"][1]
        ref = complex_of(twin(d["ur"], d["ui"], d["p4"][True], MASS, True),
                         d["cl"])
        errs[k] = max(float((o - ref).abs().max()) for o in out[k])
        require(errs[k] <= 1e-6 * float(ref.abs().max()),
                f"fused_mdagm {k}: {errs[k]}")
    r = {"applications": n_apply, "launches": launches, "expected": expect,
         "plain_calls": plain, "max_abs_err": errs}
    say("operator_path", **r)
    require(launches == expect, f"operator path launches {launches}")
    require(not any(plain.values()), "operator path: plain twins ran")
    return r


def fermion_plan_sweep(inp, n_sm: int) -> dict:
    """K9 and K10 under every band plan of C = 1, 2, 4, 8 even bands of >= 2
    rows (K10 under each chain tile of K10_TILES too; a band over the
    shared-memory limit runs from device scratch) at each shape of
    FERMION_SHAPES, eo: the card's ms of a launch (graph_ms), beside the
    plan and tile the wrappers pick; each plan's output held against the
    twin within 1e-6 x max|ref| first."""
    out = {}
    for key, d in inp.items():
        B, n, _ = FERMION_SHAPES[key]
        planes = {d["cl"]: (d["ur"], d["ui"], d["p4"][True])}
        other = ((lambda t: t.permute(3, 0, 1, 2).contiguous()) if d["cl"]
                 else _cl)
        planes[not d["cl"]] = tuple(other(t) for t in planes[d["cl"]])
        C9 = fk.fermion_band_plan(n, B, n_sm)[0]
        C10 = fk.fermion_band_plan(n, B, n_sm, fk.K10_TILE)[0]
        row = {"chains": B, "L": n, "picked": {"K9": C9,
                                               "K10": [fk.K10_TILE, C10]},
               "K9": {}, "K10": {}}
        worst = 0.0
        for cl in (False, True):
            k = "K10" if cl else "K9"
            ur, ui, p4 = planes[cl]
            ref = OPERATORS[k][1](ur, ui, p4, MASS, True)
            tol = 1e-6 * float(ref.abs().max())
            for C in (1, 2, 4, 8):
                if n // C < 2:
                    continue
                plan = (C, tuple(r * n // C for r in range(C + 1)))
                for tile in (K10_TILES if cl else (None,)):
                    def make(plan=plan, tile=tile):
                        return fk.operator_launch(cl, ur, ui, p4, MASS, True,
                                                  None, None, plan, tile)[0]
                    launch, got = fk.operator_launch(cl, ur, ui, p4, MASS,
                                                     True, None, None, plan,
                                                     tile)
                    launch()
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    require(err <= tol, f"{k} {key} plan {plan} tile {tile}"
                            f": {err} > {tol}")
                    worst = max(worst, err / tol)
                    name = f"{tile}x{C}" if cl else str(C)
                    row[k][name] = graph_ms(make)
        row["max_err_over_tol"] = worst
        out[key] = row
    return out


def _blocked(t: torch.Tensor) -> tuple[float, float]:
    """Mean and blocked standard error (10 blocks) of per-trajectory values
    (ntraj, B)."""
    per = t.mean(dim=1)
    return (float(per.mean()),
            float(per.reshape(10, -1).mean(dim=1).std() / math.sqrt(10)))


def _run_dyn(name: str, cfg, x0, gen, dev, params=None, spec=None,
             log=None):
    """run_hmc_dyn (run_fthmc_dyn with the flow) of ``cfg`` on the path's
    CG backend (DYN_CG, else the default), the default set back after."""
    tf.set_cg_backend(DYN_CG.get(name, "auto"))
    try:
        if params is None:
            return run_hmc_dyn(cfg, x0=x0, generator=gen, device=dev,
                               cg_log=log)
        return run_fthmc_dyn(params, spec, cfg, z0=x0, generator=gen,
                             device=dev, cg_log=log)
    finally:
        tf.set_cg_backend("auto")


def dyn_expected(name: str, cfg, log, n_layers: int | None) -> dict:
    """The launches a run of path ``name`` must make: K1 a gauge force of
    force_evaluations (single scale: every force); with the flow K7 and K8
    a layer a force of any scale and K6 a layer an energy flow (two a
    trajectory and the start charge); one K11 launch a solve, or with the
    mixed CG one K9 / K10 residual a host read (a refinement cycle and the
    start) and one K11_bf16 a cycle."""
    n = force_evaluations(cfg)
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect["K1"] = (n.get("dyn", 0) + n.get("gauge", 0)) * cfg.ntraj
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


def dyn_path(name: str, dev, x0, params=None, spec=None):
    """Path ``name`` of DYN through run_hmc_dyn (or run_fthmc_dyn with the
    flow), its launch counters set to 0 just before it and read just after
    and held to dyn_expected, and its physics against the JAX package's
    reading: acceptance within 0.03 of it (plain paths) or at least
    MIN_FT_ACCEPTANCE (FT); <plaq> within min(0.002, 5 sigma + 1 / (beta
    V)) of it (plain: sigma the blocked standard error of the run, 10
    blocks; 1 / (beta V) the thermalization allowance, twice the
    plaquette's shift when topology stays frozen from the start) or 0.003
    (FT); exactness: <exp(-dH)> within 0.03 of 1 (plain) and, for FT,
    whose exp(-dH) has tails too heavy for a mean over a few hundred
    trajectories (single trajectories reach exp(-dH) ~ 10^3; the JAX
    package read 0.884 over 4096 at C), the same identity in a bounded
    form: reversibility and area preservation give p(-dH) = exp(-dH)
    p(dH), hence <(1 - exp(-dH)) h(dH)> = 0 for every even h; with h =
    exp(-|dH|) the summand lies in [-1, 1/4], and its mean must lie within
    5 blocked standard errors of 0. <exp(-dH)> of FT is printed beside the
    JAX package's. Returns (the path's line, its final links)."""
    cfg = DYN[name]
    therm, meas = DYN_TRAJ[name]
    cfg = dataclasses.replace(cfg, ntraj=therm + meas)
    log = tf.CGLog()
    gen = torch.Generator(device=dev).manual_seed(41)
    _build.reset_counts()
    t0 = time.perf_counter()
    x, hist = _run_dyn(name, cfg, x0, gen, dev, params, spec, log)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    layout = fk.resolve_layout(cfg.cg_layout, cfg.L, cfg.L)
    expect = dyn_expected(name, cfg, log,
                          None if params is None else len(params))
    sl = slice(therm, None)
    ptraj = hist.plaq[sl].mean(dim=1)
    stderr = float(ptraj.reshape(10, -1).mean(dim=1).std() / math.sqrt(10))
    acc_j, emdh_j, plaq_j = DYN_READING[name]
    blocks = hist.plaq.mean(dim=1).reshape(10, -1).mean(dim=1) - plaq_j
    allowance = 1.0 / (cfg.beta * cfg.L * cfg.L)
    bound = 0.003 if params is not None else min(0.002,
                                                 5 * stderr + allowance)
    emdh = hist.exp_mdh[sl].mean(dim=1)
    dh = hist.dh[sl]
    bounded, bounded_se = _blocked(torch.where(
        dh > 0, torch.exp(-dh) - torch.exp(-2 * dh), torch.exp(dh) - 1))
    r = {"path": name, "L": cfg.L, "chains": cfg.n_chains, "beta": cfg.beta,
         "mass": cfg.mass, "tau": cfg.tau, "nstep": cfg.nstep,
         "n_inner": cfg.n_inner, "n_mid": cfg.n_mid,
         "hasenbusch_dm": cfg.hasenbusch_dm,
         "cg_backend": DYN_CG.get(name, "auto"),
         "forces_per_traj": force_evaluations(cfg),
         "layout": layout, "ft": params is not None, "therm": therm,
         "measured": meas, "acceptance": float(hist.acc[sl].mean()),
         "exp_mdh": float(hist.exp_mdh[sl].mean()),
         "exp_mdh_stderr_blocked": float(emdh.reshape(10, -1).mean(dim=1)
                                         .std() / math.sqrt(10)),
         "exp_mdh_median": float(hist.exp_mdh[sl].median()),
         "exp_mdh_max": float(hist.exp_mdh[sl].max()),
         "exp_mdh_by_block": (emdh.reshape(10, -1).mean(dim=1)).tolist(),
         "bounded_identity": bounded, "bounded_identity_se": bounded_se,
         "plaq": float(ptraj.mean()), "plaq_stderr_blocked": stderr,
         "plaq_bound": bound, "jax_reading": DYN_READING[name],
         "plaq_excess_by_block": blocks.tolist(),
         "plaq_first_traj": float(hist.plaq[0].mean()),
         "cg_iters_mean": {k: log.mean_iters(k) for k in log.solves},
         "cg_solves": log.count(), "cg_iterations": log.launched(),
         "cg_host_reads": log.reads(),
         "run_s": t_run, "s_per_traj": t_run / cfg.ntraj,
         "chain_steps_per_s": cfg.n_chains * cfg.nstep * cfg.ntraj / t_run,
         "launches": launches, "expected": expect, "plain_calls": plain}
    say("dyn_path", **r)
    require(all(bool(torch.isfinite(t).all()) for t in hist)
            and bool(torch.isfinite(x).all()), f"path {name}: not finite")
    require(launches == expect, f"path {name} launches {launches}")
    require(not any(plain.values()), f"path {name}: plain twins ran")
    if params is None:
        require(abs(r["acceptance"] - acc_j) <= 0.03,
                f"path {name} acceptance {r['acceptance']} vs {acc_j}")
        require(abs(r["exp_mdh"] - 1.0) <= 0.03,
                f"path {name} <exp(-dH)> {r['exp_mdh']}")
    else:
        require(r["acceptance"] >= MIN_FT_ACCEPTANCE[name],
                f"path {name} acceptance {r['acceptance']}")
        require(abs(bounded) <= 5 * bounded_se,
                f"path {name} <(1 - exp(-dH)) exp(-|dH|)> {bounded} "
                f"+- {bounded_se}")
    require(abs(r["plaq"] - plaq_j) <= bound,
            f"path {name} plaq {r['plaq']} vs {plaq_j} (bound {bound})")
    return r, x


def fermion_timings(dev, inp) -> dict:
    """Times (ms) of K9 at paths A's and C's shapes and K10 at path B's
    (``operator_by_shape``, each beside its bound): the card's (graph_ms of
    bound launches) and, as the first ports timed them, CUDA events over
    back-to-back bound launches (``event_ms``, host-paced where a launch is
    shorter than the host's ctypes call); their twins; and K9 against K10
    at L in LAYOUT_RULE_L, LAYOUT_RULE_B chains, the card's times in turns
    (K9, K10, K10, K9), which set the 'auto' layout rule. ``kernel_ms``
    holds K9 at A and K10 at B."""
    out = {"kernel_ms": {}, "plain_ms": {}, "operator_by_shape": {}}
    for key, d in inp.items():
        B, n, _ = FERMION_SHAPES[key]
        k = "K10" if d["cl"] else "K9"
        plain = OPERATORS[k][1]

        def make(d=d):
            return fk.operator_launch(d["cl"], d["ur"], d["ui"],
                                      d["p4"][True], MASS, True, None,
                                      None)[0]
        row = {"kernel": k, "chains": B, "L": n, "kernel_ms": graph_ms(make),
               "event_ms": cuda_ms(make()),
               "plain_ms": cuda_ms(lambda: plain(d["ur"], d["ui"],
                                                 d["p4"][True], MASS, True),
                                   reps=3),
               **fermion_bounds(B, n)[k]}
        out["operator_by_shape"][key] = row
        if key == "C":
            continue
        out["kernel_ms"][k] = row["kernel_ms"]
        out["plain_ms"][k] = row["plain_ms"]
    g = torch.Generator(device=dev).manual_seed(6)
    rule = {}
    for n in LAYOUT_RULE_L:
        x = near_equilibrium(g, LAYOUT_RULE_B, n, 6.0, dev)
        ur, ui = fk.link_planes(x)
        even, _ = fk.parity_masks(n, n, 1, dev)
        p4 = fk.pack_spinor(_complex_field(g, LAYOUT_RULE_B, n, dev) * even) \
            .contiguous()
        lay = {"K9": (False, ur, ui, p4),
               "K10": (True, _cl(ur), _cl(ui), _cl(p4))}
        times = {"K9": [], "K10": []}
        for k in ("K9", "K10", "K10", "K9"):
            cl, *planes = lay[k]
            times[k].append(graph_ms(lambda cl=cl, planes=planes:
                                     fk.operator_launch(cl, *planes, MASS,
                                                        True, None,
                                                        None)[0]))
        rule[n] = {"K9": min(times["K9"]), "K10": min(times["K10"]),
                   "readings": times,
                   "auto": fk.resolve_layout("auto", n, n)}
    out["k9_vs_k10_ms_by_L"] = rule
    return out


def _k11_planes(x, eo: bool, cl: bool, seed: int = 3):
    """Link planes and a heatbath phi's planes of links x in a layout."""
    phi, _ = tf.pf_refresh(torch.Generator(device=x.device).manual_seed(seed),
                           x, MASS, eo=eo)
    ur, ui = fk.link_planes(x)
    b4 = fk.pack_spinor(phi).contiguous()
    if cl:
        ur, ui, b4 = _cl(ur), _cl(ui), _cl(b4)
    return phi, (ur, ui, b4)


def _k11_maker(planes, cl: bool, maxiter: int, plan=None):
    """(make, x): make() binds K11's launch of a cold eo solve of tol 0
    (every iteration up to maxiter runs) into x."""
    ur, ui, b4 = planes
    B = b4.shape[-1] if cl else b4.shape[0]
    x = torch.empty_like(b4)
    rel = torch.empty(B, device=b4.device)
    counters = torch.zeros(3, dtype=torch.int32, device=b4.device)

    def make():
        return fk.cg_launch(cl, ur, ui, b4, None, MASS, True, 0.0, maxiter,
                            x, rel, counters, None, plan)
    return make, x


def k11_timings(dev, inp) -> dict:
    """K11 at paths A's, B's and C's shapes, eo, cold: the card's ms of a
    solve of K11_TIMED_ITERS iterations (tol 0) and of its set-up alone
    (maxiter 0) by graph_ms, events over back-to-back launches beside, the
    ms an iteration (their difference over the iterations) beside the
    host-loop CG's iteration, the twin's solve, the bound; and every plan
    (C = 1, 2, 4, 8 bands of >= 2 rows) by graph_ms, each plan's x held
    against the twin's within 1e-3 relative first (the "cg_plans" line)."""
    n = K11_TIMED_ITERS
    out, sweep = {}, {}
    for key, d in inp.items():
        B, L, cl = FERMION_SHAPES[key]
        phi, planes = _k11_planes(d["x"], True, cl)
        layout = "cl" if cl else "cf"
        twin = fk.cg_solve_fused_plain(d["x"], phi, MASS, tol=0.0,
                                       maxiter=n, eo=True, layout=layout)
        ref = fk.pack_spinor(twin.x)
        ref = _cl(ref) if cl else ref.contiguous()
        make, _ = _k11_maker(planes, cl, n)
        make0, _ = _k11_maker(planes, cl, 0)
        solve, setup = graph_ms(make, reps=5), graph_ms(make0, reps=5)
        out[key] = {
            "chains": B, "L": L, "layout": layout,
            "plan": list(fk.cg_plan(True, B, L, L, dev)[:3]),
            "iterations": n, "solve_ms": solve, "setup_ms": setup,
            "iteration_ms": (solve - setup) / n,
            "host_loop_iteration_ms": HOST_LOOP_ITERATION_MS.get(key),
            "solve_event_ms": cuda_ms(make(), reps=5),
            "plain_ms": cuda_ms(lambda: fk.cg_solve_fused_plain(
                d["x"], phi, MASS, tol=0.0, maxiter=n, eo=True,
                layout=layout), reps=1, repeats=3),
            **fermion_bounds(B, L, n)["K11"]}
        row = {}
        for C in (1, 2, 4, 8):
            if L // C < 2:
                continue
            plan = (C, tuple(r * L // C for r in range(C + 1)))
            mk, got = _k11_maker(planes, cl, n, plan)
            mk()()
            torch.cuda.synchronize()
            err = _rel(got, ref)
            require(err <= 1e-3, f"K11 {key} plan {plan}: {err}")
            pl = fk.cg_plan(True, B, L, L, dev, plan)
            row[str(C)] = {"solve_ms": graph_ms(mk, reps=5),
                           "scratch": pl.scratch > 0, "threads": pl.threads,
                           "rel_vs_twin": err}
        sweep[key] = row
    return {"by_path": out, "cg_plans": sweep}


def fermion_bounds(B: int, L: int, iters: int = 0) -> dict:
    """Least time of K9/K10 (one operator: p and four link planes read,
    four planes written, 112 flops a site: each of the four eo hop passes
    runs 44 on half the sites, each combine 12 on all) and K11 (a cold eo
    solve of ``iters`` iterations: b and four link planes read, x written
    once; an iteration 120 flops a site, four hop passes of 44 and two
    combines of 12 on half the sites and the update's 40, 10 an element of
    the even half: <p, Mp>, x, r, <r, r>, p, 2 each) for B chains of
    L^2; K11_bf16 the same solve on bf16 planes (2 bytes an element)."""
    sites = B * L * L
    op = _bound(12 * 4 * sites, 112 * sites)
    return {"K9": op, "K10": op,
            "K11": _bound(12 * 4 * sites + 4 * B, 120 * iters * sites),
            # bf16 links, b and x: half the bytes, the same operations
            "K11_bf16": _bound(12 * 2 * sites + 4 * B, 120 * iters * sites)}


def path_busy(name: str, dev, x, s_per_traj: float, params=None,
              spec=None) -> dict:
    """profile_busy of two trajectories of path ``name`` from x (z0 with
    the flow) against the path's own s/trajectory."""
    cfg = dataclasses.replace(DYN[name], ntraj=2)
    gen = torch.Generator(device=dev).manual_seed(43)
    return profile_busy(lambda: _run_dyn(name, cfg, x, gen, dev, params,
                                         spec), cfg.ntraj, s_per_traj)


# ---------------------------------------------------------------------------
# the rest of the dynamical sector: K11 on bf16 and the mixed CG, paths D-G,
# the fermion observables, fermion-aware training
# ---------------------------------------------------------------------------

def _bf16_planes(x, eo: bool, layout: str, seed: int = 3):
    """(bf16 link planes, bf16 planes of a heatbath right-hand side) of
    links x in ``layout``."""
    phi, _ = tf.pf_refresh(torch.Generator(device=x.device).manual_seed(seed),
                           x, MASS, eo=eo)
    op = fk._PackedOperator(x, layout)
    return (op.ur.bfloat16(), op.ui.bfloat16(),
            op.pack(phi).bfloat16().contiguous())


def compare_k11_bf16(dev) -> tuple[float, float, dict]:
    """K11_bf16 against its twin (cg_planes_bf16_plain) on the same bf16 r
    at each shape of K11_BF16_SHAPES (near-equilibrium links at beta = 6,
    eo and not), the mixed CG's inner tol and sweep cap: the sweeps within
    2, d within 5e-2 relative in norm (the kernel rounds on store, the twin
    as the JAX loop does, alpha and beta too), one K11_bf16 launch and no
    other, two launches bit-equal; the band plan beside fp32 K11's, also
    at 128^2 and 256^2 (4 chains). Returns (max|d - d_twin|, 5e-2 x
    max|d_twin|) nearest its tolerance, and the cases."""
    g = torch.Generator(device=dev).manual_seed(2030)
    cases, pairs = {}, []
    for key, (B, n, layout) in K11_BF16_SHAPES.items():
        x = near_equilibrium(g, B, n, 6.0, dev)
        cl = layout == "cl"
        for eo in (True, False):
            ur, ui, r16 = _bf16_planes(x, eo, layout)
            twin, k_twin = fk.cg_planes_bf16_plain(
                ur, ui, r16, MASS, fk.MIXED_INNER_TOL, fk.MIXED_INNER_MAX,
                eo, cl)
            outs = []
            _build.reset_counts()
            for _ in (0, 1):
                d = torch.empty_like(r16)
                rel = torch.empty(B, device=dev)
                counters = torch.zeros(3, dtype=torch.int32, device=dev)
                fk.cg_launch(cl, ur, ui, r16, None, MASS, eo,
                             fk.MIXED_INNER_TOL, fk.MIXED_INNER_MAX, d, rel,
                             counters)()
                outs.append((d, counters.tolist()))
            launches = dict(_build.LAUNCHES)
            (d, (k, _, odd)), (d2, _) = outs
            err = float((d.float() - twin.float()).norm()
                        / twin.float().norm())
            pairs.append((float((d.float() - twin.float()).abs().max()),
                          5e-2 * float(twin.float().abs().max())))
            name = f"{key}_{layout}_{'eo' if eo else 'full'}"
            cases[name] = {
                "sweeps": [k, k_twin], "rel_vs_twin": err,
                "bit_equal": torch.equal(d, d2),
                "plan_bf16": list(fk.cg_plan(eo, B, n, n, dev,
                                             bf16=True)[:3]),
                "plan_fp32": list(fk.cg_plan(eo, B, n, n, dev)[:3])}
            require(not odd and abs(k - k_twin) <= 2 and err <= 5e-2,
                    f"K11_bf16 {name}: {cases[name]}")
            require(cases[name]["bit_equal"], f"K11_bf16 repeat {name}")
            require(launches == dict.fromkeys(_build.KERNELS, 0)
                    | {"K11_bf16": 2}, f"K11_bf16 launches {name}: "
                    f"{launches}")
    plans = {f"{n}^2_{'eo' if eo else 'full'}": {
        "bf16": list(fk.cg_plan(eo, 4, n, n, dev, bf16=True)[:3]),
        "fp32": list(fk.cg_plan(eo, 4, n, n, dev)[:3])}
        for n in (128, 256) for eo in (True, False)}
    err, tol = _worst(pairs)
    return err, tol, {"cases": cases, "large_plans": plans}


def mixed_solves(dev) -> dict:
    """Whole mixed-precision solves (cg_solve_mixed) at MIXED_SHAPES, eo,
    at tol 1e-9 (the force's) and 1e-12 (the Metropolis'), cold and from a
    warm start: each chain's fp32 true residual, recomputed by K9 / K10,
    within tol; the solution within 1e-3 relative in norm of fp32 K11's
    (compare_k11's rule for two fp32 CGs); the iterations (operator
    applications), the refinement cycles and the host reads a solve,
    beside fp32 K11's iterations."""
    g = torch.Generator(device=dev).manual_seed(2031)
    out = {}
    for key, (B, n, layout) in MIXED_SHAPES.items():
        x = near_equilibrium(g, B, n, 6.0, dev)
        phi, _ = tf.pf_refresh(torch.Generator(device=dev).manual_seed(5), x,
                               MASS, eo=True)
        warm = fk.cg_solve_fused(x, phi, MASS, tol=1e-4, maxiter=2000,
                                 layout=layout).x
        op = fk._PackedOperator(x, layout)
        apply = fk.mdagm_cl if layout == "cl" else fk.mdagm
        dims = (0, 1, 2) if layout == "cl" else (1, 2, 3)
        for tol in (1e-9, 1e-12):
            for start, x0 in (("cold", None), ("warm", warm)):
                t0 = time.perf_counter()
                res = fk.cg_solve_mixed(x, phi, MASS, x0, tol=tol,
                                        maxiter=2000, layout=layout)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ref = fk.cg_solve_fused(x, phi, MASS, x0, tol=tol,
                                        maxiter=2000, layout=layout)
                b4, x4 = op.pack(phi), op.pack(res.x)
                r = b4 - apply(op.ur, op.ui, x4, MASS, True)
                rel = ((r * r).sum(dim=dims) / (b4 * b4).sum(dim=dims))
                err = _rel(res.x, ref.x)
                name = f"{key}_{layout}_tol{tol:g}_{start}"
                out[name] = {"iters": res.iters, "cycles": res.reads - 1,
                             "host_reads": res.reads,
                             "fp32_k11_iters": ref.iters,
                             "true_rel_residual_max": float(rel.max()),
                             "rel_vs_fp32": err, "wall_ms": wall * 1e3}
                require(float(rel.max()) <= tol,
                        f"mixed solve {name}: {out[name]}")
                require(err <= 1e-3,
                        f"mixed solve {name} vs K11: {out[name]}")
    return out


def k11_bf16_timings(dev, x) -> dict:
    """K11_bf16 and fp32 K11 at path A's / G's shape (64^2, 64 chains, eo,
    chains-first), cold solves of K11_TIMED_ITERS iterations (tol 0) and
    their set-ups (maxiter 0), each the card's time by graph_ms, in turns
    (fp32, bf16, bf16, fp32): ms an iteration each, beside the bf16 twin's
    solve and K11_bf16's bound (its bytes half fp32 K11's)."""
    n = K11_TIMED_ITERS
    _, planes32 = _k11_planes(x, True, False)
    ur, ui, r16 = _bf16_planes(x, True, "cf")
    B = r16.shape[0]

    def maker16(maxiter):
        d = torch.empty_like(r16)
        rel = torch.empty(B, device=dev)
        counters = torch.zeros(3, dtype=torch.int32, device=dev)
        return lambda: fk.cg_launch(False, ur, ui, r16, None, MASS, True,
                                    0.0, maxiter, d, rel, counters)

    makers = {"fp32": (_k11_maker(planes32, False, n)[0],
                       _k11_maker(planes32, False, 0)[0]),
              "bf16": (maker16(n), maker16(0))}
    times = {"fp32": [], "bf16": []}
    for k in ("fp32", "bf16", "bf16", "fp32"):
        solve, setup = (graph_ms(m, reps=5) for m in makers[k])
        times[k].append((solve, setup))
    out = {}
    for k, v in times.items():
        solve, setup = min(v)
        out[k] = {"solve_ms": solve, "setup_ms": setup,
                  "iteration_ms": (solve - setup) / n, "readings": v}
    out["bf16"]["plain_ms"] = cuda_ms(lambda: fk.cg_planes_bf16_plain(
        ur, ui, r16, MASS, 0.0, n, True, False), reps=1, repeats=3)
    out["bf16"].update(fermion_bounds(B, x.shape[-1], n)["K11_bf16"])
    out["fp32"].update(fermion_bounds(B, x.shape[-1], n)["K11"])
    out.update({"chains": B, "L": x.shape[-1], "iterations": n,
                "plan_bf16": list(fk.cg_plan(True, B, 64, 64, dev,
                                             bf16=True)[:3]),
                "plan_fp32": list(fk.cg_plan(True, B, 64, 64, dev)[:3])})
    return out


def observables_card_vs_cpu(dev) -> dict:
    """chiral_condensate (8 noises) and pion_correlator on the card against
    the CPU port on the same links (16^2, 8 near-equilibrium chains) and
    the same noise: 1e-4 relative (both solves at 1e-10 / 1e-12)."""
    x = near_equilibrium(torch.Generator(device=dev).manual_seed(61), 8, 16,
                         6.0, dev)
    g = torch.Generator().manual_seed(62)
    eta = torch.complex(torch.randn((8, 8, 16, 16, 2), generator=g),
                        torch.randn((8, 8, 16, 16, 2), generator=g)) \
        * math.sqrt(0.5)
    cc = tf.chiral_condensate_from(eta.to(dev), x, MASS, tol=1e-10)
    cc_cpu = tf.chiral_condensate_from(eta, x.cpu(), MASS, tol=1e-10)
    pc = tf.pion_correlator(x, MASS, tol=1e-12)
    pc_cpu = tf.pion_correlator(x.cpu(), MASS, tol=1e-12)
    r = {"chiral_rel": _rel(cc.cpu(), cc_cpu),
         "pion_rel": _rel(pc.cpu(), pc_cpu),
         "chiral_mean": float(cc.mean()), "tolerance": 1e-4}
    require(r["chiral_rel"] <= 1e-4 and r["pion_rel"] <= 1e-4,
            f"observables card vs CPU: {r}")
    return r


def pion_on_path_b(xb) -> dict:
    """The pion correlator on path B's final 128 configurations (16^2,
    beta=6, m=0.1) beside the JAX package's on its own plain ensemble of
    the same theory: the pulls (mean - JAX) / sqrt(se^2 + se_JAX^2), se the
    standard error over the 128 chains. Printed, not gated: the two runs'
    topological sectors may differ."""
    t0 = time.perf_counter()
    c = tf.pion_correlator(xb, MASS, tol=1e-10).double()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mean = c.mean(dim=0).cpu().numpy()
    se = (c.std(dim=0) / math.sqrt(c.shape[0])).cpu().numpy()
    jm, jse = (np.asarray(a) for a in JAX_PION_B6)
    pulls = (mean - jm) / np.sqrt(se ** 2 + jse ** 2)
    require(bool(np.isfinite(mean).all()) and bool((mean > 0).all()),
            "pion correlator on path B: not finite or not positive")
    return {"configs": int(c.shape[0]), "corr": mean.tolist(),
            "corr_err": se.tolist(), "jax_corr": list(JAX_PION_B6[0]),
            "pulls": pulls.tolist(),
            "max_abs_pull": float(np.abs(pulls).max()),
            "mean_abs_pull": float(np.abs(pulls).mean()), "wall_s": wall}


def ferm_training(dev) -> dict:
    """Fermion-aware training (ferm_mass = 0.1, force_weight = 0.5) with
    the reference flow (ncp, 16 layers, hidden (8, 8)) at 8^2, beta=2,
    batch 64: one step's loss and gradients on the card against the CPU on
    the same z and parameters (1e-4 relative in norm), then an era of 10
    epochs through train_era (graphed or eager, as FERM_ERA_GRAPHED says):
    metrics finite, steps/s."""
    cfg = dataclasses.replace(REF_TRAIN, force_weight=0.5, ferm_mass=0.1)
    state = ttrain.init_train_state(None, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(71)
    z = (torch.rand((cfg.batch_size, 2, 8, 8), generator=g, device=dev)
         * 2 - 1) * math.pi
    loss, aux, grads = ttrain.loss_and_grads(
        state.params, cfg.flow, z, cfg.beta, force_weight=0.5, ferm_mass=0.1)
    loss_c, aux_c, grads_c = ttrain.loss_and_grads(
        _copy_params(state.params, "cpu"), cfg.flow, z.cpu(), cfg.beta,
        force_weight=0.5, ferm_mass=0.1)
    a = torch.cat([t.flatten() for t in grads_c])
    b = torch.cat([t.flatten().cpu() for t in grads])
    rel = float((b - a).norm() / a.norm())
    rel_loss = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    require(rel <= 1e-4 and rel_loss <= 1e-4,
            f"ferm_mass gradients card vs CPU: {rel}, loss {rel_loss}")
    n_epoch = 10
    t0 = time.perf_counter()
    state, hist = ttrain.train_era(state, cfg.flow, cfg.batch_size, cfg.L,
                                   cfg.beta, cfg.dkl_factor, cfg.base_lr,
                                   n_epoch, force_weight=0.5, ferm_mass=0.1)
    wall = time.perf_counter() - t0
    require(all(np.isfinite(v).all() for v in hist.values()),
            "ferm_mass era: metrics not finite")
    return {"batch": cfg.batch_size, "grad_rel_err_norm": rel,
            "loss_rel_err": rel_loss, "tolerance": 1e-4,
            "force_sq": float(aux["force_sq"]),
            "era_graphed": ttrain.FERM_ERA_GRAPHED, "era_epochs": n_epoch,
            "era_steps_per_s": n_epoch / wall,
            "era_force_sq_last": float(hist["force_sq"][-1])}


def dynamical_rest_phase(dev, params, spec, xb) -> dict:
    """Phase 10: K11_bf16 against its twin, whole mixed solves, paths D, E,
    F and G (each with its own launch counts), K11_bf16's and K11's times,
    the observables, the pion correlator on path B's configurations, and
    fermion-aware training. Returns what the kernels line needs."""
    t_phase = time.perf_counter()
    err, tol, info = compare_k11_bf16(dev)
    say("compare_k11_bf16", max_abs_err=err, tolerance=tol, **info)
    say("mixed_solves", solves=mixed_solves(dev))
    rest = {}
    for k, seed, nb, nl in (("D", 53, 64, 64), ("E", 54, 64, 32),
                            ("G", 56, 64, 64)):
        rest[k], _ = dyn_path(k, dev, near_equilibrium(
            torch.Generator(device=dev).manual_seed(seed), nb, nl, 6.0, dev))
    zf, _ = flow_reverse(params, torch.zeros((64, 2, 16, 16), device=dev),
                         spec)
    rest["F"], _ = dyn_path("F", dev, zf, params, spec)
    xg = near_equilibrium(torch.Generator(device=dev).manual_seed(57), 64,
                          64, 6.0, dev)
    timing = k11_bf16_timings(dev, xg)
    starts = {"D": (xg, ()), "E": (near_equilibrium(
        torch.Generator(device=dev).manual_seed(58), 64, 32, 6.0, dev), ()),
              "F": (zf, (params, spec)), "G": (xg, ())}
    busy = {k: path_busy(k, dev, x0, rest[k]["s_per_traj"], *fl)
            for k, (x0, fl) in starts.items()}
    say("timing_dynamical_rest", k11_bf16_vs_k11=timing,
        s_per_traj={k: r["s_per_traj"] for k, r in rest.items()},
        chain_steps_per_s={k: r["chain_steps_per_s"]
                           for k, r in rest.items()},
        cg_iters_mean={k: r["cg_iters_mean"] for k, r in rest.items()},
        cg_solves_per_traj={k: r["cg_solves"] / (r["therm"] + r["measured"])
                            for k, r in rest.items()},
        cg_host_reads_per_solve={k: r["cg_host_reads"] / r["cg_solves"]
                                 for k, r in rest.items()},
        device_busy=busy)
    say("observables", card_vs_cpu=observables_card_vs_cpu(dev),
        pion_path_b=pion_on_path_b(xb))
    say("ferm_training", **ferm_training(dev))
    say("dynamical_rest", seconds=time.perf_counter() - t_phase)
    return {"err": err, "tol": tol, "timing": timing,
            "launches": {k: r["launches"] for k, r in rest.items()}}


# ---------------------------------------------------------------------------
# flow training and flow sampling: K6 at the sampler's shapes, training
# (reverse KL), checkpoints, flow sampling with the exported flows
# ---------------------------------------------------------------------------

def k6_bound(spec, layer, Bc: int, Lc: int, mu: int, off: int) -> dict:
    """bounds()'s K6 at Bc chains of Lc^2: the fields, logJ and the layer's
    weights once; the conv multiply-adds its outputs depend on."""
    widths = [2, *spec.hidden_sizes, int(layer[-1]["w"].shape[0])]
    field = 4 * 2 * Bc * Lc * Lc
    weights = 4 * sum(t.numel() for c in layer for t in c.values())
    macs = coupling_macs(widths, mu, off, lat=Lc)["K6"]
    return _bound(2 * field + weights + 4 * Bc, 2 * Bc * macs)


def compare_sampler_k6(dev) -> dict:
    """K6 against its twin on every layer of the exported flows at the
    sampler's 8^2 shapes (SAMPLER_K6), phase 3's tolerances; the card's
    time of the timed layer there, its twin's, its bound."""
    g = torch.Generator(device=dev).manual_seed(2027)
    out = {}
    for name, (flow, chains) in SAMPLER_K6.items():
        params, spec = load_flow_npz(device=dev, name=flow)
        x = (torch.rand((chains, 2, 8, 8), generator=g, device=dev) * 2
             - 1) * math.pi
        pairs = []
        with full_fp32():
            for li, layer in enumerate(params):
                mu, off = layer_mask_params(li)
                fx, lj = coupling_forward(layer, x, mu, off, spec)
                fx_p, lj_p = coupling_forward_plain(layer, x, mu, off, spec)
                pairs += [(wrapped_err(fx, fx_p), 1e-4),
                          (float((lj - lj_p).abs().max()),
                           1e-4 * max(1.0, float(lj_p.abs().max())))]
            require(all(e <= t for e, t in pairs), f"K6 at {name}: {pairs}")
            layer, (mu, off) = params[TIMED_LAYER], layer_mask_params(
                TIMED_LAYER)
            gy, gl = torch.zeros_like(x), x.new_zeros(chains)
            card = coupling_card_ms(layer, spec, x, gy, gl, mu, off)["K6"]
            plain = cuda_ms(lambda: coupling_forward_plain(layer, x, mu, off,
                                                           spec), reps=3)
        out[name] = {"flow": flow, "chains": chains, "L": 8,
                     "layers": len(params),
                     "max_abs_err": max(e for e, _ in pairs),
                     "tolerance": min(t for _, t in pairs),
                     "pairs_ok": len(pairs), "k6_card_ms": card,
                     "plain_ms": plain,
                     **k6_bound(spec, layer, chains, 8, mu, off)}
    return out


def _copy_params(params, dev):
    return [[{k: v.detach().to(dev) for k, v in c.items()} for c in net]
            for net in params]


def train_grads_card_vs_cpu(dev) -> dict:
    """One training step's loss and gradients at the flagship's width
    (batch 512, 8^2, fresh weights) on the card against the port's CPU
    path, the same z and parameters: relative error in norm <= 1e-4."""
    cfg = FLAGSHIP_TRAIN
    state = ttrain.init_train_state(None, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(31)
    z = (torch.rand((cfg.batch_size, 2, 8, 8), generator=g, device=dev)
         * 2 - 1) * math.pi
    t0 = time.perf_counter()
    loss, _, grads = ttrain.loss_and_grads(state.params, cfg.flow, z, 2.0)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, _, grads_c = ttrain.loss_and_grads(
        _copy_params(state.params, "cpu"), cfg.flow, z.cpu(), 2.0)
    t_cpu = time.perf_counter() - t0
    a = torch.cat([t.flatten() for t in grads_c])
    b = torch.cat([t.flatten().cpu() for t in grads])
    rel = float((b - a).norm() / a.norm())
    rel_loss = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    require(rel <= 1e-4 and rel_loss <= 1e-4,
            f"training gradients card vs CPU: {rel}, loss {rel_loss}")
    return {"batch": cfg.batch_size, "grad_rel_err_norm": rel,
            "loss_rel_err": rel_loss, "tolerance": 1e-4,
            "card_s_first_call": t_card, "cpu_s": t_cpu}


def era_busy(state, cfg, n_epoch: int = 20) -> dict:
    """profile_busy of an era of ``n_epoch`` steps from ``state`` (its
    result dropped), per step, against an unprofiled era of the same
    length: the card's share of an era's wall time, its graph capture and
    warm-up steps included (a profile of every kernel of 100 steps takes
    the profiler minutes)."""
    def era():
        ttrain.train_era(state, cfg.flow, cfg.batch_size, cfg.L, cfg.beta,
                         cfg.dkl_factor, cfg.base_lr, n_epoch,
                         grad_clip=cfg.grad_clip)
    era()
    t0 = time.perf_counter()
    era()
    return {"era_epochs": n_epoch, **profile_busy(
        era, n_epoch, (time.perf_counter() - t0) / n_epoch)}


def train_reference(dev) -> dict:
    """REF_TRAIN through train() on the card, then generate_ensemble with
    64 chains: flow-sampling acceptance >= MIN_TRAINED_ACCEPTANCE, and the
    last 100 epochs' mean loss below the first 100's."""
    cfg = REF_TRAIN
    t0 = time.perf_counter()
    state, hist = ttrain.train(cfg, device=dev)
    t_train = time.perf_counter() - t0
    loss = np.asarray(hist["loss_dkl"], dtype=np.float64)
    require(np.isfinite(loss).all(), "reference training: loss not finite")
    first, last = float(loss[:100].mean()), float(loss[-100:].mean())
    require(last < first, f"reference training: loss {first} -> {last}")
    busy = era_busy(state, cfg)
    t0 = time.perf_counter()
    ens = tsample.generate_ensemble(
        state.params, cfg.flow, beta=cfg.beta, L=cfg.L, n_chains=64,
        generator=torch.Generator(dev).manual_seed(5), device=dev)
    t_ens = time.perf_counter() - t0
    acc = ens["accept_rate"]
    require(acc >= MIN_TRAINED_ACCEPTANCE,
            f"reference flow sampling acceptance {acc} < "
            f"{MIN_TRAINED_ACCEPTANCE}")
    return {"epochs": cfg.n_era * cfg.n_epoch, "batch": cfg.batch_size,
            "train_s": t_train,
            "steps_per_s": cfg.n_era * cfg.n_epoch / t_train,
            "loss_first_100": first, "loss_last_100": last,
            "ess_last_100": float(np.mean(hist["ess"][-100:])),
            "acceptance": acc, "chi_q": ens["suscept_mean"],
            "chi_q_err": ens["suscept_err"], "tau_int_q": ens["tau_int_q"],
            "ensemble": [64, 1024], "ensemble_s": t_ens,
            "per_step_busy": busy}


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


def train_flagship(dev) -> dict:
    """FLAGSHIP_TRAIN from fresh weights: era 0 through train_era (its host
    synchronisations counted), save_checkpoint, load_checkpoint_auto, then
    era 1 through train(start_era=1): losses finite, the step count and the
    beta schedule continue the first era's."""
    import tempfile
    cfg = FLAGSHIP_TRAIN
    state = ttrain.init_train_state(None, cfg, device=dev)
    betas0 = ttrain.anneal_betas(cfg, 0, device=dev)
    t0 = time.perf_counter()
    (state, h0), syncs = _count_syncs(lambda: ttrain.train_era(
        state, cfg.flow, cfg.batch_size, cfg.L, cfg.beta, cfg.dkl_factor,
        cfg.base_lr, cfg.n_epoch, betas=betas0, grad_clip=cfg.grad_clip))
    t_era0 = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = save_checkpoint(tmp, state, era=0, epoch=cfg.n_epoch,
                               history=h0, train_cfg=cfg)
        state1, meta, spec, rcfg = load_checkpoint_auto(tmp, device=dev)
    require(rcfg == cfg and spec == cfg.flow and meta["era"] == 0,
            "flagship checkpoint: configuration not restored")
    require(all(torch.equal(a, b) for a, b in zip(
        ttrain.param_leaves(state.params), ttrain.param_leaves(
            state1.params))), "flagship checkpoint: parameters differ")
    t0 = time.perf_counter()
    state2, h1 = ttrain.train(rcfg, state1, start_era=meta["era"] + 1)
    torch.cuda.synchronize()
    t_era1 = time.perf_counter() - t0
    loss = np.concatenate([h0["loss_dkl"], np.asarray(h1["loss_dkl"])])
    require(np.isfinite(loss).all(), "flagship training: loss not finite")
    require(int(state2.step) == cfg.n_era * cfg.n_epoch,
            f"flagship training: step {int(state2.step)}")
    want = ttrain.anneal_betas(cfg, 1, device="cpu").numpy()
    require(np.array_equal(np.asarray(h1["beta"]), want)
            and float(h0["beta"][-1]) < float(want[0]),
            "flagship training: beta schedule does not continue")
    return {"epochs_per_era": cfg.n_epoch, "batch": cfg.batch_size,
            "checkpoint": os.path.basename(path),
            "steps_per_s": {"era0": cfg.n_epoch / t_era0,
                            "era1": cfg.n_epoch / t_era1},
            "era0_host_syncs": syncs,
            "loss": {"first": float(loss[0]),
                     "era0_last": float(loss[cfg.n_epoch - 1]),
                     "last": float(loss[-1])},
            "ess_last": float(h1["ess"][-1]),
            "per_step_busy": era_busy(state2, cfg),
            "beta": [float(h0["beta"][0]), float(h0["beta"][-1]),
                     float(h1["beta"][0]), float(h1["beta"][-1])],
            "steps": int(state2.step)}


def dkl_rncp24(dev) -> dict:
    """D_KL = mean(logq - logp) of flow8x8_b3_rncp24 at 8^2, beta=3 over
    DKL_DRAWS prior draws through K6, within 5 standard errors (the two
    runs' combined) of the JAX package's CPU reading."""
    params, spec = load_flow_npz(device=dev, name="flow8x8_b3_rncp24")
    prior = priors.uniform_link_prior(8, device=dev)
    g = torch.Generator(dev).manual_seed(11)
    d = []
    for _ in range(DKL_DRAWS // 1024):
        _, logq, logp, _ = tsample.propose(params, spec,
                                           prior.sample_n(g, 1024), 3.0)
        d.append((logq - logp).double())
    d = torch.cat(d)
    mean, se = float(d.mean()), float(d.std() / math.sqrt(d.numel()))
    jm, jse = JAX_DKL_RNCP24
    sigma = math.hypot(se, jse)
    require(abs(mean - jm) <= 5 * sigma,
            f"D_KL {mean} +- {se} vs JAX {jm} +- {jse}")
    return {"draws": d.numel(), "dkl": mean, "stderr": se, "jax_dkl": jm,
            "jax_stderr": jse, "diff_sigmas": (mean - jm) / sigma}


def sample_16l_long(dev) -> dict:
    """Flow sampling with flow8x8_b2_16l_long (SAMPLING) through
    make_mcmc_ensemble, counts zeroed just before and read just after:
    acceptance within SAMPLING_ACC_MARGIN of the JAX package's CPU reading,
    K6 launched exactly once a layer a block (the initial proposals one
    block), no plain twin; chain-samples/s, tau_int(Q) and effective
    samples/s, and the card's busy share of a shorter run."""
    params, spec = load_flow_npz(device=dev, name="flow8x8_b2_16l_long")
    cfg = SAMPLING
    nblocks = -(-(cfg["num_samples"] - 1) // cfg["batch_size"])
    gen = torch.Generator(dev).manual_seed(17)
    tsample.make_mcmc_ensemble(params, spec, generator=gen,
                               **{**cfg, "num_samples": 65}, device=dev)
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    hist = tsample.make_mcmc_ensemble(params, spec, generator=gen, **cfg,
                                      device=dev)
    wall = time.perf_counter() - t0
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    acc = float(hist["acc"].mean())
    expect = {**dict.fromkeys(_build.KERNELS, 0),
              "K6": spec.n_layers * (nblocks + 1)}
    require(launches == expect and not any(plain.values()),
            f"flow sampling launches {launches} != {expect}, plain {plain}")
    require(all(np.isfinite(v).all() for v in hist.values()),
            "flow sampling: history not finite")
    require(abs(acc - JAX_SAMPLING_ACC) <= SAMPLING_ACC_MARGIN,
            f"flow sampling acceptance {acc} vs JAX {JAX_SAMPLING_ACC}")
    cs = tobs.chain_stats(hist["q"])
    n = cfg["n_chains"] * cfg["num_samples"]
    short = {**cfg, "num_samples": 8 * cfg["batch_size"] + 1}
    n_short = 8
    t0 = time.perf_counter()
    tsample.make_mcmc_ensemble(params, spec, generator=gen, **short,
                               device=dev)
    t_short = (time.perf_counter() - t0) / n_short
    busy = profile_busy(lambda: tsample.make_mcmc_ensemble(
        params, spec, generator=gen, **short, device=dev), n_short, t_short)
    return {**cfg, "blocks": nblocks, "launches": launches["K6"],
            "expected": expect["K6"], "acceptance": acc,
            "jax_acceptance": JAX_SAMPLING_ACC, "wall_s": wall,
            "chain_samples_per_s": n / wall,
            "tau_int_q": cs["tau_int_q"], "tau_int_q_err": cs["tau_int_q_err"],
            "chi_q": cs["chi_q"],
            "effective_samples_per_s": n / (2 * cs["tau_int_q"]) / wall,
            "per_block_busy": busy}


def flow_training_phase(dev) -> dict:
    """Phase 9; returns K6's comparisons and the sampling path's count."""
    k6 = compare_sampler_k6(dev)
    say("compare_k6_sampler", shapes=k6)
    say("train_grads", **train_grads_card_vs_cpu(dev))
    say("train_reference", **train_reference(dev))
    say("train_flagship", **train_flagship(dev))
    say("dkl_rncp24", **dkl_rncp24(dev))
    sampling = sample_16l_long(dev)
    say("flow_sampling", **sampling)
    say("bench", train=tbench.bench_train(device=dev),
        flow_sampling=tbench.bench_flow_sampling(device=dev))
    return {"k6": k6, "sampling": sampling}


# ---------------------------------------------------------------------------
# phase 11: the bf16 flagship recipe, the mobility probes, the resilient
# runner, the diagnostics and a spline flow on the card
# ---------------------------------------------------------------------------

def _raises(fn) -> str | None:
    """The message of the ValueError fn() raises, None if it returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)[:120]
    return None


def bf16_flagship(dev) -> dict:
    """BF16_SPEC with fresh weights at BF16_L^2 x BF16_CHAINS, beta=6,
    tau=0.5, 8 Omelyan steps from z0 = 0: force_backend 'auto' and
    'kernel' refuse the spec; 'autograd' runs BF16_TRAJ trajectories with
    <exp(-dH)> over the measured ones finite and within 0.1 of 1, and no
    K6-K8 launch (counts set to 0 just before the run). The flow's round
    trip on the run's final fields within max(5e-4, 2x the CPU port's on
    the same flow and fields): 5e-4 is the JAX package's bound for a
    2-layer bf16 flow (tests/test_mixed_precision.py); at 24 layers a bf16
    rounding of a conditioner output flips between the forward and the
    reverse pass where the bisection's 1e-6 moves its input, and the JAX
    package itself reads ~1e-3 (9.6e-4 at 16^2 on the CPU). Then the
    recipe's bench beside fp32 at the same shape, the autograd force and,
    where kernel_fits takes the shape, the kernels (not gated)."""
    spec, Lb, Bb = BF16_SPEC, BF16_L, BF16_CHAINS
    params = init_flow_params(spec, torch.Generator(dev).manual_seed(0),
                              device=dev)
    z0 = torch.zeros((Bb, 2, Lb, Lb), device=dev)
    refused = {fb: _raises(lambda fb=fb: resolve_force_backend(
        fb, spec, z0.shape, z0.dtype, dev)) for fb in ("auto", "kernel")}
    require(all(refused.values()), f"bf16 spec not refused: {refused}")
    therm, meas = BF16_TRAJ
    lf = LeapfrogConfig(tau=TAU, nstep=NSTEP)
    _build.reset_counts()
    t0 = time.perf_counter()
    z, hist = run_fthmc(params, spec, lf, beta=BETA, ntraj=therm + meas,
                        z0=z0, generator=torch.Generator(dev).manual_seed(61),
                        integrator="omelyan", force_backend="autograd",
                        device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    sl = slice(therm, None)
    emdh = float(hist.exp_mdh[sl].mean())
    def roundtrip_of(p, zz):
        with torch.no_grad(), full_fp32():
            y, ld = flow_forward(p, zz, spec, remat=False)
        x2, ldr = flow_reverse(p, y, spec)
        return wrapped_err(x2, zz), float((ld + ldr).abs().max()
                                          / ld.abs().max())

    t0 = time.perf_counter()
    roundtrip, antisym = roundtrip_of(params, z)
    roundtrip_cpu, _ = roundtrip_of(_copy_params(params, "cpu"), z.cpu())
    t_rt = time.perf_counter() - t0
    rt_gate = max(5e-4, 2 * roundtrip_cpu)
    r = {"spec": dataclasses.asdict(spec), "L": Lb, "chains": Bb,
         "therm": therm, "measured": meas, "force_backend": "autograd",
         "refused": refused, "acceptance": float(hist.acc[sl].mean()),
         "exp_mdh": emdh, "plaq": float(hist.plaq[sl].mean()),
         "roundtrip_max_err": roundtrip, "roundtrip_cpu": roundtrip_cpu,
         "roundtrip_gate": rt_gate, "roundtrip_s": t_rt,
         "logdet_antisymmetry_rel": antisym,
         "run_s": t_run, "s_per_traj": t_run / (therm + meas),
         "launches": {k: launches[k] for k in ("K6", "K7", "K8")}}
    require(all(bool(torch.isfinite(t).all()) for t in hist),
            "bf16 flagship: history not finite")
    require(math.isfinite(emdh) and abs(emdh - 1.0) <= 0.1,
            f"bf16 flagship <exp(-dH)> {emdh}")
    require(roundtrip <= rt_gate, f"bf16 flagship round trip {roundtrip} > "
            f"{rt_gate}")
    require(not any(r["launches"].values()),
            f"bf16 flagship launched {r['launches']}")
    fp32 = dataclasses.replace(spec, conv_dtype="float32")
    kw = dict(L=Lb, chains=Bb, ntraj=BF16_BENCH[0], repeats=BF16_BENCH[1],
              device=dev)
    bench = {"bf16_autograd": tbench.bench_fthmc_flagship(
        conv_dtype="bfloat16", force_backend="autograd", **kw),
        "fp32_autograd": tbench.bench_fthmc_flagship(
            force_backend="autograd", **kw)}
    if kernel_fits(fp32, Lb, Bb):
        bench["fp32_kernel"] = tbench.bench_fthmc_flagship(
            force_backend="kernel", **kw)
    r["bench"] = {k: {"chain_steps_per_s": v["value"],
                      "s_per_traj": v["s_per_traj"]}
                  for k, v in bench.items()}
    return r


def _probe(params, spec, dev, seed, **kw):
    """mobility_probe on the card with its timed blocks' histories kept,
    the counts set to 0 just before it and read just after. Returns (its
    dict, timed TrajMetrics on the host, launches, plain calls, wall s)."""
    blocks = []
    _build.reset_counts()
    t0 = time.perf_counter()
    st = mobility_probe(params, spec, **kw, on_block=blocks.append,
                        generator=torch.Generator(dev).manual_seed(seed),
                        device=dev)
    wall = time.perf_counter() - t0
    hist = TrajMetrics(*[torch.cat(f).cpu() for f in zip(*blocks)])
    return (st, hist, dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS),
            wall)


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
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect["K1"] = (cfg_forces.get("dyn", 0) + cfg_forces.get("gauge", 0)
                    + cfg_forces.get("quenched", 0)) * n
    if kw.get("mass", 0.0) > 0:
        expect["K11"] = (forces + 1) * n
    elif n_layers is None:   # plain HMC: K12 ends each step
        expect["K12"] = n
    if n_layers is not None:
        expect.update({"K6": n_layers * (2 * n + blocks),
                       "K7": n_layers * forces * n,
                       "K8": n_layers * forces * n})
    return expect


def _probe_busy(params, spec, kw, dev, s_per_traj: float,
                n: int = 2) -> dict:
    """profile_busy of n trajectories of the probe's own sampler (the run
    function mobility_probe builds) from its cold start, after one
    unprofiled trajectory, against the probe's s/trajectory."""
    from fthmc_tpu_torch.mobility import _runner
    run = _runner(params, spec, L=kw["L"], beta=kw["beta"],
                  mass=kw.get("mass", 0.0), n_chains=kw["n_chains"],
                  tau=kw["tau"], nstep=kw["nstep"],
                  cg_maxiter=kw.get("cg_maxiter", 1500),
                  sampler=kw["sampler"],
                  generator=torch.Generator(dev).manual_seed(5), device=dev)
    z = torch.zeros((kw["n_chains"], 2, kw["L"], kw["L"]), device=dev)
    if params is not None:
        z = flow_reverse(params, z, spec)[0]
    z, _ = run(z, 1)
    torch.cuda.synchronize()
    return profile_busy(lambda: run(z, n), n, s_per_traj)


def mobility_probes(dev, params, spec) -> dict:
    """The probes at PROBE with the trained flow: FT quenched (<plaq>
    within 0.003 of PLAQ_EXACT, <exp(-dH)> within 0.1 of 1), plain
    quenched, FT at m=0.1 with path C's configuration (acceptance >= path
    C's floor, <plaq> within 0.003 of the JAX package's path-C reading),
    each with its exact launch counts and no plain twin; the floor
    extension on a small plain probe (ntraj grows by exactly
    max_extra_blocks blocks, valid False). B*mob/s +- err of each, and
    the busy share of a short probe of each sampler."""
    out, launched = {}, dict.fromkeys(_build.KERNELS, 0)
    n_q = {"quenched": 2 * PROBE["nstep"] + 1}
    dyn_cfg = SchwingerConfig(L=PROBE["L"], beta=PROBE["beta"], mass=MASS,
                              tau=PROBE["tau"], nstep=PROBE["nstep"],
                              n_chains=PROBE["n_chains"])
    cases = {"ft": (params, spec, "ft", PROBE_QUENCHED, n_q),
             "plain": (None, None, "plain", PROBE_QUENCHED, n_q),
             "ft_dyn": (params, spec, "ft", PROBE_DYN,
                        force_evaluations(dyn_cfg))}
    for i, (name, (p, s, sampler, kw, forces)) in enumerate(cases.items()):
        kw = {**PROBE, **kw, "sampler": sampler}
        st, hist, launches, plain, wall = _probe(p, s, dev, 71 + i, **kw)
        expect = _probe_expected(kw, forces,
                                 None if p is None else len(p))
        emdh = float(hist.exp_mdh.mean())
        t0 = time.perf_counter()
        busy = _probe_busy(p, s, kw, dev, st["s_per_traj"])
        busy["profile_s"] = time.perf_counter() - t0
        out[name] = {**st, "exp_mdh": emdh, "therm": kw["therm"],
                     "call_block": kw["call_block"], "wall_s": wall,
                     "launches": launches, "expected": expect,
                     "busy": busy}
        say("mobility_probe", probe=name, **out[name])
        require(launches == expect and not any(plain.values()),
                f"probe {name}: launches {launches} != {expect}, plain "
                f"{plain}")
        require(all(bool(torch.isfinite(t).all()) for t in hist),
                f"probe {name}: history not finite")
        for k, v in launches.items():
            launched[k] += v
    ft, dyn = out["ft"], out["ft_dyn"]
    exact = lattice.PLAQ_EXACT[PROBE["beta"]]
    require(abs(ft["plaq"] - exact) <= 0.003,
            f"FT probe plaq {ft['plaq']} vs {exact}")
    require(abs(ft["exp_mdh"] - 1.0) <= 0.1,
            f"FT probe <exp(-dH)> {ft['exp_mdh']}")
    require(dyn["acc"] >= MIN_FT_ACCEPTANCE["C"],
            f"dynamical FT probe acceptance {dyn['acc']}")
    plaq_c = DYN_READING["C"][2]
    require(abs(dyn["plaq"] - plaq_c) <= 0.003,
            f"dynamical FT probe plaq {dyn['plaq']} vs {plaq_c}")
    kw = {**PROBE, **PROBE_FLOOR, "sampler": "plain"}
    st = mobility_probe(None, None, **kw,
                        generator=torch.Generator(dev).manual_seed(79),
                        device=dev)
    block = min(kw["call_block"], kw["ntraj"])
    grown = st["ntraj"] - -(-kw["ntraj"] // block) * block
    out["floor"] = {"ntraj": st["ntraj"], "grown_by": grown,
                    "valid": st["valid"], "n_events": st["n_events"],
                    "min_events": kw["min_events"]}
    require(grown == kw["max_extra_blocks"] * block and not st["valid"],
            f"floor extension: {out['floor']}")
    say("mobility_floor", **out["floor"])
    say("mobility_summary", **{k: {"B_mob_per_s": v["B_mob_per_s"],
                                   "B_mob_per_s_err": v["B_mob_per_s_err"],
                                   "s_per_traj": v["s_per_traj"],
                                   "acceptance": v["acc"]}
                               for k, v in out.items() if k != "floor"})
    return {"probes": out, "launches": launched}


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


def runner_phase(dev, params, spec) -> dict:
    """run_resilient over run_fthmc blocks of RUNNER_BLOCK at the flagship
    FT path ('auto': the kernels), state in a temporary file: the first
    RUNNER_TRAJ[0] trajectories, then the same state file to
    RUNNER_TRAJ[1], held bit for bit against an uninterrupted run from the
    same generator seed (K6-K8 sum in a fixed order: two launches are
    bit-equal), its launches counted; a host-sleeping step under
    block_timeout=1, max_retries=1 raises BlockTimeout; a step that fires a
    device-side assert under max_retries=None makes its process exit
    non-zero within 120 s without a retry."""
    import tempfile
    lf = LeapfrogConfig(tau=TAU, nstep=NSTEP)
    z0, _ = flow_reverse(params, torch.zeros((B, 2, L, L), device=dev), spec)

    def step(g, z, n):
        return run_fthmc(params, spec, lf, beta=BETA, ntraj=n, z0=z,
                         generator=g, integrator="omelyan", device=dev)

    first, total = RUNNER_TRAJ
    seed = 81
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        sp = os.path.join(tmp, "state.npz")
        _build.reset_counts()
        t0 = time.perf_counter()
        run_resilient(step, z0, generator=torch.Generator(dev).manual_seed(
            seed), ntraj=first, block=RUNNER_BLOCK, state_path=sp,
            max_retries=0)
        z_r, h_r, info = run_resilient(
            step, z0, generator=torch.Generator(dev).manual_seed(seed + 1),
            ntraj=total, block=RUNNER_BLOCK, state_path=sp, max_retries=0)
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    z_w, h_w, _ = run_resilient(
        step, z0, generator=torch.Generator(dev).manual_seed(seed),
        ntraj=total, block=RUNNER_BLOCK, max_retries=0)
    same = torch.equal(z_r, z_w) and all(np.array_equal(h_r[k], h_w[k])
                                         for k in h_w)
    n_force = 2 * NSTEP + 1
    blocks = total // RUNNER_BLOCK
    expect = {**dict.fromkeys(_build.KERNELS, 0), "K1": n_force * total,
              "K6": spec.n_layers * (2 * total + blocks),
              "K7": spec.n_layers * n_force * total,
              "K8": spec.n_layers * n_force * total}

    def sleeping(g, z, n):
        time.sleep(5)
        return z, {}

    t0 = time.perf_counter()
    try:
        run_resilient(sleeping, z0, generator=torch.Generator(dev), ntraj=2,
                      block=2, hist_fields=(), block_timeout=1,
                      retry_sleep=0.1, max_retries=1)
        fired = False
    except BlockTimeout:
        fired = True
    t_watchdog = time.perf_counter() - t0
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _ASSERT_CHILD], capture_output=True,
        text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    t_child = time.perf_counter() - t0
    r = {"block": RUNNER_BLOCK, "first": first, "total": total,
         "resumed_equals_uninterrupted": same,
         "max_abs_diff": float((z_r - z_w).abs().max()),
         "acceptance": float(h_r["acc"].mean()),
         "plaq": float(h_r["plaq"].mean()), "wall_s": wall,
         "s_per_traj_resumed_process": info["s_per_traj"],
         "launches": launches, "expected": expect,
         "watchdog_fired": fired, "watchdog_s": t_watchdog,
         "assert_child_rc": child.returncode, "assert_child_s": t_child,
         "assert_child_tail": child.stderr.strip().splitlines()[-1:]}
    say("runner", **r)
    r["z"] = z_w
    require(same, "resumed run differs from the uninterrupted one")
    require(launches == expect, f"runner launches {launches} != {expect}")
    require(fired, "the watchdog did not fire")
    require(child.returncode != 0 and "returned" not in child.stdout
            and "retry" not in child.stdout
            and "device-side assert" in child.stderr,
            f"device-assert child: rc {child.returncode}, "
            f"{child.stdout[-300:]} {child.stderr[-300:]}")
    return r


def diagnostics_phase(dev, params, spec, z) -> dict:
    """diagnostics on the card with the trained flow at the flagship shape,
    on the sampler's own fields: z the runner's final latent fields (16^2 x
    64, thermalized at beta=6) and y = f(z). flow_inverse_residual of y
    below max(5e-5, 2x the CPU port's reading on the same flow and
    fields); reversibility_error with the kernel FT force (REV_CHAINS
    chains of z, REV_NSTEP steps) within 1e-4 of the field scale, and
    within that of the CPU port's reading on the same inputs (its plain
    twins); leapfrog_with_diagnostics against hmc.leapfrog on the same
    force, x and v within 1e-6; the step summary printed. On uniform
    random fields, far from what a sampler sees (forces of ~100, seams of
    the rncp inverse that the JAX package's bisection misses too: a 0.30
    residual at 16^2 x 64 on the CPU), the card's readings are printed,
    not gated."""
    g = torch.Generator(dev).manual_seed(91)
    v = torch.randn(z.shape, generator=g, device=dev)
    cpu = _copy_params(params, "cpu")
    with torch.no_grad():
        y, _ = kernel_flow_forward(params, z, spec)
    t0 = time.perf_counter()
    res = flow_inverse_residual(params, spec, y)
    res_cpu = flow_inverse_residual(cpu, spec, y.cpu())
    res_gate = max(5e-5, 2 * res_cpu)
    t_res = time.perf_counter() - t0
    dt = TAU / NSTEP
    zr, vr = z[:REV_CHAINS], v[:REV_CHAINS]
    t0 = time.perf_counter()
    with full_fp32():
        rev = reversibility_error(zr, vr, dt, REV_NSTEP, lambda zz:
                                  ft_force_kernel(params, spec, zz, BETA))
    rev_cpu = reversibility_error(zr.cpu(), vr.cpu(), dt, REV_NSTEP,
                                  lambda zz: ft_force_kernel(cpu, spec, zz,
                                                             BETA))
    t_rev = time.perf_counter() - t0
    rev_tol = 1e-4 * math.pi
    u = (torch.rand(z.shape, generator=g, device=dev) * 2 - 1) * math.pi
    with full_fp32():
        random_fields = {
            "inverse_residual": flow_inverse_residual(params, spec, u),
            "reversibility": reversibility_error(
                u[:REV_CHAINS], vr, dt, REV_NSTEP, lambda zz:
                ft_force_kernel(params, spec, zz, BETA))}

    def force_fn(zz):
        return ft_force_kernel(params, spec, zz, BETA)

    def action_fn(zz):
        yk, ld = kernel_flow_forward(params, zz, spec)
        return lattice.batch_action(yk, BETA) - ld

    xd, vd, info = leapfrog_with_diagnostics(z, v, dt, NSTEP, force_fn,
                                             action_fn)
    xl, vl = leapfrog(z, v, dt, NSTEP, force_fn)
    lf_err = (float((xd - xl).abs().max()), float((vd - vl).abs().max()))
    r = {"fields": "the runner's final latent fields and their image",
         "inverse_residual": res, "inverse_residual_cpu": res_cpu,
         "inverse_residual_gate": res_gate, "inverse_s": t_res,
         "reversibility": rev, "reversibility_cpu": rev_cpu,
         "reversibility_tol": rev_tol, "reversibility_s": t_rev,
         "uniform_random_fields_not_gated": random_fields,
         "leapfrog_diag_vs_plain_max_err": lf_err,
         "step_info": summarize_step_info(info)}
    say("diagnostics", **r)
    require(res <= res_gate, f"inverse residual {res} > {res_gate}")
    require(rev <= rev_tol and abs(rev - rev_cpu) <= rev_tol,
            f"reversibility {rev} vs CPU {rev_cpu} (tol {rev_tol})")
    require(max(lf_err) <= 1e-6, f"leapfrog_with_diagnostics {lf_err}")
    return r


def spline_phase(dev) -> dict:
    """SPLINE_TRAIN: one step's loss and gradients on the card against the
    CPU port (same z and parameters, 1e-4 relative in norm); train() on the
    card through its CUDA graph (the loss falls from the first 100 epochs
    to the last 100, one host synchronisation an era, no K6-K8 launch);
    flow sampling with flow_backend='torch', SPLINE_ENSEMBLE chains x
    samples (acceptance and chain-samples/s), and 'auto' (K6) refusing
    the spec."""
    cfg = SPLINE_TRAIN
    state = ttrain.init_train_state(None, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(97)
    z = (torch.rand((cfg.batch_size, 2, cfg.L, cfg.L), generator=g,
                    device=dev) * 2 - 1) * math.pi
    loss, _, grads = ttrain.loss_and_grads(state.params, cfg.flow, z,
                                           cfg.beta)
    loss_c, _, grads_c = ttrain.loss_and_grads(
        _copy_params(state.params, "cpu"), cfg.flow, z.cpu(), cfg.beta)
    a = torch.cat([t.flatten() for t in grads_c])
    b = torch.cat([t.flatten().cpu() for t in grads])
    rel = float((b - a).norm() / a.norm())
    rel_loss = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    require(rel <= 1e-4 and rel_loss <= 1e-4,
            f"spline gradients card vs CPU: {rel}, loss {rel_loss}")
    _build.reset_counts()
    t0 = time.perf_counter()
    (state, hist), syncs = _count_syncs(lambda: ttrain.train(cfg,
                                                             device=dev))
    t_train = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in ("K6", "K7", "K8")}
    loss_h = np.asarray(hist["loss_dkl"], dtype=np.float64)
    first, last = float(loss_h[:100].mean()), float(loss_h[-100:].mean())
    require(np.isfinite(loss_h).all() and last < first,
            f"spline training: loss {first} -> {last}")
    require(syncs == cfg.n_era, f"spline training: {syncs} host syncs for "
            f"{cfg.n_era} eras")
    n_chains, num = SPLINE_ENSEMBLE
    kw = dict(beta=cfg.beta, L=cfg.L, batch_size=cfg.batch_size,
              num_samples=num, n_chains=n_chains, device=dev)
    refused = _raises(lambda: tsample.make_mcmc_ensemble(
        state.params, cfg.flow, generator=torch.Generator(dev), **kw))
    require(refused is not None, "flow_backend='auto' took a spline flow")
    gen = torch.Generator(dev).manual_seed(98)
    tsample.make_mcmc_ensemble(state.params, cfg.flow, generator=gen,
                               flow_backend="torch",
                               **{**kw, "num_samples": 65})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = tsample.make_mcmc_ensemble(state.params, cfg.flow, generator=gen,
                                     flow_backend="torch", **kw)
    t_ens = time.perf_counter() - t0
    launches.update({k + "_sampling": _build.LAUNCHES[k] - launches[k]
                     for k in ("K6", "K7", "K8")})
    r = {"spec": dataclasses.asdict(cfg.flow), "grad_rel_err_norm": rel,
         "loss_rel_err": rel_loss, "epochs": cfg.n_era * cfg.n_epoch,
         "train_s": t_train,
         "steps_per_s": cfg.n_era * cfg.n_epoch / t_train,
         "host_syncs": syncs, "loss_first_100": first,
         "loss_last_100": last, "ensemble": list(SPLINE_ENSEMBLE),
         "acceptance": float(ens["acc"].mean()), "ensemble_s": t_ens,
         "chain_samples_per_s": n_chains * num / t_ens,
         "auto_refused": refused, "launches": launches}
    say("spline", **r)
    require(np.isfinite(ens["logq"]).all(), "spline sampling not finite")
    require(not any(launches.values()), f"spline path launched {launches}")
    return r


def phase11(dev, params, spec) -> dict:
    """Phase 11; returns the launches its kernel paths made."""
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    say("bf16_flagship", **timed("bf16", lambda: bf16_flagship(dev)))
    probes = timed("probes", lambda: mobility_probes(dev, params, spec))
    run = timed("runner", lambda: runner_phase(dev, params, spec))
    timed("diagnostics", lambda: diagnostics_phase(dev, params, spec,
                                                   run.pop("z")))
    timed("spline", lambda: spline_phase(dev))
    launched = probes["launches"]
    for k, v in run["launches"].items():
        launched[k] += v
    say("phase11", seconds=sum(seconds.values()), by_part=seconds,
        launches=launched)
    return launched


# ---------------------------------------------------------------------------
# phase 12: the parallel drivers
# ---------------------------------------------------------------------------

def _timed(fn):
    """(fn(), its wall seconds, the launches it made), the counters set to
    0 just before it."""
    _build.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.LAUNCHES)


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def chain_sharded_pair(name: str, sharded, single, expect: dict) -> dict:
    """A chain-sharded run and its single-device driver on the rank
    generator, in turns (single, sharded, sharded, single): the first pair
    bit for bit equal (final chains and every history field), the launch
    counters of each run equal to each other and to ``expect``; seconds
    of each, and the faster sharded run over the faster single one."""
    (x1, h1), t1a, l1 = _timed(single)
    (xs, hs), tsa, ls = _timed(sharded)
    _, tsb, _ = _timed(sharded)
    _, t1b, _ = _timed(single)
    r = {"bit_equal": torch.equal(x1, xs) and _bit_equal(h1, hs),
         "launches": ls, "single_launches": l1, "expected": expect,
         "sharded_s": [tsa, tsb], "single_s": [t1a, t1b],
         "sharded_over_single": min(tsa, tsb) / min(t1a, t1b),
         "acceptance": float(hs.acc.mean()),
         "exp_mdh": float(hs.exp_mdh.mean())}
    require(r["bit_equal"], f"{name}: sharded run != single-device run")
    require(ls == l1 == expect, f"{name} launches {ls}, {l1}, {expect}")
    return r


def parallel_chain_runs(mesh, dev, params, spec, z0) -> dict:
    """sharded_run_hmc (headline), sharded_run_fthmc (flagship) and
    sharded_run_hmc_dyn (path B) against their single-device drivers run
    with rank_generator(g, 0)."""
    out = {}
    hc = dataclasses.replace(HMC_CFG, ntraj=PAR_TRAJ["hmc"])
    x0 = torch.zeros((hc.n_chains, 2, hc.L, hc.L), device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    expect = dict.fromkeys(_build.KERNELS, 0)
    expect["K2"] = expect["K12"] = hc.ntraj
    out["hmc"] = chain_sharded_pair(
        "sharded_run_hmc",
        lambda: pmesh.sharded_run_hmc(mesh, hc, x0=x0, generator=gen(61)),
        lambda: run_hmc(hc, x0=x0, generator=pmesh.rank_generator(gen(61),
                                                                  0),
                        device=dev), expect)
    lf, n = LeapfrogConfig(tau=TAU, nstep=NSTEP), PAR_TRAJ["fthmc"]
    n_force, nl = 2 * NSTEP + 1, spec.n_layers
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect.update({"K1": n_force * n, "K6": 2 * nl * n + nl,
                   "K7": n_force * nl * n, "K8": n_force * nl * n})
    kw = dict(beta=BETA, ntraj=n, z0=z0, integrator="omelyan")
    out["fthmc"] = chain_sharded_pair(
        "sharded_run_fthmc",
        lambda: pmesh.sharded_run_fthmc(mesh, params, spec, lf,
                                        generator=gen(62), **kw),
        lambda: run_fthmc(params, spec, lf, device=dev,
                          generator=pmesh.rank_generator(gen(62), 0), **kw),
        expect)
    cfg = dataclasses.replace(DYN["B"], ntraj=PAR_TRAJ["hmc_dyn"])
    xb = near_equilibrium(gen(63), cfg.n_chains, cfg.L, cfg.beta, dev)
    n_force = force_evaluations(cfg)["dyn"]
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect.update({"K1": n_force * cfg.ntraj,            # K11: a solve a
                   "K11": (n_force + 1) * cfg.ntraj})   # force, one MH
    out["hmc_dyn"] = chain_sharded_pair(
        "sharded_run_hmc_dyn",
        lambda: pmesh.sharded_run_hmc_dyn(mesh, cfg, x0=xb,
                                          generator=gen(64)),
        lambda: run_hmc_dyn(cfg, x0=xb, device=dev,
                            generator=pmesh.rank_generator(gen(64), 0)),
        expect)
    return out


def _rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def parallel_training(mesh, dev) -> dict:
    """train(cfg, mesh=) for one era of the reference configuration: its
    first step's loss and gradients (``_dp_loss_and_grads``) against
    train's ``loss_and_grads`` on the same latents, then the era's losses
    against train_era's on the rank generator's draws, within 1e-5
    relative; steps/s of each."""
    cfg = PAR_TRAIN
    gen = torch.Generator(device=dev).manual_seed(65)
    state = ttrain.init_train_state(gen, cfg, device=dev)
    z = priors.uniform_link_prior(cfg.L, device=dev).sample_n(
        pmesh.rank_generator(gen, 1), cfg.batch_size)
    loss_m, _, grads_m, _ = pmesh._dp_loss_and_grads(
        mesh, state.params, cfg.flow, z, cfg.beta, cfg.dkl_factor)
    loss_1, _, grads_1 = ttrain.loss_and_grads(state.params, cfg.flow, z,
                                               cfg.beta, cfg.dkl_factor)
    g_m, g_1 = torch.cat([g.reshape(-1) for g in grads_m]), torch.cat(
        [g.reshape(-1) for g in grads_1])
    step = {"loss_rel_err": abs(float(loss_m - loss_1)) / abs(float(loss_1)),
            "grad_rel_err": _rel_norm(g_m, g_1)}
    single = state._replace(generator=pmesh.rank_generator(gen, 0))
    (_, hm), t_m, lm = _timed(lambda: ttrain.train(cfg, state, mesh=mesh))
    (_, h1), t_1, _ = _timed(lambda: ttrain.train_era(
        single, cfg.flow, cfg.batch_size, cfg.L, cfg.beta, cfg.dkl_factor,
        cfg.base_lr, cfg.n_epoch))
    lm_, l1_ = np.asarray(hm["loss_dkl"]), np.asarray(h1["loss_dkl"])
    ess = np.asarray(hm["ess"])
    r = {**step, "graphed": ttrain.MESH_ERA_GRAPHED, "epochs": cfg.n_epoch,
         "era_loss_max_rel_err": float(np.max(np.abs(lm_ - l1_)
                                              / np.abs(l1_))),
         "loss_first_last": [float(lm_[0]), float(lm_[-1])],
         "ess_last": float(ess[-1]),
         "mesh_steps_per_s": cfg.n_epoch / t_m,
         "single_steps_per_s": cfg.n_epoch / t_1, "launches": lm}
    require(step["loss_rel_err"] <= 1e-5 and step["grad_rel_err"] <= 1e-5,
            f"mesh step vs single: {step}")
    require(r["era_loss_max_rel_err"] <= 1e-5, f"mesh era vs single: {r}")
    require(np.isfinite(lm_).all() and ((ess > 0) & (ess <= 1)).all(),
            f"mesh era: {r}")
    return r


def _collectives_per(n: int) -> dict:
    return {k: v / n for k, v in pmesh.COLLECTIVES.items()}


def collective_ms(rows, dev, n: int = 200) -> dict:
    """Host wall ms a call of the domain drivers' two collectives at world
    size 1, each of n calls back to back then a synchronize: the halo
    exchange (``domain._fetch``, a row of 64 chains at 64^2 each way) and
    an all-reduce of 64 values."""
    row = torch.zeros((64, 1, 64), device=dev)
    vals = torch.zeros(64, device=dev)
    calls = {"halo_exchange": lambda: pdom._fetch(rows, (row, 1), (row, -1)),
             "all_reduce": lambda: pmesh._all_reduce(rows, vals)}
    out = {}
    for name, fn in calls.items():
        for _warm in range(2):                     # the first warms up
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3 / n
    return out


def parallel_domain(rows, dev, params, spec, z0) -> dict:
    """The row-sharded drivers at world size 1 (every halo row through the
    all-gather): one HMC step's core against hmc_step's 'xla' path on the
    same draws, a run's exactness, ft_force_sharded against the autograd
    force, a few FT trajectories, and the dynamical run at the JAX
    package's sharded test configuration; s a trajectory beside the
    single-device driver at the same configuration, collectives a
    trajectory, no kernel launched."""
    out = {"collective_ms": collective_ms(rows, dev)}
    cfg = dataclasses.replace(PAR_DOMAIN_HMC, ntraj=1)
    g = torch.Generator(device=dev).manual_seed(66)
    x = near_equilibrium(g, cfg.n_chains, cfg.L, cfg.beta, dev)
    state = g.get_state()
    v0 = torch.randn(x.shape, generator=g, device=dev)
    u = torch.rand((cfg.n_chains,), generator=g, device=dev)
    g.set_state(state)
    q0 = lattice.topo_charge(x)
    xr, _, mr = hmc_step(g, x, q0, cfg.beta, cfg.dt, cfg.nstep,
                         backend="xla", device=dev)
    xd, _, md = pdom._domain_hmc_step_from(
        pdom.shard_rows(rows, x), q0, pdom.shard_rows(rows, v0), u,
        beta=cfg.beta, dt=cfg.dt, nstep=cfg.nstep, mesh=rows)
    out["hmc_step_vs_xla"] = traj_check(
        "domain step", (pdom.gather_rows(rows, xd), md.dh,
                        md.acc.bool()), (xr, mr.dh, mr.acc.bool()), x, v0,
        u, cfg)
    therm, meas = PAR_DOMAIN_HMC_TRAJ
    x, _ = run_hmc(dataclasses.replace(PAR_DOMAIN_HMC, ntraj=therm), x0=x,
                   device=dev)
    cfg = dataclasses.replace(PAR_DOMAIN_HMC, ntraj=meas)
    pmesh.reset_collectives()
    (xd, h), t_d, l_d = _timed(lambda: pdom.run_domain_hmc(
        rows, cfg, x0=x, generator=torch.Generator(device=dev)
        .manual_seed(67)))
    coll = _collectives_per(cfg.ntraj)
    (_, hx), t_x, _ = _timed(lambda: run_hmc(cfg, x0=x, backend="xla",
                                             device=dev))
    (_, _), t_a, _ = _timed(lambda: run_hmc(cfg, x0=x, device=dev))
    em = float(h["exp_mdh"].mean())
    out["hmc"] = {"L": cfg.L, "chains": cfg.n_chains, "therm_single": therm,
                  "measured": meas, "exp_mdh": em,
                  "single_xla_exp_mdh": float(hx.exp_mdh.mean()),
                  "acceptance": float(h["acc"].mean()),
                  "plaq": float(h["plaq"].mean()),
                  "s_per_traj": t_d / cfg.ntraj,
                  "single_xla_s_per_traj": t_x / cfg.ntraj,
                  "single_auto_s_per_traj": t_a / cfg.ntraj,
                  "collectives_per_traj": coll, "launches": l_d}
    require(abs(em - 1.0) <= 0.05, f"domain hmc <exp(-dH)> {em}")
    require(not any(l_d.values()), f"domain hmc launched {l_d}")
    with full_fp32():
        f_d = pdom.gather_rows(rows, pdflow.ft_force_sharded(
            params, spec, pdom.shard_rows(rows, z0), BETA, L, rows))
        f_a = ft_force(params, spec, z0, BETA, device=dev)
    err, scale = float((f_d - f_a).abs().max()), float(f_a.abs().max())
    out["ft_force_vs_autograd"] = {"max_abs_err": err,
                                   "tolerance": 1e-4 * scale}
    require(err <= 1e-4 * scale, f"ft_force_sharded: {err} vs {scale}")
    n = PAR_DOMAIN_FT_TRAJ
    lf = LeapfrogConfig(tau=TAU, nstep=NSTEP)
    pmesh.reset_collectives()
    (zd, h), t_d, l_d = _timed(lambda: pdflow.run_domain_fthmc(
        rows, params, spec, lf, beta=BETA, ntraj=n, z0=z0,
        generator=torch.Generator(device=dev).manual_seed(68)))
    coll = _collectives_per(n)
    (_, h1), t_1, _ = _timed(lambda: run_fthmc(
        params, spec, lf, beta=BETA, ntraj=n, z0=z0, device=dev,
        generator=torch.Generator(device=dev).manual_seed(68)))
    q = h["q"]
    out["fthmc"] = {"trajectories": n, "acceptance": float(h["acc"].mean()),
                    "exp_mdh": float(h["exp_mdh"].mean()),
                    "single_kernel_acceptance": float(h1.acc.mean()),
                    "s_per_traj": t_d / n, "single_kernel_s_per_traj": t_1 / n,
                    "collectives_per_traj": coll, "launches": l_d}
    require(all(bool(torch.isfinite(t).all()) for t in h.values())
            and bool(torch.isfinite(zd).all()), "domain fthmc not finite")
    require(bool((q - q.round()).abs().max() <= 1e-3), "domain fthmc: Q")
    require(not any(l_d.values()), f"domain fthmc launched {l_d}")
    therm, meas = PAR_DOMAIN_DYN_TRAJ
    g = torch.Generator(device=dev).manual_seed(69)
    single_cfg = dataclasses.replace(PAR_DOMAIN_DYN, ntraj=therm)
    x = near_equilibrium(g, single_cfg.n_chains, single_cfg.L,
                         single_cfg.beta, dev)
    (x, _), t_1, _ = _timed(lambda: run_hmc_dyn(single_cfg, x0=x,
                                                generator=g, device=dev))
    dcfg = dataclasses.replace(PAR_DOMAIN_DYN, ntraj=meas)
    log = tf.CGLog()
    pmesh.reset_collectives()
    (_, h), t_d, l_d = _timed(lambda: pdferm.run_domain_hmc_dyn_chunked(
        rows, dcfg, x0=x, block=PAR_DOMAIN_DYN_BLOCK, cg_log=log,
        generator=torch.Generator(device=dev).manual_seed(70)))
    coll = _collectives_per(dcfg.ntraj)
    em = float(h["exp_mdh"].mean())
    plaq = float(h["plaq"].mean())
    out["hmc_dyn"] = {
        "L": dcfg.L, "beta": dcfg.beta, "mass": dcfg.mass,
        "chains": dcfg.n_chains, "therm_single": therm, "measured": meas,
        "exp_mdh": em, "acceptance": float(h["acc"].mean()),
        "plaq": plaq, "plaq_jax_sharded": PAR_DYN_PLAQ,
        "plaq_stderr_naive": float(h["plaq"].mean(dim=1).std()
                                   / math.sqrt(meas)),
        "cg_iters_mean": {k: log.mean_iters(k) for k in log.solves},
        "cg_host_reads_per_solve": log.reads() / log.count(),
        "cg_solves_per_traj": log.count() / dcfg.ntraj,
        "s_per_traj": t_d / dcfg.ntraj,
        "single_k11_s_per_traj": t_1 / single_cfg.ntraj,
        "collectives_per_traj": coll, "launches": l_d}
    require(abs(em - 1.0) <= 0.05, f"domain dyn <exp(-dH)> {em}")
    require(not any(l_d.values()), f"domain dyn launched {l_d}")
    return out


def parallel_phase(dev, params, spec, z0) -> dict:
    """Phase 12 on a world-size-1 NCCL group (a HashStore, no TCP port),
    destroyed at the end; returns the launches of its chain-sharded runs
    (the domain drivers and training launch no kernel)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    pmesh.initialize_multihost(num_processes=1, process_id=0,
                               store=dist.HashStore())
    try:
        chains = pmesh.make_chain_mesh(device=dev)
        rows = pdom.make_rows_mesh(device=dev)
        # NCCL builds its communicator at the first collective: not timed
        pmesh.gather_chains(chains, torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        runs = parallel_chain_runs(chains, dev, params, spec, z0)
        say("parallel_chains", **runs)
        say("parallel_training", **parallel_training(chains, dev))
        say("parallel_domain", **parallel_domain(rows, dev, params, spec,
                                                 z0))
    finally:
        dist.destroy_process_group()
    launched = dict.fromkeys(_build.KERNELS, 0)
    for r in runs.values():
        for k, v in r["launches"].items():
            launched[k] += v
    say("parallel", seconds=time.perf_counter() - t0, world_size=1,
        backend="nccl", launches=launched)
    return launched


# ---------------------------------------------------------------------------
# phase 13: the command line and the API facade on the card
# ---------------------------------------------------------------------------

def _counted(fn):
    """fn() with the launch counters set to 0 just before it and read just
    after: (its result, wall seconds, launches, plain twin calls)."""
    _build.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, dict(_build.LAUNCHES),
            dict(_build.PLAIN_CALLS))


def _hold_launches(what: str, launches: dict, plain: dict,
                   expect: dict) -> dict:
    want = {**dict.fromkeys(_build.KERNELS, 0), **expect}
    require(launches == want, f"{what}: launches {launches} != {want}")
    require(not any(plain.values()), f"{what}: plain twins ran {plain}")
    return want


def _cli(argv: list, expect: dict | None = None):
    """fthmc_tpu_torch.cli.main(argv) in this process, the launch counters
    set to 0 just before it and read just after: (its dict, wall seconds,
    launches); held to ``expect`` (kernel -> count, the rest 0) when
    given, with no plain twin run."""
    from fthmc_tpu_torch import cli
    out, wall, launches, plain = _counted(lambda: cli.main(argv))
    if expect is not None:
        _hold_launches(f"cli {argv[0]}", launches, plain, expect)
    return out, wall, launches


def _ft_launches(n_force: int, n_layers: int, ntraj: int) -> dict:
    """An FT-HMC run's launches: K1, K7 and K8 a force (K7/K8 a layer), K6
    a layer an energy flow (two a trajectory and the start's charge)."""
    return {"K1": n_force * ntraj, "K6": n_layers * (2 * ntraj + 1),
            "K7": n_force * n_layers * ntraj,
            "K8": n_force * n_layers * ntraj}


def cli_fthmc_flagship(spec, phase7_s_per_traj: float) -> dict:
    """`fthmc` at the flagship (the exported flow, full width) from z0 =
    f^-1(0), with phase 4's gates and phase 5's launches a trajectory."""
    n = CLI_FT_TRAJ
    argv = ["fthmc", "--ckpt", str(FLAGSHIP_NPZ), "--L", str(L), "--beta",
            str(BETA), "--tau", str(TAU), "--nstep", str(NSTEP),
            "--integrator", "omelyan", "--chains", str(B), "--start", "cold",
            "--ntraj", str(n)]
    out, wall, launches = _cli(argv, _ft_launches(2 * NSTEP + 1,
                                                  spec.n_layers, n))
    r = {"argv": argv, "acceptance": out["acc"], "plaq": out["plaq"],
         "plaq_exact": lattice.PLAQ_EXACT[BETA], "exp_mdh": out["exp_mdh"],
         "s_per_traj": out["s_per_traj"],
         "phase7_run_fthmc_s_per_traj": phase7_s_per_traj,
         "wall_s": wall, "launches": launches}
    require(r["acceptance"] >= MIN_ACCEPTANCE,
            f"cli fthmc acceptance {r['acceptance']}")
    require(abs(r["plaq"] - r["plaq_exact"]) <= 0.003,
            f"cli fthmc plaq {r['plaq']}")
    require(abs(r["exp_mdh"] - 1.0) <= 0.1,
            f"cli fthmc <exp(-dH)> {r['exp_mdh']}")
    return r


def cli_hmc(phase6_acceptance: float) -> dict:
    """`hmc` at the headline from a cold start (K2 a trajectory), and
    `hmc --nrun 2` at 16^2 (K3)."""
    hc = HMC_CFG
    n = CLI_HMC_TRAJ
    argv = ["hmc", "--L", str(hc.L), "--beta", str(hc.beta), "--tau",
            str(hc.tau), "--nstep", str(hc.nstep), "--chains",
            str(hc.n_chains), "--start", "cold", "--ntraj", str(n)]
    out, wall, launches = _cli(argv, {"K2": n, "K12": n})
    require(abs(out["exp_mdh"] - 1.0) <= 0.05,
            f"cli hmc <exp(-dH)> {out['exp_mdh']}")
    n3, runs = CLI_NRUN
    argv3 = ["hmc", "--L", "16", "--beta", str(hc.beta), "--tau",
             str(hc.tau), "--nstep", str(hc.nstep), "--chains", "64",
             "--start", "cold", "--ntraj", str(n3), "--nrun", str(runs)]
    out3, wall3, launches3 = _cli(argv3, {"K3": n3 * runs,
                                          "K12": n3 * runs})
    require(out3["plaq_err"] > 0 and abs(out3["exp_mdh"] - 1.0) <= 0.05,
            f"cli hmc --nrun: {out3}")
    return {"headline": {"argv": argv, "acceptance": out["acc"],
                         "phase6_acceptance": phase6_acceptance,
                         "exp_mdh": out["exp_mdh"], "plaq": out["plaq"],
                         "s_per_traj": out["s_per_traj"], "wall_s": wall,
                         "launches": launches},
            "nrun": {"argv": argv3, "acceptance": out3["acc"],
                     "plaq": out3["plaq"], "plaq_err": out3["plaq_err"],
                     "exp_mdh": out3["exp_mdh"], "wall_s": wall3,
                     "launches": launches3}}


def cli_schwinger_state(dev, tmp: str) -> dict:
    """Plain `schwinger` at beta=2, m=0.2 through --state, in two calls
    (the second resumes at the first's end and measures the condensate):
    one K11 launch a solve (a force and the Metropolis solve a trajectory;
    the condensate's solve counted alone first), K1 a force; the resume
    keeps the first call's rows; <plaq> over the last 120 trajectories
    within max(0.004, 5 blocked errors) of the JAX package's reading of
    the same protocol, <exp(-dH)> within 0.05 of 1."""
    cfg = CLI_SCHW
    n1, n2 = CLI_SCHW_TRAJ
    state = os.path.join(tmp, "schwinger_state.npz")
    argv = ["schwinger", "--L", str(cfg.L), "--beta", str(cfg.beta),
            "--mass", str(cfg.mass), "--tau", str(cfg.tau), "--nstep",
            str(cfg.nstep), "--chains", str(cfg.n_chains), "--start", "hot",
            "--block", str(CLI_SCHW_BLOCK), "--state", state]
    nf = force_evaluations(cfg)["dyn"]
    # the condensate's launches alone, on configurations of this shape
    x = near_equilibrium(torch.Generator(dev).manual_seed(90), cfg.n_chains,
                         cfg.L, cfg.beta, dev)
    _build.reset_counts()
    tf.chiral_condensate(torch.Generator(dev).manual_seed(91), x, cfg.mass,
                         n_noise=8)
    torch.cuda.synchronize()
    cond = {k: v for k, v in _build.LAUNCHES.items() if v}
    per_call = {"K1": nf * n1, "K11": (nf + 1) * n1}
    out1, wall1, l1 = _cli(argv + ["--ntraj", str(n1)], per_call)
    with np.load(state) as d:
        first = {k: d[k] for k in TrajMetrics._fields}
        require(int(d["done"]) == n1, f"cli schwinger done {d['done']}")
    second = {"K1": nf * (n2 - n1),
              "K11": (nf + 1) * (n2 - n1) + cond.get("K11", 0)}
    out2, wall2, l2 = _cli(argv + ["--ntraj", str(n2), "--condensate"],
                           second)
    with np.load(state) as d:
        done = int(d["done"])
        kept = all(np.array_equal(d[k][:n1], v) for k, v in first.items())
        plaq_rows = d["plaq"][n2 // 4:]
    require(done == n2 and kept, f"cli schwinger resume: done {done}, the "
            f"first {n1} rows kept: {kept}")
    per = plaq_rows.mean(axis=1)
    stderr = float(per.reshape(10, -1).mean(axis=1).std(ddof=1)
                   / math.sqrt(10))
    bound = max(0.004, 5 * stderr)
    r = {"argv": argv, "trajectories": [n1, n2], "done": done,
         "first_rows_kept": kept, "plaq": out2["plaq"],
         "plaq_stderr_blocked": stderr, "plaq_bound": bound,
         "plaq_jax": CLI_SCHW_PLAQ, "plaq_jax_notes": PAR_DYN_PLAQ,
         "exp_mdh": out2["exp_mdh"],
         "acceptance": out2["acc"], "psibar_psi": out2["psibar_psi"],
         "psibar_psi_err": out2["psibar_psi_err"],
         "forces_per_traj": nf, "condensate_launches": cond,
         "s_per_traj": [wall1 / n1, wall2 / (n2 - n1)],
         "launches": [l1, l2]}
    require(abs(r["plaq"] - CLI_SCHW_PLAQ[0]) <= bound,
            f"cli schwinger plaq {r['plaq']} vs {CLI_SCHW_PLAQ[0]} (bound "
            f"{bound})")
    require(abs(r["exp_mdh"] - 1.0) <= 0.05,
            f"cli schwinger <exp(-dH)> {r['exp_mdh']}")
    return r


def cli_schwinger_ft(spec, path_c_acceptance: float) -> dict:
    """`schwinger --ckpt` with the flagship flow at path C's shape from z0
    = f^-1(0): K1, K6-K8 and K11 as dyn_expected counts them."""
    cfg, n = DYN["C"], CLI_SCHW_FT_TRAJ
    argv = ["schwinger", "--ckpt", str(FLAGSHIP_NPZ), "--L", str(cfg.L),
            "--beta", str(cfg.beta), "--mass", str(cfg.mass), "--tau",
            str(cfg.tau), "--nstep", str(cfg.nstep), "--chains",
            str(cfg.n_chains), "--start", "cold", "--ntraj", str(n)]
    nf = force_evaluations(cfg)["dyn"]
    expect = {**_ft_launches(nf, spec.n_layers, n), "K11": (nf + 1) * n}
    out, wall, launches = _cli(argv, expect)
    require(np.isfinite(out["exp_mdh"]), "cli schwinger --ckpt not finite")
    return {"argv": argv, "acceptance": out["acc"],
            "path_c_acceptance": path_c_acceptance,
            "exp_mdh": out["exp_mdh"], "plaq": out["plaq"],
            "s_per_traj": out["s_per_traj"], "wall_s": wall,
            "launches": launches}


def cli_train_sample_fthmc(tmp: str) -> dict:
    """`train` at the reference configuration, then `sample` and `fthmc`
    from its checkpoints: K6 exactly once a layer a block in sampling, the
    FT run's launches a force and a flow."""
    cfg = REF_TRAIN
    outdir = os.path.join(tmp, "train")
    argv = ["train", "--n-layers", str(cfg.flow.n_layers), "--hidden",
            *map(str, cfg.flow.hidden_sizes), "--L", str(cfg.L), "--beta",
            str(cfg.beta), "--n-era", "1", "--n-epoch", str(cfg.n_epoch),
            "--outdir", outdir]
    tr, wall_t, l_t = _cli(argv, {})
    ck = os.path.join(outdir, "checkpoints")
    size, chains, batch = CLI_SAMPLE
    nblocks = -(-(size - 1) // batch)
    nl = cfg.flow.n_layers
    sargv = ["sample", "--ckpt", ck, "--L", str(cfg.L), "--beta",
             str(cfg.beta), "--ensemble-size", str(size), "--sample-chains",
             str(chains), "--batch-size", str(batch)]
    sm, wall_s, l_s = _cli(sargv, {"K6": nl * (nblocks + 1)})
    require(0.0 < sm["accept_rate"] <= 1.0,
            f"cli sample acceptance {sm['accept_rate']}")
    n, nstep = CLI_TRAINED_FT
    fargv = ["fthmc", "--ckpt", ck, "--L", str(cfg.L), "--beta",
             str(cfg.beta), "--ntraj", str(n), "--nstep", str(nstep)]
    # position Verlet (hmc.leapfrog): nstep forces a trajectory
    ft, wall_f, l_f = _cli(fargv, _ft_launches(nstep, nl, n))
    require(np.isfinite(ft["exp_mdh"]), "cli fthmc (trained) not finite")
    plots = os.path.isdir(os.path.join(outdir, "plots"))
    return {"train": {"argv": argv, "ess": tr["ess"],
                      "loss_dkl": tr["loss_dkl"], "wall_s": wall_t,
                      "steps_per_s": cfg.n_epoch / tr["wall_s"],
                      "plots_written": plots, "launches": l_t},
            "sample": {"argv": sargv, "accept_rate": sm["accept_rate"],
                       "chi_q": sm["suscept_mean"],
                       "tau_int_q": sm["tau_int_q"], "blocks": nblocks,
                       "wall_s": wall_s, "launches": l_s},
            "fthmc": {"argv": fargv, "acceptance": ft["acc"],
                      "exp_mdh": ft["exp_mdh"], "wall_s": wall_f,
                      "launches": l_f}}


def cli_pipeline_highbeta(spec) -> dict:
    """`pipeline --mode highbeta` with the flagship flow at 16^2, beta=6:
    FT-HMC (cold, Omelyan) then plain HMC ('auto': K3 at 16^2), the
    head-to-head keys returned."""
    ft_n, ft_nstep, ft_chains, pl_n, pl_nstep, pl_chains = CLI_HIGHBETA
    argv = ["pipeline", "--mode", "highbeta", "--ckpt", str(FLAGSHIP_NPZ),
            "--L", str(L), "--beta", str(BETA), "--tau", str(TAU),
            "--ntraj", str(ft_n), "--ft-nstep", str(ft_nstep),
            "--ft-chains", str(ft_chains), "--plain-ntraj", str(pl_n),
            "--plain-nstep", str(pl_nstep), "--plain-chains",
            str(pl_chains)]
    expect = {**_ft_launches(2 * ft_nstep + 1, spec.n_layers, ft_n),
              "K3": pl_n, "K12": pl_n}
    out, wall, launches = _cli(argv, expect)
    keys = {"mode", "L", "beta", "fthmc", "hmc", "tau_int_speedup",
            "tau_int_speedup_err"}
    require(keys <= set(out), f"cli pipeline keys {sorted(out)}")
    return {"argv": argv, "ft_acceptance": out["fthmc"]["acc"],
            "plain_acceptance": out["hmc"]["acc"],
            "tau_int_ft": out["fthmc"]["tau_int_q"],
            "tau_int_plain": out["hmc"]["tau_int_q"],
            "tau_int_speedup": out["tau_int_speedup"],
            "tau_int_speedup_err": out["tau_int_speedup_err"],
            "wall_s": wall, "launches": launches}


def cli_subprocess() -> dict:
    """`python3 -m fthmc_tpu_torch.cli hmc` in a process of its own (the
    card by default); it must exit 0."""
    argv = [sys.executable, "-m", "fthmc_tpu_torch.cli", "hmc", "--L", "16",
            "--ntraj", "16", "--chains", "64"]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    tail = r.stdout.strip().splitlines()[-1:] + r.stderr.strip().splitlines(
    )[-3:]
    require(r.returncode == 0, f"python3 -m fthmc_tpu_torch.cli hmc exited "
            f"{r.returncode}: {tail}")
    return {"argv": argv[1:], "returncode": r.returncode, "wall_s": wall,
            "last_line": tail[0] if tail else ""}


def facade_and_trace(dev, params, spec, z, tmp: str) -> dict:
    """api.FieldTransformation's force (the kernels) against hmc.ft_force
    (autograd) at phase 3's kernel-chain tolerance; utils.profiling.trace
    around two flagship trajectories writes a Chrome trace naming K6/K7's
    and K8's kernels."""
    from fthmc_tpu_torch import api
    from fthmc_tpu_torch.utils.profiling import trace
    lf = LeapfrogConfig(tau=TAU, nstep=NSTEP)
    ft = api.FieldTransformation(params, spec, BETA, lf)
    with full_fp32():
        _build.reset_counts()
        f_k = ft.force(z)
        torch.cuda.synchronize()
        facade_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        f_a = ft_force(params, spec, z, BETA, device=dev)
    err = float((f_k - f_a).abs().max())
    tol = 2e-3 * max(1.0, float(f_a.abs().max()))
    nl = spec.n_layers
    require(facade_launches == {"K1": 1, "K7": nl, "K8": nl},
            f"facade force launches {facade_launches}")
    require(err <= tol, f"facade force vs autograd: {err} > {tol}")
    _build.reset_counts()
    with trace(os.path.join(tmp, "trace")):
        ft.run(torch.Generator(dev).manual_seed(95), z, num_trajs=2)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    (name,) = os.listdir(os.path.join(tmp, "trace"))
    path = os.path.join(tmp, "trace", name)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events
               if e.get("cat") == "kernel"]
    count = {k: sum(k in n for n in kernels)
             for k in ("coupling_fwd_kernel", "coupling_bwd_kernel")}
    require(all(count.values()), f"trace: kernel names {count} missing "
            f"from {path}")
    return {"force_max_abs_err": err, "force_tolerance": tol,
            "force_launches": facade_launches,
            "trace_file": os.path.basename(path),
            "trace_bytes": os.path.getsize(path),
            "trace_kernel_events": count, "trace_run_launches": launches}


def cli_phase(dev, params, spec, z, ref: dict) -> dict:
    """Phase 13: the CLI's subcommands driven in this process at full
    width, each with its launch counters set to 0 just before it and held
    to its count; a subprocess of the CLI; the facade's force and the
    profiler's trace. Returns the launches of the phase's runs."""
    import tempfile
    t0 = time.perf_counter()
    seconds = {}
    runs = {}

    def timed(name, fn):
        t = time.perf_counter()
        runs[name] = fn()
        seconds[name] = time.perf_counter() - t
        say("cli_" + name, **runs[name])

    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        timed("fthmc", lambda: cli_fthmc_flagship(spec, ref["s_per_traj"]))
        timed("hmc", lambda: cli_hmc(ref["hmc_acceptance"]))
        timed("schwinger", lambda: cli_schwinger_state(dev, tmp))
        timed("schwinger_ft", lambda: cli_schwinger_ft(spec,
                                                       ref["c_acceptance"]))
        timed("train_sample_fthmc", lambda: cli_train_sample_fthmc(tmp))
        timed("pipeline", lambda: cli_pipeline_highbeta(spec))
        timed("subprocess", cli_subprocess)
        timed("facade", lambda: facade_and_trace(dev, params, spec, z, tmp))
    launched = dict.fromkeys(_build.KERNELS, 0)

    def add(d):
        for k, v in d.items():
            launched[k] += v

    add(runs["fthmc"]["launches"])
    add(runs["hmc"]["headline"]["launches"])
    add(runs["hmc"]["nrun"]["launches"])
    for d in runs["schwinger"]["launches"]:
        add(d)
    add(runs["schwinger_ft"]["launches"])
    for k in ("train", "sample", "fthmc"):
        add(runs["train_sample_fthmc"][k]["launches"])
    add(runs["pipeline"]["launches"])
    say("cli", seconds=time.perf_counter() - t0, by_part=seconds,
        launches=launched)
    return launched


# ---------------------------------------------------------------------------
# phase 14: the entry points on the card
# ---------------------------------------------------------------------------

def bench_entry(tmp: str) -> dict:
    """`python3 -m fthmc_tpu_torch.bench` at its defaults in a process of
    its own: exit 0, its first stdout line a JSON object with the JAX
    script's four keys; the headline and the extras' times from its
    --extra-json record."""
    extra = os.path.join(tmp, "bench_extra.json")
    argv = [sys.executable, "-m", "fthmc_tpu_torch.bench", "--extra-json",
            extra]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    require(r.returncode == 0, f"bench entry exited {r.returncode}: "
            f"{r.stderr.strip().splitlines()[-3:]}")
    head = json.loads(lines[0])
    require(list(head) == ["metric", "value", "unit", "vs_baseline"]
            and len(lines) == 1, f"bench entry stdout {lines}")
    with open(extra) as f:
        rec = json.load(f)
    return {"argv": argv[1:-2], "returncode": r.returncode, "wall_s": wall,
            "headline": head,
            "headline_s_per_traj": HMC_CFG.nstep * HMC_CFG.n_chains
            / head["value"],
            "extras": {k: {"chain_steps_per_s": v["value"],
                           "s_per_traj": v["s_per_traj"]}
                       for k, v in rec.items() if k != "headline"},
            "stderr_tail": r.stderr.strip().splitlines()[-2:]}


def entry_step(dev) -> dict:
    """entry()'s FT-HMC step once (K7, K1, K8 a force, K6 a layer an energy
    flow), its force held against the autograd force on the same z at
    phase 3's chain tolerance; dH finite."""
    from fthmc_tpu_torch import entry as pentry
    fn, args = pentry.entry()
    params, _, z, _ = args
    spec, nl, n = pentry.ENTRY_SPEC, pentry.ENTRY_SPEC.n_layers, \
        pentry.ENTRY_NSTEP
    (_, _, _, m), wall, launches, plain = _counted(lambda: fn(*args))
    want = _hold_launches("entry()", launches, plain,
                          {"K1": n, "K6": 2 * nl, "K7": n * nl,
                           "K8": n * nl})
    with full_fp32():
        f_k = ft_force_kernel(params, spec, z, pentry.ENTRY_BETA)
        f_a = ft_force(params, spec, z, pentry.ENTRY_BETA, device=dev)
    err = float((f_k - f_a).abs().max())
    tol = 2e-3 * max(1.0, float(f_a.abs().max()))
    require(err <= tol, f"entry() force vs autograd: {err} > {tol}")
    require(bool(torch.isfinite(m.dh).all()), "entry() dH not finite")
    return {"dh": m.dh.tolist(), "acc": m.acc.tolist(), "wall_s": wall,
            "force_max_abs_err": err, "force_tolerance": tol,
            "launches": launches, "expected": want}


def dryrun_one_rank(dev) -> dict:
    """dryrun_multichip(1) on a group of one NCCL rank, with its launches:
    the chain-sharded runs' kernels (K3 and K12 at 8^2; the FT steps' K1,
    K6-K8; the dynamical runs' K11 a solve and K1 a force); the training
    and the row-sharded stages launch none."""
    from fthmc_tpu_torch import entry as pentry
    out, wall, launches, plain = _counted(lambda: pentry.dryrun_multichip(1))
    scfg = SchwingerConfig(L=8, beta=2.0, mass=0.3, tau=0.5, nstep=2)
    nf = force_evaluations(scfg)["dyn"]
    # (leapfrog forces, trajectories) of the FT step and run, the
    # dynamical runs' trajectories, the dry run's flow's layers
    ft_runs, dyn_n, nl = ((2, 1), (2, 3)), 2, 2
    expect = {"K1": sum(a * b for a, b in ft_runs) + 2 * nf * dyn_n,
              "K3": 4, "K12": 4,
              "K6": nl * (2 + (2 * 3 + 1) + (2 * dyn_n + 1)),
              "K7": nl * (sum(a * b for a, b in ft_runs) + nf * dyn_n),
              "K11": 2 * (nf + 1) * dyn_n}
    expect["K8"] = expect["K7"]
    want = _hold_launches("dryrun_multichip(1)", launches, plain, expect)
    return {"stages": out, "wall_s": wall, "launches": launches,
            "expected": want}


def demo_highbeta_run(spec) -> dict:
    """demo_highbeta at its defaults (16^2, 64 chains, 128 Omelyan steps,
    the beta=3 flow at beta=6, hot start) for DEMO_HIGHBETA_NTRAJ
    trajectories: <exp(-dH)> within 0.1 of 1, acceptance >= 0.5; <plaq>
    printed beside exact. K1, K7, K8 a force, K6 a layer an energy flow
    (two a trajectory and one a block of 16)."""
    from fthmc_tpu_torch.examples import demo_highbeta
    n = DEMO_HIGHBETA_NTRAJ
    argv = ["--ntraj", str(n)]
    out, wall, launches, plain = _counted(lambda: demo_highbeta.main(argv))
    nf, nl = 2 * 128 + 1, spec.n_layers
    blocks = -(-n // demo_highbeta.BLOCK)
    want = _hold_launches("demo_highbeta", launches, plain, {
        "K1": nf * n, "K6": nl * (2 * n + blocks), "K7": nf * nl * n,
        "K8": nf * nl * n})
    require(abs(out["exp_mdh"] - 1.0) <= 0.1,
            f"demo_highbeta <exp(-dH)> {out['exp_mdh']}")
    require(out["acc"] >= 0.5, f"demo_highbeta acceptance {out['acc']}")
    return {"argv": argv, **out, "wall_s": wall, "s_per_traj": wall / n,
            "launches": launches, "expected": want}


def demo_schwinger_run(dev, spec) -> dict:
    """demo_schwinger at its default widths (8^2, 32 chains, beta=3,
    m=0.2, 'auto': K11) for DEMO_SCHWINGER_NTRAJ trajectories a leg:
    gamma_5-hermiticity <= 1e-8, the plain leg's <exp(-dH)> within 0.05
    of 1. K11 a solve and K1 a force in both legs, K7/K8 a layer a force
    and K6 a layer an energy flow in the FT leg, and the pion
    correlator's solve (counted alone first, on links of its shape)."""
    from fthmc_tpu_torch.examples import demo_schwinger
    n, L, chains = DEMO_SCHWINGER_NTRAJ, 8, 32
    x = near_equilibrium(torch.Generator(dev).manual_seed(92), 4, L, 3.0,
                         dev)
    _, _, pion, _ = _counted(lambda: tf.pion_correlator(x, 0.2))
    argv = ["--ntraj", str(n)]
    out, wall, launches, plain = _counted(lambda: demo_schwinger.main(argv))
    nf = force_evaluations(SchwingerConfig(L=L, beta=3.0, mass=0.2,
                                           tau=1.0, nstep=16))["dyn"]
    nf_ft = force_evaluations(SchwingerConfig(L=L, beta=3.0, mass=0.2,
                                              tau=0.5, nstep=8))["dyn"]
    nl = spec.n_layers
    want = _hold_launches("demo_schwinger", launches, plain, {
        "K1": (nf + nf_ft) * n,
        "K11": (nf + 1 + nf_ft + 1) * n + pion["K11"],
        "K6": nl * (2 * n + 1), "K7": nf_ft * nl * n,
        "K8": nf_ft * nl * n})
    require(out["chains"] == chains, f"demo_schwinger chains {out}")
    require(out["g5_hermiticity"] <= 1e-8,
            f"demo_schwinger gamma5 {out['g5_hermiticity']}")
    require(abs(out["plain"]["exp_mdh"] - 1.0) <= 0.05,
            f"demo_schwinger <exp(-dH)> {out['plain']['exp_mdh']}")
    return {"argv": argv, **out, "wall_s": wall,
            "pion_launches": {k: v for k, v in pion.items() if v},
            "launches": launches, "expected": want}


def demo_2d_u1_run() -> dict:
    """demo_2d_u1 at its defaults (8^2, beta=2, 64 HMC chains, the
    16-layer flow trained 10 x 100 epochs, 8192 flow samples, 16 FT
    chains with 64 leapfrog steps), the FT and transfer trajectories cut
    (DEMO_2D_U1_CUT): the HMC's and FT-HMC's <plaq> within max(0.004, 5
    sigma) of exact (sigma over the chains). K3 a plain trajectory; K6 a
    layer a sampling block and the initial draw; K1, K7, K8 a force and
    K6 a layer an energy flow in FT-HMC."""
    from fthmc_tpu_torch.examples import demo_2d_u1
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in DEMO_2D_U1_CUT.items()]
    out, wall, launches, plain = _counted(lambda: demo_2d_u1.main(argv))
    n = out["lengths"]
    nl, nstep = 16, 64
    blocks = max(1, -(-(n["ensemble_size"] - 1) // 64))
    ft = n["ft_ntraj"] + n["transfer_ntraj"]
    want = _hold_launches("demo_2d_u1", launches, plain, {
        "K3": n["hmc_ntraj"], "K12": n["hmc_ntraj"], "K1": nstep * ft,
        "K6": nl * (blocks + 1) + nl * (2 * ft + 2),
        "K7": nstep * nl * ft, "K8": nstep * nl * ft})
    exact = lattice.PLAQ_EXACT[2.0]
    for leg in ("hmc", "fthmc"):
        r = out[leg]
        bound = max(0.004, 5 * r["plaq_err"])
        r["plaq_bound"] = bound
        require(abs(r["plaq"] - exact) <= bound,
                f"demo_2d_u1 {leg} plaq {r['plaq']} vs {exact} (bound "
                f"{bound})")
    return {"argv": argv, **out, "wall_s": wall, "launches": launches,
            "expected": want}


def entry_phase(dev, spec) -> dict:
    """Phase 14: the bench entry in a subprocess, entry()'s step,
    dryrun_multichip(1) and the three demos in this process, each run's
    launch counters set to 0 just before it and held to its count.
    Returns the launches of the runs in this process."""
    import tempfile
    t0 = time.perf_counter()
    seconds, runs = {}, {}

    def timed(name, fn):
        t = time.perf_counter()
        runs[name] = fn()
        seconds[name] = time.perf_counter() - t
        say("entry_" + name, **runs[name])

    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        timed("bench", lambda: bench_entry(tmp))
    timed("step", lambda: entry_step(dev))
    timed("dryrun", lambda: dryrun_one_rank(dev))
    timed("demo_highbeta", lambda: demo_highbeta_run(spec))
    timed("demo_schwinger", lambda: demo_schwinger_run(dev, spec))
    timed("demo_2d_u1", demo_2d_u1_run)
    launched = dict.fromkeys(_build.KERNELS, 0)
    for name, r in runs.items():
        for k, v in r.get("launches", {}).items():
            launched[k] += v
    say("entry_points", seconds=time.perf_counter() - t0, by_part=seconds,
        launches=launched)
    return launched


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    reports = _build.build_all()
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in reports.items()}
    say("build", seconds=time.perf_counter() - t0, ptxas=regs)

    # 2. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    # 3. kernels against their plain twins, flagship shapes
    params, spec = load_flow_npz(device=dev)
    g = torch.Generator(device=dev).manual_seed(2026)
    cin = {name: coupling_inputs(g, cb, cl, dev)
           for name, (cb, cl, _) in COUPLING_SHAPES.items()}
    x, gy, gl = cin["flagship"]
    errs, tols = {}, {}
    errs["K1"], tols["K1"], k1_by_shape = compare_k1(dev)
    with full_fp32():
        by_shape = {}
        for name, (_, _, layers) in COUPLING_SHAPES.items():
            pairs = compare_coupling(params, spec, *cin[name], layers)
            by_shape[name] = {k: max(e for e, _ in pr)
                              for k, pr in pairs.items()}
            for k, pr in pairs.items():
                errs[k] = max(errs.get(k, 0.0), max(e for e, _ in pr))
                tols[k] = min(tols.get(k, math.inf), min(t for _, t in pr))
        f_k = ft_force_kernel(params, spec, x, BETA)
        f_a = ft_force(params, spec, x, BETA, device=dev)
        torch.cuda.synchronize()
        chain_err = float((f_k - f_a).abs().max())
        chain_tol = 2e-3 * max(1.0, float(f_a.abs().max()))
        require(bool(torch.isfinite(f_k).all()), "kernel force not finite")
        require(chain_err <= chain_tol, f"force chain: {chain_err}")
    say("compare", max_abs_err=errs, tolerance=tols,
        k1_by_shape=k1_by_shape, coupling_max_abs_err_by_shape=by_shape,
        coupling_shapes=COUPLING_SHAPES,
        ft_force_kernel_vs_autograd={"max_abs_err": chain_err,
                                     "tolerance": chain_tol})
    e_h, t_h, info, (xh, vh, uh, seed, x3, v3) = \
        compare_trajectory_kernels(dev)
    errs.update(e_h)
    tols.update(t_h)
    k3_by_shape = compare_k3(dev)
    errs["K3"] = max(r["max_abs_err"] for r in k3_by_shape.values())
    tols["K3"] = 0.0      # bit-equal to its twin
    say("compare_hmc", max_abs_err=e_h, tolerance=t_h, details=info,
        k3_by_shape=k3_by_shape, large_lattices=compare_large_lattices(dev))

    # 4. the main path: trained-flow FT-HMC from z0 = f^-1(0)
    t0 = time.perf_counter()
    z0, _ = flow_reverse(params, torch.zeros((B, 2, L, L), device=dev), spec)
    torch.cuda.synchronize()
    t_rev = time.perf_counter() - t0
    lf = LeapfrogConfig(tau=TAU, nstep=NSTEP)
    gen = torch.Generator(device=dev).manual_seed(7)
    ntraj = N_THERM + N_MEAS
    _build.reset_counts()
    t0 = time.perf_counter()
    z, hist = run_fthmc(params, spec, lf, beta=BETA, ntraj=ntraj, z0=z0,
                        generator=gen, integrator="omelyan", device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    meas = slice(N_THERM, None)
    acc = float(hist.acc[meas].mean())
    plaq_traj = hist.plaq[meas].mean(dim=1)
    plaq = float(plaq_traj.mean())
    plaq_err = float(plaq_traj.std() / math.sqrt(N_MEAS))
    exp_mdh = float(hist.exp_mdh[meas].mean())
    exact = lattice.PLAQ_EXACT[BETA]
    finite = all(bool(torch.isfinite(t).all()) for t in hist)
    say("fthmc", L=L, chains=B, beta=BETA, tau=TAU, nstep=NSTEP,
        integrator="omelyan", therm=N_THERM, measured=N_MEAS,
        acceptance=acc, plaq=plaq, plaq_stderr_naive=plaq_err,
        plaq_exact=exact, exp_mdh=exp_mdh,
        plaq_first_traj=float(hist.plaq[0].mean()),
        flow_reverse_s=t_rev, run_s=t_run,
        chain_steps_per_s=B * ntraj * NSTEP / t_run)
    require(finite and z.shape == (B, 2, L, L), "non-finite FT-HMC output")
    require(acc >= MIN_ACCEPTANCE, f"acceptance {acc} < {MIN_ACCEPTANCE}")
    require(abs(plaq - exact) <= 0.003, f"plaq {plaq} vs exact {exact}")
    require(abs(exp_mdh - 1.0) <= 0.1, f"<exp(-dH)> {exp_mdh}")

    # 5. launch counters of the main path
    n_force = 2 * NSTEP + 1                    # Omelyan force evaluations
    n_layers = spec.n_layers
    expect = dict.fromkeys(_build.KERNELS, 0)
    expect.update({"K1": n_force * ntraj,
                   "K6": 2 * n_layers * ntraj + n_layers,
                   "K7": n_force * n_layers * ntraj,
                   "K8": n_force * n_layers * ntraj})
    say("launches", launches=launches, expected=expect, plain_calls=plain)
    require(launches == expect, f"launches {launches} != {expect}")
    require(not any(plain.values()), f"plain twins ran: {plain}")

    # 6. the plain-HMC paths, each with its own launch counts
    runs = plain_hmc_runs(dev)
    for k, r in runs.items():
        launches[k] = r["launches"][k]
    launches["K12"] = sum(r["launches"]["K12"] for r in runs.values())

    # 7. timings
    layer, (mu, off) = params[TIMED_LAYER], layer_mask_params(TIMED_LAYER)
    _, _, res = coupling_fwd_res(layer, x, mu, off, spec)
    k1 = k1_timings(dev)
    with full_fp32():
        ms = {"K1": k1["FT"]["graph_ms"],
              **coupling_card_ms(layer, spec, x, gy, gl, mu, off)}
        wrapper_ms = coupling_wrapper_ms(layer, spec, x, gy, gl, mu, off)
        plain_ms = {
            "K1": k1["FT"]["plain_ms"],
            "K6": cuda_ms(lambda: coupling_forward_plain(layer, x, mu, off,
                                                         spec)),
            "K7": cuda_ms(lambda: coupling_fwd_res_plain(layer, x, mu, off,
                                                         spec)),
            "K8": cuda_ms(lambda: coupling_bwd_plain(layer, x, res, gy, gl,
                                                     mu, off, spec))}
        force_kernel_ms = cuda_ms(
            lambda: ft_force_kernel(params, spec, x, BETA), reps=3)
        # the host's share: a force's enqueue time, no synchronize inside
        force_host_ms = host_us_per_call(
            lambda: ft_force_kernel(params, spec, x, BETA), n=10) / 1e3
        force_autograd_ms = cuda_ms(
            lambda: ft_force(params, spec, x, BETA, device=dev), reps=3)
    t0 = time.perf_counter()
    n_timed = 4
    run_fthmc(params, spec, lf, beta=BETA, ntraj=n_timed, z0=z,
              generator=gen, integrator="omelyan", device=dev)
    torch.cuda.synchronize()
    t_traj = (time.perf_counter() - t0) / n_timed
    ft_busy = profile_busy(
        lambda: run_fthmc(params, spec, lf, beta=BETA, ntraj=2, z0=z,
                          generator=gen, integrator="omelyan", device=dev),
        2, t_traj)
    coupling_ms = {}
    for name, (cb, cl, _) in COUPLING_SHAPES.items():
        cx, cgy, cgl = cin[name]
        _, _, cres = coupling_fwd_res(layer, cx, mu, off, spec)
        with full_fp32():
            coupling_ms[name] = {
                "chains": cb, "L": cl,
                **coupling_card_ms(layer, spec, cx, cgy, cgl, mu, off),
                "wrapper_ms": coupling_wrapper_ms(layer, spec, cx, cgy, cgl,
                                                  mu, off),
                "conv_chain_cudnn_ms": conv_chain_cudnn_ms(layer, cb, cl,
                                                           dev),
                "host_us_per_call": {
                    "K6": host_us_per_call(lambda: coupling_forward(
                        layer, cx, mu, off, spec)),
                    "K7": host_us_per_call(lambda: coupling_fwd_res(
                        layer, cx, mu, off, spec)),
                    "K8": host_us_per_call(lambda: coupling_bwd(
                        layer, cx, cres, cgy, cgl, mu, off, spec))}}
    with full_fp32():
        plans = band_plan_sweep(layer, spec, cin, mu, off,
                                sm_count(torch.cuda.current_device()))
    say("band_plans", layer=TIMED_LAYER, kernel_ms_by_plan=plans)
    say("timing", kernel_ms=ms, kernel_wrapper_ms=wrapper_ms,
        plain_ms=plain_ms, k1_by_shape=k1,
        ft_force_kernel_ms=force_kernel_ms,
        ft_force_kernel_host_ms=force_host_ms,
        ft_force_host_us_per_launch=force_host_ms * 1e3 / (
            2 * spec.n_layers + 1),
        ft_force_autograd_ms=force_autograd_ms,
        s_per_trajectory=t_traj,
        fthmc_chain_steps_per_s=B * NSTEP / t_traj,
        coupling_by_shape=coupling_ms, fthmc_device_busy=ft_busy)
    hc = HMC_CFG
    hargs = (hc.beta, hc.dt, hc.nstep)
    ms.update({"K2": cuda_ms(lambda: lk.leapfrog(xh, vh, *hargs)),
               "K3": cuda_ms(lambda: lk.leapfrog_cl(x3, v3, *hargs)),
               "K4": cuda_ms(lambda: lk.hmc_traj(xh, seed, *hargs)),
               "K5": cuda_ms(lambda: lk.hmc_traj_hostrng(xh, vh, uh,
                                                         *hargs))})
    x1h, v1h = lk.leapfrog(xh, vh, *hargs)
    qh = torch.zeros(hc.n_chains, device=dev)
    ms["K12"] = cuda_ms(lambda: lk.hmc_epilogue(xh, x1h, v1h, vh, uh, qh,
                                                hc.beta))
    plain_ms.update({
        "K12": cuda_ms(lambda: lk.hmc_epilogue_plain(xh, x1h, v1h, vh, uh,
                                                     qh, hc.beta), reps=3),
        "K2": cuda_ms(lambda: lk.leapfrog_plain(xh, vh, *hargs), reps=3),
        "K3": cuda_ms(lambda: lk.leapfrog_cl_plain(x3, v3, *hargs), reps=3),
        "K4": cuda_ms(lambda: lk.hmc_traj_plain(xh, seed, *hargs), reps=3),
        "K5": cuda_ms(lambda: lk.hmc_traj_hostrng_plain(xh, vh, uh, *hargs),
                      reps=3)})
    n_sm = sm_count(torch.cuda.current_device())
    say("k3_plans", nstep=hc.nstep, kernel_ms_by_plan=k3_plan_sweep(dev,
                                                                    n_sm))
    k2_vs_k3 = auto_rule_sweep(dev)
    say("traj_plans", nstep=hc.nstep, kernel_ms_by_plan=traj_plan_sweep(
        dev, n_sm))
    rates = {b: headline_rate(dev, b) for b in ("auto", "fused")}
    say("k12_plans", kernel_ms_by_plan=k12_plan_sweep(dev, n_sm),
        wide_kernel_ms=k12_wide_times(dev))
    say("timing_hmc", kernel_ms={k: ms[k] for k in ("K2", "K3", "K4", "K5",
                                                    "K12")},
        plain_ms={k: plain_ms[k] for k in ("K2", "K3", "K4", "K5", "K12")},
        k2_vs_k3_ms_by_L=k2_vs_k3, chains=hc.n_chains,
        headline=rates,
        device_busy={b: device_busy(dev, b, rates[b]["s_per_traj"])
                     for b in rates})

    # 8. dynamical fermions: K9-K11 against their twins, paths A, B, C
    inp = fermion_inputs(dev)
    e_f, t_f, info_f = compare_fermion(dev, inp)
    errs.update(e_f)
    tols.update(t_f)
    say("compare_fermion", max_abs_err=e_f, tolerance=t_f, details=info_f)
    errs["K11"], tols["K11"], k11_cases = compare_k11(dev)
    say("compare_k11", max_abs_err=errs["K11"], tolerance=tols["K11"],
        shapes=K11_SHAPES, cases=k11_cases)
    say("fermion_band_plans", eo=True, kernel_ms_by_plan=fermion_plan_sweep(
        inp, sm_count(torch.cuda.current_device())))
    dyn, final = {}, {}
    for k, seed, nb, nl in (("A", 51, 64, 64), ("B", 52, 128, 16)):
        dyn[k], final[k] = dyn_path(k, dev, near_equilibrium(
            torch.Generator(device=dev).manual_seed(seed), nb, nl, 6.0, dev))
    zc, _ = flow_reverse(params, torch.zeros((128, 2, 16, 16), device=dev),
                         spec)
    dyn["C"], _ = dyn_path("C", dev, zc, params, spec)
    # the sampling paths launch no K9 or K10 (their CG is K11 alone): the
    # operator's own entry point is the path that does
    ops = operator_path(inp)
    launches.update({"K9": ops["launches"]["K9"],
                     "K10": ops["launches"]["K10"],
                     "K11": dyn["A"]["launches"]["K11"]})
    ft = fermion_timings(dev, inp)
    ms.update(ft["kernel_ms"])
    plain_ms.update(ft["plain_ms"])
    for t in ft["k9_vs_k10_ms_by_L"].values():
        t["rule_agrees"] = (t["K9"] <= t["K10"]) == (t["auto"] == "cf")
    kt = k11_timings(dev, inp)
    ms["K11"] = kt["by_path"]["A"]["solve_ms"]
    plain_ms["K11"] = kt["by_path"]["A"]["plain_ms"]
    say("cg_plans", eo=True, iterations=K11_TIMED_ITERS,
        solve_ms_by_plan=kt["cg_plans"])
    busy = {k: path_busy(k, dev, x0, dyn[k]["s_per_traj"], *fl)
            for k, x0, fl in (("A", inp["A"]["x"], ()),
                              ("B", inp["B"]["x"], ()),
                              ("C", zc, (params, spec)))}
    say("timing_fermion", **ft, k11_by_path=kt["by_path"],
        s_per_traj={k: r["s_per_traj"] for k, r in dyn.items()},
        chain_steps_per_s={k: r["chain_steps_per_s"] for k, r in dyn.items()},
        cg_iters_mean={k: r["cg_iters_mean"] for k, r in dyn.items()},
        cg_solves_per_traj={k: r["cg_solves"] / (r["therm"] + r["measured"])
                            for k, r in dyn.items()},
        device_busy=busy)

    # 9. flow training and flow sampling
    flow = flow_training_phase(dev)
    for r in flow["k6"].values():
        errs["K6"] = max(errs["K6"], r["max_abs_err"])
        tols["K6"] = min(tols["K6"], r["tolerance"])
    launches["K6"] += flow["sampling"]["launches"]

    # 10. the rest of the dynamical sector: K11_bf16, the mixed CG, paths
    # D-G, the observables, fermion-aware training
    rest = dynamical_rest_phase(dev, params, spec, final["B"])
    errs["K11_bf16"], tols["K11_bf16"] = rest["err"], rest["tol"]
    ms["K11_bf16"] = rest["timing"]["bf16"]["solve_ms"]
    plain_ms["K11_bf16"] = rest["timing"]["bf16"]["plain_ms"]
    launches["K11_bf16"] = rest["launches"]["G"]["K11_bf16"]
    launches["K9"] += rest["launches"]["G"]["K9"]

    # 11. the bf16 flagship recipe, the mobility probes, the runner, the
    # diagnostics and a spline flow
    for k, v in phase11(dev, params, spec).items():
        launches[k] += v

    # 12. the parallel drivers at world size 1 on NCCL
    for k, v in parallel_phase(dev, params, spec, z0).items():
        launches[k] += v

    # 13. the command line and the API facade on the card
    ref = {"s_per_traj": t_traj, "hmc_acceptance": runs["K2"]["acceptance"],
           "c_acceptance": dyn["C"]["acceptance"]}
    for k, v in cli_phase(dev, params, spec, z0, ref).items():
        launches[k] += v

    # 14. the entry points: the bench entry, entry(), the dry run, the
    # demos
    for k, v in entry_phase(dev, spec).items():
        launches[k] += v

    # 15. the kernels line
    bnd = bounds(spec, sum(t.numel() for c in layer for t in c.values()),
                 mu, off)
    tb_h = traj_bounds(hc.n_chains, hc.L, hc.nstep)
    tb_3 = traj_bounds(hc.n_chains, CL_L, hc.nstep)
    bnd.update({"K2": tb_h["K2"], "K3": tb_3["K3"], "K4": tb_h["K4"],
                "K5": tb_h["K5"], "K12": tb_h["K12"]})
    fb_a, fb_b = (fermion_bounds(64, 64, K11_TIMED_ITERS),
                  fermion_bounds(128, 16))
    bnd.update({"K9": fb_a["K9"], "K10": fb_b["K10"], "K11": fb_a["K11"],
                "K11_bf16": fb_a["K11_bf16"]})
    say("bounds", layer=TIMED_LAYER, mu=mu, off=off,
        flops={k: v["flops"] for k, v in bnd.items()},
        bytes={k: v["bytes"] for k, v in bnd.items()})
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k][0],
                "replaces": SOURCES[k][1], "launches": launches[k],
                "max_abs_err": errs[k], "tolerance": tols[k], "ms": ms[k],
                "plain_ms": plain_ms[k], "bound_ms": bnd[k]["bound_ms"],
                "bound_by": bnd[k]["bound_by"], "library_ms": None}
               for k in _build.KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)

    # 16. the device line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
