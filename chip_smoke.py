#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fthmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. build the CUDA kernels (K1, K6, K7, K8) from fthmc_tpu_torch/csrc with
     nvcc for sm_90a, one nvcc per source, all at once;
  2. the card's name and power limit, as nvidia-smi gives them;
  3. each kernel against its plain PyTorch twin on the card, at the flagship
     shapes (16^2, 64 chains, 24-layer rncp, hidden (32, 32), 8 components,
     s_clip 3), on every layer of the flow (all eight (mu, off) masks), TF32
     off; then the whole kernel force chain against the autograd force;
  4. the main path: flagship FT-HMC with the trained flow at 16^2, beta=6,
     tau=0.5, 8 Omelyan steps, 64 chains, from z0 = f^-1(0), through
     run_fthmc with the default (kernel) force backend; physics checks;
  5. the launch counters of that run against the path's own count;
  6. timings with CUDA events: every kernel and its plain twin, the kernel
     force chain against the autograd force, FT-HMC chain-steps/s;
  7. a {"kernels": [...]} JSON line;
  8. last, {"ok": true, "device": {...}}.
Any failed phase raises, so the script exits non-zero without the last line.
It needs a CUDA device and the fthmc_tpu_torch package beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import LeapfrogConfig
from fthmc_tpu_torch.hmc import ft_force, run_fthmc
from fthmc_tpu_torch.models.flow import flow_reverse
from fthmc_tpu_torch.models.masks import layer_mask_params, plaq_masks
from fthmc_tpu_torch.ops import _build
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_kernels import (coupling_forward,
                                                  coupling_forward_plain)
from fthmc_tpu_torch.ops.coupling_vjp_kernels import (coupling_bwd,
                                                      coupling_bwd_plain,
                                                      coupling_fwd_res,
                                                      coupling_fwd_res_plain,
                                                      ft_force_kernel)
from fthmc_tpu_torch.ops.lattice_kernels import force, force_plain
from fthmc_tpu_torch.weights import load_flow_npz

B, L, BETA, TAU, NSTEP = 64, 16, 6.0, 0.5, 8
N_THERM, N_MEAS = 32, 96
TIMED_LAYER = 1               # the coupling layer the kernels are timed on
# The JAX package's own run of this configuration (trained flow, 16^2,
# beta=6, tau=0.5, 8 Omelyan steps, 64 chains, cold start, 4608 measured
# trajectories; artifacts/round3/tauint_b6_ft_t05n8.json) accepted 0.827
# with <exp(-dH)> = 0.955. A mean over 96 x 64 accept flips has a standard
# error near 0.005 if independent; 0.78 leaves room for correlation. It is
# the loosest check here: a wrong force shows first in phase 3's kernel and
# force comparisons.
MIN_ACCEPTANCE = 0.78
PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SOURCES = {
    "K1": ("fthmc_tpu_torch/csrc/force.cu",
           "fthmc_tpu/ops/pallas_lattice.py:53"),
    "K6": ("fthmc_tpu_torch/csrc/coupling_fwd.cu",
           "fthmc_tpu/ops/pallas_coupling.py:131"),
    "K7": ("fthmc_tpu_torch/csrc/coupling_fwd.cu",
           "fthmc_tpu/ops/pallas_coupling_vjp.py:182"),
    "K8": ("fthmc_tpu_torch/csrc/coupling_bwd.cu",
           "fthmc_tpu/ops/pallas_coupling_vjp.py:255"),
}


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


def _dilate(m: np.ndarray) -> np.ndarray:
    """Sites within one step (3x3, periodic) of a site of ``m``."""
    return np.logical_or.reduce([np.roll(m, (dy, dx), axis=(0, 1))
                                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def _taps(need: np.ndarray, nonzero: np.ndarray) -> int:
    """(site, tap) pairs of a periodic 3x3 conv whose output site is in
    ``need`` and whose input site is in ``nonzero``."""
    return sum(int((need & np.roll(nonzero, (dy, dx), axis=(0, 1))).sum())
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def coupling_macs(widths, mu: int, off: int) -> dict:
    """Conv multiply-adds per chain that one coupling layer's outputs depend
    on, from its stripe masks. Forward (K6, K7): the raw conditioner output
    is read on the active stripe only, each earlier conv's output where the
    next conv reads it (one site further out) and, for K7, also where K8
    reads it as an activation gate; every input may be nonzero (the cos
    channel is 1 off the frozen stripe). K8: cotangents enter the
    transposed chain on the active stripe and spread one site a conv; the
    chain's result is read on the frozen stripe (the conditioner's input),
    each earlier transposed conv's where the next one reads it."""
    frozen, active, _ = (m.astype(bool) for m in plaq_masks((L, L), mu, off))
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
    out = {}
    for k, (nbytes, flops) in work.items():
        tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
        out[k] = {"bound_ms": max(tb, tf),
                  "bound_by": "bytes" if tb >= tf else "operations",
                  "bytes": nbytes, "flops": flops}
    return out


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
    x = (torch.rand((B, 2, L, L), generator=g, device=dev) * 2 - 1) * math.pi
    gy = torch.randn((B, 2, L, L), generator=g, device=dev)
    gl = torch.randn((B,), generator=g, device=dev)
    errs, tols = {}, {}
    with full_fp32():
        f_ref = force_plain(x, BETA)
        errs["K1"] = float((force(x, BETA) - f_ref).abs().max())
        tols["K1"] = 1e-4 * max(1.0, float(f_ref.abs().max()))
        e6, e7, e8 = [], [], []
        for li, layer in enumerate(params):   # every (mu, off) of the path
            mu, off = layer_mask_params(li)
            fx, lj = coupling_forward(layer, x, mu, off, spec)
            fx_p, lj_p = coupling_forward_plain(layer, x, mu, off, spec)
            lscale = max(1.0, float(lj_p.abs().max()))
            e6 += [(wrapped_err(fx, fx_p), 1e-4),
                   (float((lj - lj_p).abs().max()), 1e-4 * lscale)]
            fx7, lj7, res = coupling_fwd_res(layer, x, mu, off, spec)
            fx7_p, lj7_p, res_p = coupling_fwd_res_plain(layer, x, mu, off,
                                                         spec)
            e7 += [(wrapped_err(fx7, fx7_p), 1e-4),
                   (float((lj7 - lj7_p).abs().max()), 1e-4 * lscale)]
            e7 += [(float((r - r_p).abs().max()),
                    1e-4 * max(1.0, float(r_p.abs().max())))
                   for r, r_p in zip(res, res_p)]
            gx = coupling_bwd(layer, x, res, gy, gl, mu, off, spec)
            gx_p = coupling_bwd_plain(layer, x, res_p, gy, gl, mu, off, spec)
            e8.append((float((gx - gx_p).abs().max()),
                       2e-3 * max(1.0, float(gx_p.abs().max()))))
        for k, pairs in (("K6", e6), ("K7", e7), ("K8", e8)):
            errs[k] = max(e for e, _ in pairs)
            require(all(e <= t for e, t in pairs), f"{k} vs plain: {pairs}")
            tols[k] = min(t for _, t in pairs)
        require(errs["K1"] <= tols["K1"], f"K1 vs plain: {errs['K1']}")
        f_k = ft_force_kernel(params, spec, x, BETA)
        f_a = ft_force(params, spec, x, BETA, device=dev)
        torch.cuda.synchronize()
        chain_err = float((f_k - f_a).abs().max())
        chain_tol = 2e-3 * max(1.0, float(f_a.abs().max()))
        require(bool(torch.isfinite(f_k).all()), "kernel force not finite")
        require(chain_err <= chain_tol, f"force chain: {chain_err}")
    say("compare", max_abs_err=errs, tolerance=tols,
        ft_force_kernel_vs_autograd={"max_abs_err": chain_err,
                                     "tolerance": chain_tol})

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
    expect = {"K1": n_force * ntraj,
              "K6": 2 * n_layers * ntraj + n_layers,
              "K7": n_force * n_layers * ntraj,
              "K8": n_force * n_layers * ntraj}
    say("launches", launches=launches, expected=expect, plain_calls=plain)
    require(launches == expect, f"launches {launches} != {expect}")
    require(not any(plain.values()), f"plain twins ran: {plain}")

    # 6. timings
    layer, (mu, off) = params[TIMED_LAYER], layer_mask_params(TIMED_LAYER)
    _, _, res = coupling_fwd_res(layer, x, mu, off, spec)
    with full_fp32():
        ms = {"K1": cuda_ms(lambda: force(x, BETA)),
              "K6": cuda_ms(lambda: coupling_forward(layer, x, mu, off,
                                                     spec)),
              "K7": cuda_ms(lambda: coupling_fwd_res(layer, x, mu, off,
                                                     spec)),
              "K8": cuda_ms(lambda: coupling_bwd(layer, x, res, gy, gl, mu,
                                                 off, spec))}
        plain_ms = {
            "K1": cuda_ms(lambda: force_plain(x, BETA)),
            "K6": cuda_ms(lambda: coupling_forward_plain(layer, x, mu, off,
                                                         spec)),
            "K7": cuda_ms(lambda: coupling_fwd_res_plain(layer, x, mu, off,
                                                         spec)),
            "K8": cuda_ms(lambda: coupling_bwd_plain(layer, x, res, gy, gl,
                                                     mu, off, spec))}
        force_kernel_ms = cuda_ms(
            lambda: ft_force_kernel(params, spec, x, BETA), reps=3)
        force_autograd_ms = cuda_ms(
            lambda: ft_force(params, spec, x, BETA, device=dev), reps=3)
    t0 = time.perf_counter()
    n_timed = 4
    run_fthmc(params, spec, lf, beta=BETA, ntraj=n_timed, z0=z,
              generator=gen, integrator="omelyan", device=dev)
    torch.cuda.synchronize()
    t_traj = (time.perf_counter() - t0) / n_timed
    say("timing", kernel_ms=ms, plain_ms=plain_ms,
        ft_force_kernel_ms=force_kernel_ms,
        ft_force_autograd_ms=force_autograd_ms,
        s_per_trajectory=t_traj,
        fthmc_chain_steps_per_s=B * NSTEP / t_traj)

    # 7. the kernels line
    bnd = bounds(spec, sum(t.numel() for c in layer for t in c.values()),
                 mu, off)
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

    # 8. the device line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
