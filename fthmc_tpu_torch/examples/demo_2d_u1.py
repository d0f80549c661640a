"""Single-file walkthrough: HMC -> flow training -> flow sampling -> FT-HMC
-> volume transfer, on the card.

Counterpart of the JAX package's ``examples/demo_2d_u1.py``, through the
port's facade (``api.run_hmc``, ``train``, ``api.generate_ensemble``,
``api.FieldTransformation``) with generators seeded 1-7 where the JAX demo
takes PRNGKey(1..7). It prints the physics checks as it goes and returns
them:

    python -m fthmc_tpu_torch.examples.demo_2d_u1 [--quick] [--device cpu]

``--quick`` is the JAX demo's tiny run (a 4-layer flow, fewer chains and
trajectories); ``--hmc-ntraj``, ``--n-era``, ``--n-epoch``,
``--ensemble-size``, ``--ft-ntraj`` and ``--transfer-ntraj`` cut the run
lengths further, the widths left as they are.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fthmc_tpu_torch import api
from fthmc_tpu_torch.config import HMCConfig, LeapfrogConfig, TrainConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.diagnostics import _host as host
from fthmc_tpu_torch.observables import tau_int

# the run lengths the port's flags cut: (--quick, full), as the JAX demo
LENGTHS = {"hmc_ntraj": (256, 2048), "n_era": (2, 10), "n_epoch": (20, 100),
           "ensemble_size": (512, 8192), "ft_ntraj": (64, 1024),
           "transfer_ntraj": (32, 256)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fthmc_tpu_torch.examples.demo_2d_u1",
        description="HMC -> flow training -> flow sampling -> FT-HMC -> "
                    "volume transfer")
    ap.add_argument("--quick", action="store_true",
                    help="tiny run for smoke-testing")
    ap.add_argument("--beta", type=float, default=2.0)
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    g = ap.add_argument_group("run lengths (default: the demo's, by --quick)")
    for name in LENGTHS:
        g.add_argument("--" + name.replace("_", "-"), type=int, default=None)
    return ap


def chain_mean(series) -> tuple[float, float]:
    """Mean of a (ntraj, chains) series and its standard error over the
    chains' means (independent chains)."""
    per_chain = np.asarray(series, dtype=np.float64).mean(axis=0)
    return (float(per_chain.mean()),
            float(per_chain.std(ddof=1) / np.sqrt(per_chain.size)))


def _ft_stats(hist, therm: int) -> dict:
    q = host(hist.q)[therm:]
    plaq, plaq_err = chain_mean(host(hist.plaq)[therm:])
    return {"acc": float(host(hist.acc).mean()),
            "exp_mdh": float(host(hist.exp_mdh)[therm:].mean()),
            "plaq": plaq, "plaq_err": plaq_err,
            "tau_int_q": float(np.mean([tau_int(q[:, c])
                                        for c in range(q.shape[1])]))}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    q = args.quick
    n = {k: getattr(args, k) if getattr(args, k) is not None
         else v[0 if q else 1] for k, v in LENGTHS.items()}
    if q:
        print("[--quick: tiny flow/short runs; physics checks hold but "
              "acceptances/ESS will be low. Run without --quick for the "
              "real numbers.]")
    beta, L = args.beta, args.L
    exact = api.PLAQ_EXACT.get(beta)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device).manual_seed(seed)

    out = {"L": L, "beta": beta, "plaq_exact": exact, "lengths": n}

    # ---- 1. plain HMC baseline -------------------------------------------
    print(f"== plain HMC {L}x{L} beta={beta} ==")
    cfg = HMCConfig(beta=beta, L=L, tau=2.0, nstep=10, ntraj=n["hmc_ntraj"],
                    n_chains=16 if q else 64, randinit=True)
    t0 = time.time()
    x, hist = api.run_hmc(cfg, device=device)
    therm = cfg.ntraj // 4
    qch = host(hist.q)[therm:]
    plaq, plaq_err = chain_mean(host(hist.plaq)[therm:])
    hmc = {"plaq": plaq, "plaq_err": plaq_err,
           "exp_mdh": float(host(hist.exp_mdh)[therm:].mean()),
           "acc": float(host(hist.acc).mean()),
           "chi_q": float((qch ** 2).mean()),
           "tau_int_q": float(np.mean([tau_int(qch[:, c])
                                       for c in range(qch.shape[1])])),
           "wall_s": time.time() - t0}
    print(f"  <plaq> = {hmc['plaq']:.5f}  (exact {exact})")
    print(f"  <exp(-dH)> = {hmc['exp_mdh']:.4f}")
    print(f"  acc = {hmc['acc']:.3f}   chi_Q = {hmc['chi_q']:.3f}   "
          f"tau_int(Q) = {hmc['tau_int_q']:.2f}")
    print(f"  wall: {hmc['wall_s']:.1f}s")
    out["hmc"] = hmc

    # ---- 2. train a gauge-equivariant flow -------------------------------
    print("== train flow ==")
    from fthmc_tpu_torch.train import train
    tcfg = TrainConfig(L=L, beta=beta, n_era=n["n_era"],
                       n_epoch=n["n_epoch"], batch_size=64, base_lr=1e-3,
                       flow=api.FlowSpec(n_layers=4 if q else 16))
    t0 = time.time()
    state, history = train(tcfg, device=device)
    ess = float(np.mean(history["ess"][-10:]))
    out["train"] = {"ess": ess, "wall_s": time.time() - t0}
    print(f"  final ESS = {ess:.3f}   wall: {out['train']['wall_s']:.1f}s")

    # ---- 3. flow-only sampling (independence Metropolis) -----------------
    print("== flow sampling ==")
    ens = api.generate_ensemble(
        state.params, tcfg.flow, beta=beta, L=L,
        ensemble_size=n["ensemble_size"], batch_size=64, generator=gen(7),
        device=device)
    out["sample"] = {k: float(ens[k]) for k in ("accept_rate",
                                                "suscept_mean",
                                                "suscept_err")}
    print(f"  accept = {ens['accept_rate']:.3f}   "
          f"chi_Q = {ens['suscept_mean']:.3f} +/- {ens['suscept_err']:.3f}")

    # ---- 4. flowed HMC ----------------------------------------------------
    print("== FT-HMC ==")
    lf = LeapfrogConfig(tau=1.0, nstep=8 if q else 64)
    ft = api.FieldTransformation(state.params, tcfg.flow, beta=beta, lf=lf,
                                 device=device)
    z0 = ft.initializer(gen(1), 8 if q else 16, L)
    t0 = time.time()
    z, fhist = ft.run(gen(2), z0, num_trajs=n["ft_ntraj"])
    fts = {**_ft_stats(fhist, n["ft_ntraj"] // 4), "wall_s": time.time() - t0}
    print(f"  acc = {fts['acc']:.3f}   <exp(-dH)> = {fts['exp_mdh']:.4f}")
    print(f"  <plaq> = {fts['plaq']:.5f}   "
          f"tau_int(Q) = {fts['tau_int_q']:.2f}")
    print(f"  wall: {fts['wall_s']:.1f}s")
    out["fthmc"] = fts

    # ---- 5. volume transfer: same flow params at 2L ----------------------
    print(f"== volume transfer -> {2*L}x{2*L} (no retraining) ==")
    ft2 = api.FieldTransformation(state.params, tcfg.flow, beta=beta, lf=lf,
                                  device=device)
    z0 = ft2.initializer(gen(3), 4 if q else 16, 2 * L)
    nt = n["transfer_ntraj"]
    z, fhist2 = ft2.run(gen(4), z0, num_trajs=nt)
    out["transfer"] = {"L": 2 * L, "acc": float(host(fhist2.acc).mean()),
                       "plaq": float(host(fhist2.plaq)[-(nt // 2):].mean())}
    print(f"  acc = {out['transfer']['acc']:.3f}   "
          f"<plaq> = {out['transfer']['plaq']:.5f}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
