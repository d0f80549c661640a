"""Single-file walkthrough of the dynamical-fermion (two-flavor Schwinger
model) sampler: gamma_5-hermiticity, plain pseudofermion HMC, the pion
correlator, FT-HMC with a transferred pure-gauge flow, and an optional
row-sharded leg.

Counterpart of the JAX package's ``examples/demo_schwinger.py``. Physics
checks printed as it goes: <exp(-dH)> ~ 1 (exactness), plain-vs-FT
<plaq> agreement (no analytic value exists with fermions), the gamma_5
identity <chi, D psi> = <D^dag chi, psi> and the pion correlator's cosh
shape.

    python -m fthmc_tpu_torch.examples.demo_schwinger [--quick]

The CG backend defaults to 'auto': on the card one K11 launch a solve
(the JAX demo's default 'xla' would run the torch CG there). The FT leg's
flow is an exported ``.npz`` (by default the flagship,
``fthmc_tpu_torch/data/flow8x8_b3_rncp24_ftb6.npz``); a path that does not
exist raises, and ``--ckpt ''`` leaves the leg out. ``--shard-rows N``
runs the plain chain again with the lattice rows sharded over N ranks
(``parallel.domain_fermion``): N gloo ranks with ``--device cpu``, the
process group already initialized on the card (``torchrun``), skipped
with a note when it has fewer ranks. ``--ntraj`` and ``--chains`` cut the
run (default: the demo's, by ``--quick``).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from fthmc_tpu_torch import fermion
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.diagnostics import _host as host
from fthmc_tpu_torch.hmc import TrajMetrics
from fthmc_tpu_torch.schwinger import (SchwingerConfig,
                                       run_fthmc_dyn_chunked,
                                       run_hmc_dyn_chunked)
from fthmc_tpu_torch.weights import FLAGSHIP_NPZ, load_flow_npz

CG_BACKENDS = ("auto", "xla", "fused", "mixed")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fthmc_tpu_torch.examples.demo_schwinger",
        description="two-flavor Schwinger model: plain and FT-HMC")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--beta", type=float, default=3.0)
    ap.add_argument("--mass", type=float, default=0.2)
    ap.add_argument("--cg-backend", choices=CG_BACKENDS, default="auto")
    ap.add_argument("--ckpt", default=str(FLAGSHIP_NPZ),
                    help="exported flow (.npz) for the FT-HMC leg ('' "
                         "leaves the leg out)")
    ap.add_argument("--shard-rows", type=int, default=1,
                    help="also run the domain-decomposed plain chain over "
                         "this many ranks (skipped if too few)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--ntraj", type=int, default=None,
                    help="trajectories of each leg (default 64 with "
                         "--quick, else 512)")
    ap.add_argument("--chains", type=int, default=None,
                    help="chains (default 4 with --quick, else 32)")
    return ap


def summarize(tag: str, hist, therm: int) -> dict:
    q = host(hist.q)[therm:]
    s = {"acc": float(host(hist.acc)[therm:].mean()),
         "exp_mdh": float(host(hist.exp_mdh)[therm:].mean()),
         "plaq": float(host(hist.plaq)[therm:].mean()),
         "chi_q": float((q ** 2).mean())}
    print(f"[{tag}] acc={s['acc']:.3f} <exp(-dH)>={s['exp_mdh']:.4f} "
          f"<plaq>={s['plaq']:.5f} chi_Q={s['chi_q']:.3f}")
    return s


def g5_hermiticity(generator: torch.Generator, L: int, mass: float,
                   device) -> float:
    """|<chi, D psi> - <D^dag chi, psi>|^2 on a random field, complex64."""
    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    theta = (torch.rand((2, L, L), generator=generator,
                        device=generator.device).to(device) * 2 - 1) * math.pi
    psi = torch.complex(normal((L, L, 2)), normal((L, L, 2)))
    chi = torch.complex(normal((L, L, 2)), normal((L, L, 2)))
    a = torch.sum(torch.conj(chi) * fermion.dirac(theta, psi, mass))
    b = torch.sum(torch.conj(fermion.dirac_dag(theta, chi, mass)) * psi)
    d = a - b
    return float(d.real ** 2 + d.imag ** 2)


def _rows_rank(rank: int, cfg: SchwingerConfig, block: int) -> dict:
    """One gloo rank of the row-sharded leg: rank 0's history."""
    from fthmc_tpu_torch.parallel.domain import make_rows_mesh
    from fthmc_tpu_torch.parallel.domain_fermion import (
        run_domain_hmc_dyn_chunked)
    _, hist = run_domain_hmc_dyn_chunked(
        make_rows_mesh(device="cpu"), cfg, block=block,
        generator=torch.Generator().manual_seed(3))
    return hist


def _rows_leg(n: int, cfg: SchwingerConfig, block: int, device):
    """The row-sharded plain chain's history dict on n ranks, or None
    (with the JAX demo's note) when it cannot run."""
    L = cfg.L
    if device.type == "cpu":
        ranks = n
    else:
        ranks = dist.get_world_size() if dist.is_initialized() else 1
    if ranks < n:
        print(f"(--shard-rows {n}: only {ranks} ranks; leg skipped)")
        return None
    if L % n or (L // n) % 2:
        print(f"(--shard-rows {n}: needs an even number of rows per shard "
              f"at L={L}; leg skipped)")
        return None
    if device.type == "cpu":
        from fthmc_tpu_torch.parallel.launch import spawn
        return spawn(_rows_rank, n, cfg, block)[0]
    from fthmc_tpu_torch.parallel.domain import make_rows_mesh
    from fthmc_tpu_torch.parallel.domain_fermion import (
        run_domain_hmc_dyn_chunked)
    mesh = make_rows_mesh(n)
    _, hist = run_domain_hmc_dyn_chunked(
        mesh, cfg, block=block,
        generator=torch.Generator(mesh.device).manual_seed(3))
    return hist


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    L = args.L
    ntraj = args.ntraj or (64 if args.quick else 512)
    chains = args.chains or (4 if args.quick else 32)
    therm = ntraj // 4
    block = min(ntraj, 128)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}  backend: {args.cg_backend}")
    out = {"L": L, "beta": args.beta, "mass": args.mass, "ntraj": ntraj,
           "chains": chains, "therm": therm, "cg_backend": args.cg_backend}

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device).manual_seed(seed)

    prev = fermion._CG_BACKEND
    fermion.set_cg_backend(args.cg_backend)
    try:
        # gamma_5-hermiticity: <chi, D psi> == <D^dag chi, psi> exactly
        out["g5_hermiticity"] = g5_hermiticity(gen(0), L, args.mass, device)
        print(f"gamma5-hermiticity |<chi,D psi> - <D^dag chi,psi>|^2 = "
              f"{out['g5_hermiticity']:.2e}")

        cfg = SchwingerConfig(L=L, beta=args.beta, mass=args.mass, tau=1.0,
                              nstep=8 if args.quick else 16,
                              n_chains=chains, ntraj=ntraj)
        t0 = time.time()
        x, hist = run_hmc_dyn_chunked(cfg, block=block, generator=gen(1),
                                      device=device)
        out["plain"] = summarize("plain HMC", hist, therm)
        out["plain"]["ms_per_traj"] = (time.time() - t0) / ntraj * 1e3
        print(f"  ({out['plain']['ms_per_traj']:.1f} ms/traj, "
              f"{chains} chains)")

        # pion correlator on the last configs: cosh-symmetric in t
        c = host(fermion.pion_correlator(x[:4], args.mass))
        out["pion_asymmetry"] = float(
            np.abs(c[:, 1:L // 2] - c[:, :-L // 2:-1]).mean() / c.mean())
        print(f"pion C(t) cosh-asymmetry (0 = exact): "
              f"{out['pion_asymmetry']:.3f}")

        out["ft"] = None
        if args.ckpt:
            from fthmc_tpu_torch.models.flow import flow_reverse
            params, spec = load_flow_npz(args.ckpt, device=device)
            print(f"FT-HMC with {spec.coupling} x{spec.n_layers} flow "
                  f"(trained pure-gauge at 8^2, transferred unchanged)")
            cfg_ft = SchwingerConfig(L=L, beta=args.beta, mass=args.mass,
                                     tau=0.5, nstep=4 if args.quick else 8,
                                     n_chains=chains, ntraj=ntraj)
            with torch.no_grad():
                z0, _ = flow_reverse(params, x, spec)
            z, hist_ft = run_fthmc_dyn_chunked(
                params, spec, cfg_ft, block=block, z0=z0, generator=gen(2),
                device=device)
            out["ft"] = summarize("FT-HMC", hist_ft, therm)
            p_plain, p_ft = out["plain"]["plaq"], out["ft"]["plaq"]
            print(f"cross-sampler <plaq> agreement: "
                  f"|{p_plain:.5f} - {p_ft:.5f}| = {abs(p_plain - p_ft):.1e}")
        else:
            print("(no flow given; FT-HMC leg skipped)")

        out["rows"] = None
        if args.shard_rows > 1:
            # domain decomposition: the same physics with the lattice rows
            # sharded through the Dirac operator and the CG (halo exchanges
            # and all-reduced dots; parallel/domain_fermion.py)
            hd = _rows_leg(args.shard_rows, cfg, block, device)
            if hd is not None:
                out["rows"] = summarize(
                    f"plain HMC rows/{args.shard_rows}",
                    TrajMetrics(**{k: hd[k] for k in TrajMetrics._fields}),
                    therm)
                p_plain, p_dom = out["plain"]["plaq"], out["rows"]["plaq"]
                print(f"sharded-vs-single <plaq> agreement: "
                      f"|{p_plain:.5f} - {p_dom:.5f}| = "
                      f"{abs(p_plain - p_dom):.1e}")
    finally:
        fermion.set_cg_backend(prev)
    print("demo OK")
    return out


if __name__ == "__main__":
    main()
