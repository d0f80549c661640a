"""Flow-only sampling: independence Metropolis over flow proposals.

Counterpart of ``fthmc_tpu/sampling.py``. ``n_chains`` independent chains
advance in lockstep: each block of ``batch`` proposals a chain is one flow
evaluation on (batch * n_chains) prior draws, then a serial accept pass
over the batch axis with every chain's own proposals and uniforms. The
flow evaluations take ``flow_backend``: 'auto' is K6 on the card
(``kernel_flow_forward``, one launch a layer a block; a spec K6 does not
take, such as a spline or bf16 flow, raises) and its plain twin on the CPU;
'torch' is ``models.flow.flow_forward`` (cuDNN's convs on the card), which
takes every spec. logq = prior.log_prob(z) - logdet.

The accept pass (``accept_pass``) is a function of the block's proposals'
(logq, logp, charges, fields) and the uniforms, so the tests feed it the
numbers the JAX package draws; ``run_ensemble`` is the whole ensemble on given latents
and uniforms, ``make_mcmc_ensemble`` draws them from a ``torch.Generator``.
The pass is a Python loop of a few small ops a step over all chains (the
JAX package scans it inside one program; on the card ``run_ensemble``
replays it as a CUDA graph): it tracks, for each chain, which proposal it
holds and its log weight logp - logq, and the history is gathered from the
block's arrays afterwards, so every recorded value is a selection of a
computed one, as in the JAX scan.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.models.flow import flow_forward
from fthmc_tpu_torch.models.priors import uniform_link_prior
from fthmc_tpu_torch.observables import (acceptance_rate, chain_stats,
                                         topo_susceptibility)
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.ops.coupling_kernels import (kernel_fits,
                                                  kernel_flow_forward)

__all__ = ["ChainHistory", "accept_pass", "mcmc_chain_scan", "propose",
           "run_ensemble", "make_mcmc_ensemble", "generate_ensemble"]


class ChainHistory(NamedTuple):
    x: torch.Tensor       # (N, 2, L, L) chain states
    q: torch.Tensor       # (N,)
    dqsq: torch.Tensor    # (N,)  (q_t - q_{t-1})^2
    logq: torch.Tensor    # (N,)
    logp: torch.Tensor    # (N,)
    acc: torch.Tensor     # (N,)


def _held(w0: torch.Tensor, w: torch.Tensor,
          uniforms: torch.Tensor) -> torch.Tensor:
    """The serial pass itself: step i accepts where u_i < min(1,
    exp[w_i - w]), w the log weight of the state held (w0 coming in).
    Returns (batch, n_chains): the block index of the proposal each chain
    holds after each step, -1 for the state it came in with."""
    cur, held = w0, torch.full_like(w0, -1, dtype=torch.long)
    src = []
    for i in range(w.shape[0]):
        acc = uniforms[i] < torch.clamp(torch.exp(w[i] - cur), max=1.0)
        cur = torch.where(acc, w[i], cur)
        held = torch.where(acc, i, held)
        src.append(held)
    return torch.stack(src)


class _GraphedHeld:
    """``_held`` on the card, captured in a CUDA graph at the first block's
    shape and replayed for every later block of a run: the pass is a few
    hundred tiny kernels a block whose launches would otherwise set the
    sampler's pace. The same kernels as the loop, so the same result."""

    def __init__(self):
        self.graph = None

    def __call__(self, w0, w, uniforms):
        if self.graph is None:
            self.inputs = [t.clone() for t in (w0, w, uniforms)]
            main, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                _held(*self.inputs)                  # warm-up
                self.graph = torch.cuda.CUDAGraph()
                self.graph.capture_begin()
                self.out = _held(*self.inputs)
                self.graph.capture_end()
            main.wait_stream(side)
        else:
            for buf, t in zip(self.inputs, (w0, w, uniforms)):
                buf.copy_(t)
        self.graph.replay()
        return self.out.clone()


def _select(src: torch.Tensor, block: torch.Tensor, carried: torch.Tensor):
    """block[src[i, c], c] (carried[c] where src is -1): (batch, n, ...)."""
    cols = torch.arange(src.shape[1], device=src.device)
    picked = block[src.clamp(min=0), cols]
    keep = (src < 0).reshape(*src.shape, *([1] * (block.dim() - 2)))
    return torch.where(keep, carried.unsqueeze(0), picked)


def accept_pass(carry, logq: torch.Tensor, logp: torch.Tensor,
                charges: torch.Tensor, uniforms: torch.Tensor,
                proposals: torch.Tensor | None = None, held=_held):
    """The serial independence-Metropolis pass over one block of
    proposals, every chain at once: their logq, logp and charges (batch,
    n_chains), uniforms (batch, n_chains) and, to keep the fields, the
    proposals (batch, n_chains, 2, L, L). Step i accepts where u_i <
    min(1, exp[(logp_i - logq_i) - (logp - logq)]) of the state held.
    ``carry`` = (x or None, logq, logp, q) of the states the chains come in
    with. ``held``: the pass's loop (``_held``, or its graph on the card).
    Returns (history {'q', 'dqsq', 'logq', 'logp', 'acc'[, 'x']} each
    (batch, n_chains[, ...]), carry after the block)."""
    x0, lq0, lp0, q0 = carry
    src = held(lp0 - lq0, logp - logq, uniforms)
    hq = _select(src, charges, q0)
    acc = torch.cat([src[:1] >= 0, src[1:] != src[:-1]])
    out = {"q": hq, "dqsq": (hq - torch.cat([q0[None], hq[:-1]])) ** 2,
           "logq": _select(src, logq, lq0), "logp": _select(src, logp, lp0),
           "acc": acc.to(logq.dtype)}
    xs = None
    if proposals is not None:
        xs = out["x"] = _select(src, proposals, x0)
    return out, (None if xs is None else xs[-1], out["logq"][-1],
                 out["logp"][-1], hq[-1])


def mcmc_chain_scan(generator: torch.Generator | None, proposals, logq,
                    logp, x0, logq0, logp0, uniforms=None) -> ChainHistory:
    """One serial independence-Metropolis chain over a pre-generated batch
    of proposals (N, 2, L, L) with their logq, logp (N,), from (x0, logq0,
    logp0); uniforms (N,) drawn from ``generator`` unless given."""
    if uniforms is None:
        uniforms = torch.rand(logq.shape, generator=generator,
                              dtype=logq.dtype,
                              device=generator.device).to(logq.device)
    with torch.no_grad():
        carry = (x0[None], logq0.reshape(1), logp0.reshape(1),
                 lattice.topo_charge(x0).reshape(1))
        out, _ = accept_pass(carry, logq[:, None], logp[:, None],
                             lattice.topo_charge(proposals)[:, None],
                             uniforms[:, None], proposals[:, None])
    return ChainHistory(**{k: v[:, 0] for k, v in out.items()})


def _check_kernel(spec: FlowSpec, z: torch.Tensor):
    if z.device.type == "cuda" and not kernel_fits(spec, z.shape[-1],
                                                   z.shape[0]):
        raise ValueError(
            f"flow_backend='auto' on the card runs the proposals through "
            f"K6, which does not take coupling={spec.coupling!r}, conv_dtype="
            f"{spec.conv_dtype!r}, activation={spec.activation!r} at "
            f"L={z.shape[-1]} (ops/coupling_kernels.kernel_fits); name "
            f"flow_backend='torch' for such a flow")


def _flow(params, spec: FlowSpec, z: torch.Tensor, flow_backend: str):
    if flow_backend == "auto":
        _check_kernel(spec, z)
        return kernel_flow_forward(params, z, spec)
    if flow_backend == "torch":
        with full_fp32():
            return flow_forward(params, z, spec, remat=False)
    raise ValueError(f"unknown flow_backend {flow_backend!r}")


def propose(params, spec: FlowSpec, z: torch.Tensor, beta: float,
            flow_backend: str = "auto"):
    """Proposals of latents z (B, 2, L, L): (x, logq, logp, charge), the
    flow through ``flow_backend`` ('auto': K6 on the card, its plain twin
    on the CPU; 'torch': the torch flow)."""
    x, logdet = _flow(params, spec, z, flow_backend)
    logq = uniform_link_prior(z.shape[-1], z.dtype,
                              device=z.device).log_prob(z) - logdet
    return x, logq, -lattice.batch_action(x, beta), lattice.batch_charges(x)


@torch.no_grad()
def run_ensemble(params, spec: FlowSpec, beta: float, z_init: torch.Tensor,
                 blocks, keep_fields: bool = False,
                 flow_backend: str = "auto"):
    """The multi-chain ensemble on given draws: chain c starts from the
    proposal of z_init[c] (accepted by definition); ``blocks`` yields (z
    (batch * n_chains, 2, L, L), uniforms (batch, n_chains)), proposal k
    of a block going to chain k % n_chains. Returns (history {name:
    (n_blocks * batch, n_chains[, 2, L, L])}, init {name: (n_chains[, 2, L,
    L])}), tensors on the draws' device. ``flow_backend`` as ``propose``."""
    x0, lq0, lp0, q0 = propose(params, spec, z_init, beta, flow_backend)
    n = z_init.shape[0]
    carry = (x0, lq0, lp0, q0)
    held = _GraphedHeld() if z_init.device.type == "cuda" else _held
    rows: dict = {}
    for z, u in blocks:
        batch = z.shape[0] // n
        xp, lqp, lpp, qp = propose(params, spec, z, beta, flow_backend)
        out, carry = accept_pass(
            carry, lqp.reshape(batch, n), lpp.reshape(batch, n),
            qp.reshape(batch, n), u,
            xp.reshape(batch, n, *xp.shape[1:]) if keep_fields else None,
            held)
        for k, v in out.items():
            rows.setdefault(k, []).append(v)
    hist = {k: torch.cat(v) for k, v in rows.items()}
    init = {"q": q0, "dqsq": torch.zeros_like(q0), "logq": lq0, "logp": lp0,
            "acc": torch.ones_like(q0)}
    if keep_fields:
        init["x"] = x0
    return hist, init


def make_mcmc_ensemble(params, spec: FlowSpec, *, beta: float, L: int,
                       batch_size: int, num_samples: int,
                       generator: torch.Generator, n_chains: int = 1,
                       keep_fields: bool = False, flow_backend: str = "auto",
                       device=None) -> dict[str, np.ndarray]:
    """Independence-Metropolis chains over flow proposals on ``device``
    (the card by default), drawing latents and uniforms from
    ``generator``. ``num_samples`` samples a chain (the first, the
    always-accepted initial proposal, included) in blocks of
    ``batch_size`` proposals a chain, the flow through ``flow_backend``
    ('auto': K6 on the card; 'torch': the torch flow, for the specs K6
    does not take). Returns host numpy {'q', 'dqsq', 'logq', 'logp',
    'acc'[, 'x']} of shape (num_samples,) for one chain, (num_samples,
    n_chains) for more."""
    device = resolve_device(device)
    p0 = params[0][0]["w"]
    if p0.device.type != device.type:
        raise ValueError(f"flow parameters are on {p0.device}, the run on "
                         f"{device}")
    prior = uniform_link_prior(L, p0.dtype, device=device)
    n_prop = num_samples - 1
    nblocks = max(1, -(-n_prop // batch_size))

    def blocks():
        for _ in range(nblocks):
            z = prior.sample_n(generator, batch_size * n_chains)
            u = torch.rand((batch_size, n_chains), generator=generator,
                           dtype=p0.dtype, device=generator.device)
            yield z, u.to(device)

    hist, init = run_ensemble(params, spec, beta,
                              prior.sample_n(generator, n_chains), blocks(),
                              keep_fields, flow_backend)
    out = {}
    for k, v in hist.items():
        v = torch.cat([init[k][None], v[:n_prop]]).cpu().numpy()
        out[k] = v[:, 0] if n_chains == 1 else v
    return out


def generate_ensemble(params, spec: FlowSpec, *, beta: float, L: int,
                      ensemble_size: int = 1024, batch_size: int = 64,
                      nboot: int = 100, binsize: int = 16,
                      n_chains: int = 1,
                      generator: torch.Generator | None = None,
                      flow_backend: str = "auto", device=None) -> dict:
    """Flow-sampling evaluation: acceptance and chi_Q. One chain: the
    binned-bootstrap chi_Q error; more: ``ensemble_size`` samples a chain
    and errors across chains (observables.chain_stats), with tau_int(Q).
    The generator defaults to one on the device seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    history = make_mcmc_ensemble(
        params, spec, beta=beta, L=L, batch_size=batch_size,
        num_samples=ensemble_size, generator=generator, n_chains=n_chains,
        flow_backend=flow_backend, device=device)
    out = {
        "history": history,
        "accept_rate": acceptance_rate(history["acc"]),
    }
    if n_chains == 1:
        mean, err = topo_susceptibility(history["q"], nboot=nboot,
                                        binsize=binsize)
        out.update(suscept_mean=mean, suscept_err=err)
    else:
        cs = chain_stats(history["q"], n_boot=max(nboot, 100))
        out.update(suscept_mean=cs["chi_q"], suscept_err=cs["chi_q_err"],
                   tau_int_q=cs["tau_int_q"],
                   tau_int_q_err=cs["tau_int_q_err"], chain_stats=cs)
    return out
