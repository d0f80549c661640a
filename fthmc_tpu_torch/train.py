"""Flow training: reverse KL (and force matching) with Adam.

Counterpart of ``fthmc_tpu/train.py``. Every step is a draw of a latent
batch z from the state's ``torch.Generator`` and a deterministic core at
that z: the loss and its parameter gradients (``loss_and_grads``,
``force_loss_and_grads``), then the update (``Adam.update``: optax's
global-norm clipping and Adam, at a learning rate ``base_lr * lr_scale``
held as a tensor). The JAX key splitting cannot be reproduced, so the
tests hold each core against the JAX package on the z that its key draws.

An era (``train_era``) reads nothing back to the host until it ends: the
scheduler's scalars and the per-epoch metrics stay on the device, and the
era's metrics come back stacked in one read at its end (the JAX package's
design: one dispatch an era, no host round trip a step). On the card the
step is captured once an era in a CUDA graph and replayed, since a step is
thousands of small kernels whose launches would otherwise set its pace.
Training runs the autograd flow (``models/flow.flow_forward``; K7/K8 have
no parameter gradient) with cuDNN's convolutions, every forward and backward
inside ``full_fp32()``: cuDNN reads ``allow_tf32`` when the backward runs,
so a backward outside it would compute the weight gradients in TF32.

Fermion-aware smoothness (``ferm_mass > 0`` with ``force_weight > 0``):
the regularised force is that of the dynamical effective action S_g(f(z))
- log det J_f - ln det(D^dag D)(f(z)) (``ft_force_dyn``), the determinant
exact through ``fermion.logdet_mdagm`` (dense, the training volume). On
the card such an era follows ``FERM_ERA_GRAPHED``: whether the step with
slogdet's LU and its double backward can be captured in a CUDA graph, as
the card test ``test_ferm_mass_era_capture_rule`` finds it.

Data-parallel training (``train(mesh=)``) runs its eras through
``parallel.mesh.sharded_train_era``: the loss and gradients averaged over
the mesh's ranks, on the card as ``MESH_ERA_GRAPHED`` says. As in the JAX
package, force matching (``with_force``) and ``ferm_mass`` are
single-device only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from fthmc_tpu_torch import fermion, lattice
from fthmc_tpu_torch.config import FlowSpec, SchedulerConfig, TrainConfig
from fthmc_tpu_torch.device import resolve_device
from fthmc_tpu_torch.hmc import ft_action, resolve_remat
from fthmc_tpu_torch.models.flow import (flow_forward, flow_reverse,
                                         init_flow_params)
from fthmc_tpu_torch.models.priors import uniform_link_prior
from fthmc_tpu_torch.observables import calc_dkl, calc_ess
from fthmc_tpu_torch.ops.conv import full_fp32

__all__ = ["TrainState", "AdamState", "Adam", "make_optimizer",
           "init_train_state", "sample_and_logq", "reverse_kl_loss",
           "loss_and_grads", "force_loss_and_grads", "train_step",
           "train_step_at", "distill_latents", "force_matching_step",
           "force_matching_step_at", "plateau_scheduler_update",
           "anneal_betas", "train_era", "train", "param_leaves",
           "params_from_leaves", "ft_force_dyn", "FERM_ERA_GRAPHED",
           "MESH_ERA_GRAPHED"]

# Whether an era with ferm_mass > 0 runs on the card as one captured step
# replayed (``_graph_era``) or as eager steps (``_eager_era``): fixed, not
# tried and caught. The card test test_ferm_mass_era_capture_rule captures
# such a step in a process of its own and holds this value to what it
# finds: on an H100 slogdet's LU refuses capture (PERF.md).
FERM_ERA_GRAPHED = False
# Whether a data-parallel era (``parallel.mesh.sharded_train_era``) runs on
# the card as one captured step replayed, its NCCL all-reduces captured
# with it, or as eager steps: fixed, not tried and caught.
# ``parallel.capture_probe`` captures such a step in a process of its own
# and the card test test_mesh_era_capture_rule holds this value to what it
# finds. It was found at world size 1 only: a host of N cards checks it
# first with ``torchrun --nproc-per-node=N -m
# fthmc_tpu_torch.parallel.capture_probe`` (PERF.md).
MESH_ERA_GRAPHED = True


class AdamState(NamedTuple):
    """optax's ScaleByAdamState: the step count (int32) and the first and
    second moments, one tensor per parameter leaf (``param_leaves``)."""
    count: torch.Tensor
    mu: list
    nu: list


class TrainState(NamedTuple):
    """Parameters, optimizer state, the run's generator (drawn from in
    place), and the step and reduce-on-plateau scalars as tensors on the
    run's device."""
    params: Any
    opt_state: AdamState
    generator: torch.Generator
    step: torch.Tensor           # int32
    lr_scale: torch.Tensor       # float32, multiplies base_lr
    best_loss: torch.Tensor      # float32
    plateau_count: torch.Tensor  # int32


def param_leaves(params) -> list:
    """The flow's tensors in a fixed order: layer, conv, then w and b."""
    return [conv[k] for net in params for conv in net for k in ("w", "b")]


def params_from_leaves(like, leaves) -> list:
    """The flow structure of ``like`` holding ``leaves``."""
    it = iter(leaves)
    return [[{k: next(it) for k in ("w", "b")} for _ in net] for net in like]


@dataclass(frozen=True)
class Adam:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` under
    ``inject_hyperparams``, at lr = base_lr * lr_scale with lr_scale a
    tensor given at each update, so a plateau-scaled rate needs no host
    read. Clipping scales the gradients by ``grad_clip / norm`` only when
    the global norm is at least ``grad_clip`` (optax's rule; torch's
    ``clip_grad_norm_`` divides by norm + 1e-6). Functional: ``update``
    returns new tensors."""
    base_lr: float = 1e-3
    grad_clip: float | None = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        leaves = param_leaves(params)
        dev = leaves[0].device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=[torch.zeros_like(t) for t in leaves],
                         nu=[torch.zeros_like(t) for t in leaves])

    def update(self, grads, opt_state: AdamState, params,
               lr_scale: torch.Tensor):
        """(new params, new AdamState) after one step at learning rate
        base_lr * lr_scale (a 0-d tensor) on gradients ``grads`` (leaves in
        ``param_leaves`` order)."""
        g = list(grads)
        if self.grad_clip is not None:
            norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            g = torch._foreach_mul(g, scale)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1),
                                torch._foreach_mul(opt_state.mu, self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
            torch._foreach_mul(opt_state.nu, self.b2))
        count = opt_state.count + 1
        cf = count.to(g[0].dtype)
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, cf))
        nu_hat = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, cf))
        upd = torch._foreach_div(
            mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        lr = self.base_lr * lr_scale
        upd = torch._foreach_mul(upd, -lr.to(g[0].dtype))
        leaves = torch._foreach_add(param_leaves(params), upd)
        return (params_from_leaves(params, leaves),
                AdamState(count=count, mu=mu, nu=nu))


def make_optimizer(base_lr: float, grad_clip: float | None = None) -> Adam:
    """Adam at base_lr (b1 0.9, b2 0.999, eps 1e-8, as optax) with optional
    global-norm clipping."""
    return Adam(base_lr=base_lr, grad_clip=grad_clip)


def _device_of(params) -> torch.device:
    return params[0][0]["w"].device


def _prior_of(params, L: int):
    """The uniform prior at L in the parameters' dtype and device."""
    w = params[0][0]["w"]
    return uniform_link_prior(L, w.dtype, device=w.device)


def init_train_state(generator: torch.Generator | None, cfg: TrainConfig,
                     params=None, dtype=torch.float32,
                     device=None) -> TrainState:
    """A fresh state on ``device`` (the card by default): parameters drawn
    from ``generator`` (by default one on the device seeded with
    cfg.seed) unless given, Adam's zero moments, and the generator kept as
    the run's stream."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(cfg.seed)
    if generator.device.type != device.type:
        raise ValueError(f"the generator is on {generator.device}, the run "
                         f"on {device}")
    if params is None:
        params = init_flow_params(cfg.flow, generator, device=device,
                                  dtype=dtype)
    elif _device_of(params).type != device.type:
        raise ValueError(f"flow parameters are on {_device_of(params)}, the "
                         f"run on {device}")
    return TrainState(
        params=params,
        opt_state=make_optimizer(cfg.base_lr, cfg.grad_clip).init(params),
        generator=generator,
        step=torch.zeros((), dtype=torch.int32, device=device),
        lr_scale=torch.ones((), dtype=torch.float32, device=device),
        best_loss=torch.full((), torch.inf, dtype=torch.float32,
                             device=device),
        plateau_count=torch.zeros((), dtype=torch.int32, device=device))


def sample_and_logq(params, spec: FlowSpec, generator: torch.Generator,
                    batch: int, L: int, dtype=torch.float32):
    """Draw z from the uniform prior and push it through the
    (differentiable) flow: (x, z, logq) with logq(x) = logprior(z) -
    logdet f(z), on the parameters' device."""
    prior = uniform_link_prior(L, dtype, device=_device_of(params))
    z = prior.sample_n(generator, batch)
    x, logdet = flow_forward(params, z, spec)
    return x, z, prior.log_prob(z) - logdet


def _dyn_action(params, spec, z, beta, mass, remat):
    """S_eff of dynamical FT-HMC per chain: S_g(f(z)) - log det J_f - ln
    det(D^dag D)(f(z)), the determinant exact (dense)."""
    y, logdet = flow_forward(params, z, spec, remat=remat)
    return (lattice.batch_action(y, beta) - logdet
            - fermion.logdet_mdagm(y, mass))


def _force_graph(params, spec, z, beta, remat, ferm_mass: float = 0.0):
    """F_eff = dS_eff/dz through the flow, kept differentiable in the
    parameters (a double backward, as jax.grad of the force); with
    ferm_mass > 0 that of the dynamical S_eff (``_dyn_action``)."""
    zz = z.detach().requires_grad_(True)
    s = (_dyn_action(params, spec, zz, beta, ferm_mass, remat) if ferm_mass
         else ft_action(params, spec, zz, beta, remat=remat))
    (f,) = torch.autograd.grad(s.sum(), zz, create_graph=True)
    return f


def ft_force_dyn(params, spec: FlowSpec, z: torch.Tensor, beta, mass: float,
                 remat="auto") -> torch.Tensor:
    """dS_eff/dz of the dynamical effective action S_g(f(z)) - log det J_f
    - ln det(D^dag D)(f(z)) (``fermion.logdet_mdagm``, dense: the training
    volume only), by autograd in full fp32; the counterpart of
    ``fthmc_tpu.train.ft_force_dyn``."""
    remat = resolve_remat(remat, z.shape)
    with torch.enable_grad(), full_fp32():
        zz = z.detach().requires_grad_(True)
        (f,) = torch.autograd.grad(
            _dyn_action(params, spec, zz, beta, mass, remat).sum(), zz)
    return f


def reverse_kl_loss(params, spec: FlowSpec, z: torch.Tensor, beta,
                    dkl_factor: float = 1.0, force_weight: float = 0.0,
                    ferm_mass: float = 0.0, remat="auto"):
    """loss = dkl_factor * E_q[logq - logp], logp = -S(x), at the latent
    batch z (the JAX package draws z inside from its key). With
    force_weight > 0 the loss adds force_weight * mean(F_eff^2) over the
    same batch, F_eff that of the dynamical effective action with
    ferm_mass > 0 (the exact log-determinant; as in the JAX package,
    ferm_mass acts only through force_weight). Returns (loss, aux) with aux
    {logp, logq, x, z, dkl[, force_sq]}."""
    remat = resolve_remat(remat, z.shape)
    x, logdet = flow_forward(params, z, spec, remat=remat)
    logq = uniform_link_prior(z.shape[-1], z.dtype,
                              device=z.device).log_prob(z) - logdet
    logp = -lattice.batch_action(x, beta)
    dkl = calc_dkl(logp, logq)
    aux = {"logp": logp, "logq": logq, "x": x, "z": z, "dkl": dkl}
    loss = dkl_factor * dkl
    if force_weight:
        f = _force_graph(params, spec, z, beta, remat, ferm_mass)
        fsq = torch.mean(f * f)
        aux["force_sq"] = fsq
        loss = loss + force_weight * fsq
    return loss, aux


def _grads(params, objective):
    """(value, aux, gradients in ``param_leaves`` order) of
    ``objective(params) -> (value, aux)``, in full fp32."""
    with torch.enable_grad(), full_fp32():
        leaves = [t.detach().requires_grad_(True)
                  for t in param_leaves(params)]
        value, aux = objective(params_from_leaves(params, leaves))
        grads = torch.autograd.grad(value, leaves)
    return (value.detach(),
            {k: v.detach() for k, v in aux.items()}, list(grads))


def loss_and_grads(params, spec: FlowSpec, z: torch.Tensor, beta,
                   dkl_factor: float = 1.0, force_weight: float = 0.0,
                   ferm_mass: float = 0.0, remat="auto"):
    """The reverse-KL step's deterministic core: (loss, aux, gradients) of
    ``reverse_kl_loss`` at z."""
    return _grads(params, lambda p: reverse_kl_loss(
        p, spec, z, beta, dkl_factor, force_weight, ferm_mass, remat))


def force_loss_and_grads(params, spec: FlowSpec, z: torch.Tensor, beta,
                         remat="auto"):
    """The force-matching step's deterministic core: (loss, gradients) of
    sum ||F_eff||^2 over the latent batch z (a double backward)."""
    remat = resolve_remat(remat, z.shape)

    def objective(p):
        f = _force_graph(p, spec, z, beta, remat)
        return torch.sum(f * f), {}

    loss, _, grads = _grads(params, objective)
    return loss, grads


def _apply(state: TrainState, grads, base_lr: float, grad_clip):
    params, opt_state = make_optimizer(base_lr, grad_clip).update(
        grads, state.opt_state, state.params, state.lr_scale)
    return state._replace(params=params, opt_state=opt_state)


def train_step_at(state: TrainState, spec: FlowSpec, z: torch.Tensor, beta,
                  dkl_factor: float, base_lr: float,
                  grad_clip: float | None = None, force_weight: float = 0.0,
                  ferm_mass: float = 0.0):
    """One reverse-KL step at the latent batch z -> (new state, metrics):
    loss_dkl (the whole objective, what the scheduler watches), dkl, ess,
    logp, logq, q and dq (|Q(x) - Q(z)|, per chain), plaq[, force_sq];
    every value a tensor on the device."""
    L = z.shape[-1]
    loss, aux, grads = loss_and_grads(state.params, spec, z, beta,
                                      dkl_factor, force_weight, ferm_mass)
    state = _apply(state, grads, base_lr, grad_clip)
    q = lattice.batch_charges(aux["x"])
    metrics = {
        "loss_dkl": loss,
        "dkl": aux["dkl"],
        "ess": calc_ess(aux["logp"], aux["logq"]),
        "logp": torch.mean(aux["logp"]),
        "logq": torch.mean(aux["logq"]),
        "q": q,
        "dq": torch.abs(q - lattice.batch_charges(z)),
        "plaq": torch.mean(aux["logp"]) / (beta * L * L),
    }
    if "force_sq" in aux:
        metrics["force_sq"] = aux["force_sq"]
    return state._replace(step=state.step + 1), metrics


def train_step(state: TrainState, spec: FlowSpec, batch: int, L: int, beta,
               dkl_factor: float, base_lr: float,
               grad_clip: float | None = None, force_weight: float = 0.0,
               ferm_mass: float = 0.0):
    """One reverse-KL step on ``batch`` prior draws from the state's
    generator (``train_step_at``). ``beta`` may be a float or a 0-d tensor
    (beta-annealed training)."""
    z = _prior_of(state.params, L).sample_n(state.generator, batch)
    return train_step_at(state, spec, z, beta, dkl_factor, base_lr,
                         grad_clip, force_weight, ferm_mass)


@torch.no_grad()
def distill_latents(params, pre_params, spec: FlowSpec,
                    generator: torch.Generator, batch: int, L: int):
    """Distillation latents of force matching: prior draws pushed through
    the frozen pre-model and inverted through the current flow by
    bisection (no gradient)."""
    z_pre = _prior_of(params, L).sample_n(generator, batch)
    x, _ = flow_forward(pre_params, z_pre, spec)
    xi, _ = flow_reverse(params, x, spec)
    return xi


def force_matching_step_at(state: TrainState, spec: FlowSpec,
                           z: torch.Tensor, beta, base_lr: float,
                           lr_factor: float,
                           grad_clip: float | None = None):
    """One force-matching step at the latent batch z, at learning rate
    base_lr * lr_factor * lr_scale. The step count is not advanced (the
    reverse-KL step owns it)."""
    loss, grads = force_loss_and_grads(state.params, spec, z, beta)
    state = _apply(state, grads, base_lr * lr_factor, grad_clip)
    return state, {"loss_force": loss}


def force_matching_step(state: TrainState, spec: FlowSpec, batch: int,
                        L: int, beta, base_lr: float, lr_factor: float,
                        pre_params=None, grad_clip: float | None = None):
    """Force matching on ``batch`` latents from the state's generator: prior
    draws, or with ``pre_params`` the distilled latents
    (``distill_latents``)."""
    if pre_params is not None:
        z = distill_latents(state.params, pre_params, spec, state.generator,
                            batch, L)
    else:
        z = _prior_of(state.params, L).sample_n(state.generator, batch)
    return force_matching_step_at(state, spec, z, beta, base_lr, lr_factor,
                                  grad_clip)


def _plateau_update_device(state: TrainState, loss: torch.Tensor,
                           sched: SchedulerConfig,
                           base_lr: float) -> TrainState:
    """Branchless reduce-on-plateau on the device (no host read). best_loss
    starts at +inf, where best - threshold * |best| is nan: the inf guard
    counts the first epoch as an improvement. After a reduction the counter
    restarts at -cooldown."""
    loss = loss.to(state.best_loss.dtype)
    best = state.best_loss
    improved = (loss < best - sched.threshold * torch.abs(best)) \
        | torch.isinf(best)
    in_cooldown = state.plateau_count < 0
    count = torch.where(improved & ~in_cooldown,
                        torch.zeros_like(state.plateau_count),
                        state.plateau_count + 1)
    fire = count > sched.patience
    scale = torch.where(
        fire, torch.clamp(state.lr_scale * sched.factor,
                          min=sched.min_lr / base_lr), state.lr_scale)
    return state._replace(
        best_loss=torch.where(improved, loss, best),
        plateau_count=torch.where(fire, torch.full_like(count,
                                                        -sched.cooldown),
                                  count),
        lr_scale=scale)


def plateau_scheduler_update(state: TrainState, loss: float,
                             sched: SchedulerConfig,
                             base_lr: float) -> TrainState:
    """Reduce-on-plateau on a host loss value: the device rule
    (``_plateau_update_device``) on it as a float32 tensor."""
    return _plateau_update_device(
        state, torch.full((), loss, dtype=torch.float32,
                          device=state.lr_scale.device), sched, base_lr)


def anneal_betas(cfg: TrainConfig, era: int, device=None):
    """Per-epoch target betas of one era of beta-annealed training, a
    float32 tensor on ``device`` (the card by default): beta ramps linearly
    from cfg.beta_init to cfg.beta over the first cfg.beta_anneal_frac of
    all steps. None (constant beta) without cfg.beta_init."""
    if cfg.beta_init is None:
        return None
    total = max(1, cfg.n_era * cfg.n_epoch)
    ramp_steps = max(1, int(total * cfg.beta_anneal_frac))
    g = era * cfg.n_epoch + torch.arange(cfg.n_epoch,
                                         device=resolve_device(device))
    frac = torch.clamp(g.to(torch.float32) / ramp_steps, max=1.0)
    return cfg.beta_init + (cfg.beta - cfg.beta_init) * frac


def _era_step(state: TrainState, spec, zs, beta_e, dkl_factor, base_lr,
              sched, with_force, force_lr_factor, grad_clip, force_weight,
              ferm_mass: float = 0.0):
    """One epoch of an era at the latents zs (the KL batch, and the force
    batch with ``with_force``): (new state, its scalar metrics)."""
    state, metrics = train_step_at(state, spec, zs[0], beta_e, dkl_factor,
                                   base_lr, grad_clip, force_weight,
                                   ferm_mass)
    if with_force:
        state, fmetrics = force_matching_step_at(
            state, spec, zs[1], beta_e, base_lr, force_lr_factor, grad_clip)
        metrics = {**metrics, **fmetrics}
    if sched is not None:
        state = _plateau_update_device(state, metrics["loss_dkl"], sched,
                                       base_lr)
    scalars = {k: v for k, v in metrics.items() if v.ndim == 0}
    scalars["dq_mean"] = torch.mean(metrics["dq"])
    scalars["lr_scale"] = state.lr_scale
    scalars["beta"] = beta_e.to(torch.float32)
    return state, scalars


def _state_tensors(state: TrainState) -> list:
    o = state.opt_state
    return [*param_leaves(state.params), *o.mu, *o.nu, o.count, state.step,
            state.lr_scale, state.best_loss, state.plateau_count]


def _with_tensors(state: TrainState, ts) -> TrainState:
    """``state`` holding the tensors ``ts`` (in ``_state_tensors`` order)."""
    n = len(state.opt_state.mu)
    count, step, lr_scale, best, plateau = ts[3 * n:]
    return TrainState(params_from_leaves(state.params, ts[:n]),
                      AdamState(count, list(ts[n:2 * n]),
                                list(ts[2 * n:3 * n])),
                      state.generator, step, lr_scale, best, plateau)


def _eager_era(step, state, draw, betas):
    """The era as a loop of eager steps: (state, {name: dtype}, (names,
    n_epoch) float64 metrics on the device)."""
    rows: dict = {}
    for e in range(betas.shape[0]):
        state, scalars = step(state, draw(), betas[e])
        for k, v in scalars.items():
            rows.setdefault(k, []).append(v)
    hist = torch.stack([torch.stack(v).to(torch.float64)
                        for v in rows.values()])
    return state, {k: v[0].dtype for k, v in rows.items()}, hist


_GRAPH_WARMUP = 2        # eager steps before capture (lazy init, caches)


def _graph_era(step, state, draw, betas):
    """The era on the card as one step captured in a CUDA graph and
    replayed once an epoch: the state lives in buffers the graph updates in
    place (copies of the caller's), each epoch copies its latents (drawn
    from the generator outside the graph, in the eager order) and beta in
    and the step's metrics out. The warm-up steps and the capture run on
    copies and zero latents, so the caller's state and generator see only
    the era. Same kernels as the eager loop, without a launch's host cost
    for each of the step's thousands of small ops."""
    static = [t.clone() for t in _state_tensors(state)]
    sstate = _with_tensors(state, static)
    zs = [torch.zeros(shape, dtype=static[0].dtype, device=static[0].device)
          for shape in draw.shapes]
    beta = betas[0].clone()
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(_GRAPH_WARMUP):
            step(_with_tensors(state, [t.clone() for t in static]), zs, beta)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        new, scalars = step(sstate, zs, beta)
        torch._foreach_copy_(static, _state_tensors(new))
        out = torch.stack([v.to(torch.float64) for v in scalars.values()])
        graph.capture_end()
    main.wait_stream(side)
    hist = out.new_empty((out.shape[0], betas.shape[0]))
    for e in range(betas.shape[0]):
        for buf, z in zip(zs, draw()):
            buf.copy_(z)
        beta.copy_(betas[e])
        graph.replay()
        hist[:, e].copy_(out)
    return sstate, {k: v.dtype for k, v in scalars.items()}, hist


class _Draws:
    """The latent batches of one epoch from the state's generator: the KL
    batch, and the force batch with ``with_force``."""

    def __init__(self, state: TrainState, L: int, batch: int, n: int):
        self.prior = _prior_of(state.params, L)
        self.generator, self.batch = state.generator, batch
        self.shapes = [(batch, 2, L, L)] * n

    def __call__(self):
        return [self.prior.sample_n(self.generator, self.batch)
                for _ in self.shapes]


def train_era(state: TrainState, spec: FlowSpec, batch: int, L: int,
              beta: float, dkl_factor: float, base_lr: float, n_epoch: int,
              sched: SchedulerConfig | None = None,
              with_force: bool = False, force_lr_factor: float = 0.01,
              betas: torch.Tensor | None = None,
              grad_clip: float | None = None,
              force_weight: float = 0.0, ferm_mass: float = 0.0):
    """One era: n_epoch steps (each a reverse-KL step, then a force-matching
    step with ``with_force``, then the plateau rule with ``sched``), with
    no host read until the era's scalar metrics come back in one read. On
    the card the step is captured once in a CUDA graph and replayed
    (``_graph_era``; with ferm_mass > 0 as ``FERM_ERA_GRAPHED`` says); on
    the CPU the steps run eagerly. ``betas``:
    per-epoch betas (an (n_epoch,) tensor on the device) that override
    ``beta``. Returns (state, {metric: numpy (n_epoch,)})."""
    dev = state.lr_scale.device
    if betas is None:
        betas = torch.full((n_epoch,), beta, dtype=torch.float32, device=dev)
    draw = _Draws(state, L, batch, 2 if with_force else 1)

    def step(st, zs, beta_e):
        return _era_step(st, spec, zs, beta_e, dkl_factor, base_lr, sched,
                         with_force, force_lr_factor, grad_clip,
                         force_weight, ferm_mass)

    graphed = FERM_ERA_GRAPHED or not (ferm_mass and force_weight)
    return _run_era(step, state, draw, betas, dev.type == "cuda" and graphed)


def _run_era(step, state, draw, betas, graphed: bool):
    """The era of ``step`` over ``betas``, captured and replayed
    (``_graph_era``) or eager, its metrics read to the host once. Returns
    (state, {metric: numpy (n_epoch,)})."""
    era = _graph_era if graphed else _eager_era
    state, dtypes, hist = era(step, state, draw, betas)
    host = hist.cpu().numpy()                  # the era's one host read
    return state, {k: host[i].astype(str(dt).split(".")[-1])
                   for i, (k, dt) in enumerate(dtypes.items())}


def train(cfg: TrainConfig, state: TrainState | None = None,
          scheduler: SchedulerConfig | None = None, callback=None,
          checkpoint_fn=None, start_era: int = 0, mesh=None, device=None):
    """Era x epoch training on ``device`` (the card by default): eras
    start_era .. cfg.n_era - 1 through ``train_era``, each with its slice of
    the beta schedule. callback(step, metrics) per epoch (replayed from the
    era's metrics), checkpoint_fn(era, state, history) per era. A run
    restored from ckpt_era{k} passes start_era=k + 1, continuing the era
    numbering and the beta schedule. ``mesh`` (a
    ``parallel.mesh.Mesh``): the eras run data-parallel over its ranks
    (``sharded_train_era``; the state and device are the mesh rank's);
    force matching and ferm_mass then raise, as the JAX package asserts.
    Returns (state, history {metric: list of per-epoch values, and
    'dt'})."""
    if mesh is not None:
        if cfg.with_force:
            raise ValueError("force-matching is single-device only")
        if cfg.ferm_mass:
            raise ValueError("fermion-aware smoothness (ferm_mass) is "
                             "single-device only")
        from fthmc_tpu_torch.parallel.mesh import sharded_train_era
        device = mesh.device
    if state is None:
        state = init_train_state(None, cfg, device=device)
    dev = state.lr_scale.device
    history: dict = {}
    for era in range(start_era, cfg.n_era):
        t0 = time.time()
        betas = anneal_betas(cfg, era, device=dev)
        if mesh is not None:
            state, host = sharded_train_era(
                mesh, state, cfg.flow, batch=cfg.batch_size, L=cfg.L,
                beta=cfg.beta, dkl_factor=cfg.dkl_factor,
                base_lr=cfg.base_lr, n_epoch=cfg.n_epoch, sched=scheduler,
                betas=betas, grad_clip=cfg.grad_clip,
                force_weight=cfg.force_weight)
        else:
            state, host = train_era(
                state, cfg.flow, cfg.batch_size, cfg.L, cfg.beta,
                cfg.dkl_factor, cfg.base_lr, cfg.n_epoch, sched=scheduler,
                with_force=cfg.with_force,
                force_lr_factor=cfg.force_lr_factor, betas=betas,
                grad_clip=cfg.grad_clip, force_weight=cfg.force_weight,
                ferm_mass=cfg.ferm_mass)
        dt = time.time() - t0
        step0 = int(state.step) - cfg.n_epoch if callback is not None else 0
        for e in range(cfg.n_epoch):
            for k, v in host.items():
                history.setdefault(k, []).append(v[e])
            history.setdefault("dt", []).append(dt / cfg.n_epoch)
            if callback is not None:
                callback(step0 + e + 1, {k: v[e] for k, v in host.items()})
        if checkpoint_fn is not None:
            checkpoint_fn(era, state, history)
    return state, history
