"""Domain-decomposed gauge-equivariant flow and FT-HMC.

Counterpart of ``fthmc_tpu/parallel/domain_flow.py``: the coupling layers'
convolutions take k // 2 halo rows from each ring neighbour (one exchange a
convolution, ``domain._RingFetch``), the stripe masks are the global ones
sliced to the rank's rows, and the FT-HMC force is torch.autograd of the
rank's LOCAL action contribution through the sharded flow: the exchange's
backward carries the cross-rank terms, and the gradient of the reduced
action would count each term size times. With ``remat`` each layer runs
under ``torch.utils.checkpoint(use_reentrant=False)``; its recompute issues
the layer's exchanges again, in the same order on every rank.

The sharded convolution runs in fp32 (TF32 off) whatever
``FlowSpec.conv_dtype`` says, as the JAX sharded convolution ignores it.
The spline coupling is refused (NotImplementedError), as the JAX domain
flow refuses it. The reverse flow is not sharded (JAX's is not either):
enter latent space on one device or after ``gather_rows``.
"""
from __future__ import annotations

from functools import lru_cache, partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fthmc_tpu_torch import lattice
from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
from fthmc_tpu_torch.hmc import leapfrog
from fthmc_tpu_torch.models.coupling import (plaq_transform_apply,
                                             stack_cos_sin, wrap_pi)
from fthmc_tpu_torch.models.masks import (layer_mask_params,
                                          link_active_stripes, plaq_masks)
from fthmc_tpu_torch.ops.conv import ACTIVATIONS, full_fp32
from fthmc_tpu_torch.parallel.domain import (_accept_metrics, _domain_run,
                                             _fetch, _kinetic_delta_sharded,
                                             _psum, _run_blocks, _step_draws,
                                             plaq_phase_sharded, shard_rows,
                                             topo_charge_sharded)
from fthmc_tpu_torch.parallel.mesh import Mesh, _local_count

__all__ = ["circular_conv2d_sharded", "flow_forward_sharded",
           "ft_action_sharded", "ft_force_sharded", "make_domain_fthmc_step",
           "run_domain_fthmc", "run_domain_fthmc_chunked"]


def _check_spec(spec: FlowSpec) -> None:
    if spec.coupling not in ("ncp", "rncp"):
        raise NotImplementedError(
            f"the domain-decomposed flow takes the ncp and rncp couplings, "
            f"not {spec.coupling!r} (as the JAX package's)")


def _halo_rows(a: torch.Tensor, p: int, mesh: Mesh):
    """p halo rows from each ring neighbour along the sharded row axis
    (-2), in one exchange: (the previous rank's last p rows, the next
    rank's first p rows)."""
    if p > a.shape[-2]:
        raise ValueError(f"a halo of {p} rows needs at least {p} rows a "
                         f"rank, not {a.shape[-2]}")
    return _fetch(mesh, (a[..., -p:, :], -1), (a[..., :p, :], 1))


def circular_conv2d_sharded(x, w, b, mesh: Mesh) -> torch.Tensor:
    """Periodic convolution with the row axis sharded: columns wrap
    locally, rows get k // 2 halo rows from each neighbour, then a VALID
    fp32 convolution (TF32 off). x: (B, Cin, L0loc, L1)."""
    p = w.shape[-1] // 2
    if p:
        from_prev, from_next = _halo_rows(x, p, mesh)
        x = torch.cat([from_prev, x, from_next], dim=-2)
        x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)
    with full_fp32():
        y = F.conv2d(x, w)
    return y + b[None, :, None, None]


def _conv_net_apply_sharded(params, x, activation: str, mesh: Mesh):
    act = ACTIVATIONS[activation]
    n = len(params)
    for i, pdict in enumerate(params):
        x = circular_conv2d_sharded(x, pdict["w"], pdict["b"], mesh)
        if i != n - 1:
            x = act(x)
    return x


@lru_cache(maxsize=None)
def _local_masks(full_shape, mu: int, off: int, rows_local: int, rank: int,
                 dtype, device):
    """The global (frozen, active, passive) plaquette masks and the active
    link mask, sliced to this rank's rows."""
    start = rank * rows_local
    planes = [m[start:start + rows_local] for m in plaq_masks(full_shape,
                                                              mu, off)]
    links = link_active_stripes((2, *full_shape), mu, off)
    planes.append(links[:, start:start + rows_local])
    return tuple(torch.tensor(m, dtype=dtype, device=device) for m in planes)


def _link_coupling_forward_sharded(net_params, x, mu: int, off: int,
                                   spec: FlowSpec, L0: int, mesh: Mesh):
    """One gauge-equivariant coupling with the row axis sharded: x (B, 2,
    L0loc, L1) -> (fx, this rank's logJ contribution (B,))."""
    l0loc, L1 = x.shape[-2:]
    frozen, active, passive, active_links = _local_masks(
        (L0, L1), mu, off, l0loc, mesh.rank, x.dtype, x.device)
    plaq = plaq_phase_sharded(x, mesh)
    net_out = _conv_net_apply_sharded(net_params, stack_cos_sin(frozen * plaq),
                                      spec.activation, mesh)
    fx1, local_logJ, t = plaq_transform_apply(net_out, plaq, active, spec)
    logJ = local_logJ.sum(dim=(1, 2))
    new_plaq = active * wrap_pi(fx1 + t) + passive * plaq + frozen * plaq
    delta = new_plaq - plaq
    delta_links = torch.stack((delta, -delta), dim=1)
    fx = active_links * wrap_pi(delta_links + x) + (1.0 - active_links) * x
    return fx, logJ


def flow_forward_sharded(params, x, spec: FlowSpec, L0: int, mesh: Mesh,
                         remat: bool = True, reduce: bool = True):
    """The whole flow on a row-sharded field: (y_local, logdet (B,)), the
    logdet all-reduced when ``reduce``, else this rank's contribution
    (differentiable)."""
    _check_spec(spec)
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    use_ckpt = remat and torch.is_grad_enabled()
    for i, p in enumerate(params):
        mu, off = layer_mask_params(i)
        args = (p, x, mu, off, spec, L0, mesh)
        if use_ckpt:
            x, logJ = checkpoint(_link_coupling_forward_sharded, *args,
                                 use_reentrant=False)
        else:
            x, logJ = _link_coupling_forward_sharded(*args)
        logdet = logdet + logJ
    if reduce:
        return x, _psum(mesh, logdet)
    return x, logdet


def _ft_action_local(params, spec, z, beta, L0, mesh, remat):
    """This rank's contribution to S_eff (B,): the contributions sum to
    S_eff over the ranks. The differentiation target of the force."""
    y, logdet_local = flow_forward_sharded(params, z, spec, L0, mesh,
                                           remat=remat, reduce=False)
    local = torch.cos(plaq_phase_sharded(y, mesh)).sum(dim=(1, 2))
    return -beta * local - logdet_local


def ft_action_sharded(params, spec: FlowSpec, z, beta: float, L0: int,
                      mesh: Mesh, remat: bool = True) -> torch.Tensor:
    """S_eff(z) per chain on a row-sharded latent field (all-reduced)."""
    with torch.no_grad():
        return _psum(mesh, _ft_action_local(params, spec, z, beta, L0, mesh,
                                            remat))


def ft_force_sharded(params, spec: FlowSpec, z, beta: float, L0: int,
                     mesh: Mesh, remat: bool = True) -> torch.Tensor:
    """dS_eff/dz on this rank's rows: autograd of the LOCAL action, the
    cross-rank terms carried back by the halo exchanges' backward; fp32
    convolutions in full fp32."""
    with torch.enable_grad(), full_fp32():
        zz = z.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            _ft_action_local(params, spec, zz, beta, L0, mesh, remat).sum(),
            zz)
    return g


@torch.no_grad()
def _domain_fthmc_step_from(params, z, q_old, v0, u, *, spec: FlowSpec,
                            beta: float, dt: float, nstep: int, L0: int,
                            mesh: Mesh, remat: bool = True):
    """One leapfrog FT-HMC trajectory on the row-sharded latent field on
    the given draws (this rank's momenta v0, the shared accept uniforms
    u). Returns (z', q', TrajMetrics of global (B,) tensors)."""
    y0, logdet0 = flow_forward_sharded(params, z, spec, L0, mesh, remat)
    z1, v = leapfrog(z, v0, dt, nstep, lambda zz: ft_force_sharded(
        params, spec, zz, beta, L0, mesh, remat))
    z1 = lattice.wrap(z1)
    y1, logdet1 = flow_forward_sharded(params, z1, spec, L0, mesh, remat)
    dsw = -beta * _psum(mesh, (torch.cos(plaq_phase_sharded(y1, mesh))
                               - torch.cos(plaq_phase_sharded(y0, mesh))
                               ).sum(dim=(1, 2)))
    dh = dsw - (logdet1 - logdet0) + _kinetic_delta_sharded(v, v0, mesh)
    (z_new, y_new), q, m = _accept_metrics(dh, u, (z1, y1), (z, y0),
                                           lambda c: c[1], q_old, mesh)
    return z_new, q, m


def make_domain_fthmc_step(mesh: Mesh, spec: FlowSpec, *, beta: float,
                           dt: float, nstep: int, L0: int,
                           remat: bool = True):
    """A full FT-HMC step with the lattice rows sharded over ``mesh``:
    step(params, generator, z, q_old) -> (z', q', (dh, acc)), z this
    rank's rows, the flow parameters alike on every rank, ``generator``
    the shared one."""
    def step(params, generator, z, q_old):
        v0, u = _step_draws(generator, mesh, z)
        z, q, m = _domain_fthmc_step_from(
            params, z, q_old, v0, u, spec=spec, beta=beta, dt=dt,
            nstep=nstep, L0=L0, mesh=mesh, remat=remat)
        return z, q, (m.dh, m.acc)

    return step


def _fthmc_setup(mesh: Mesh, params, spec, lf, beta, z0, remat):
    """(this rank's rows of z0, the charge of f(z0), step_from(z, q, v0,
    u) of the trajectory)."""
    _check_spec(spec)
    L0 = z0.shape[-2]
    _local_count(mesh, L0, "rows")
    z = shard_rows(mesh, z0)
    with torch.no_grad():
        y0, _ = flow_forward_sharded(params, z, spec, L0, mesh, remat)
    return z, topo_charge_sharded(y0, mesh), partial(
        _domain_fthmc_step_from, params, spec=spec, beta=beta, dt=lf.dt,
        nstep=lf.nstep, L0=L0, mesh=mesh, remat=remat)


def run_domain_fthmc(mesh: Mesh, params, spec: FlowSpec, lf: LeapfrogConfig,
                     *, beta: float, ntraj: int, z0, generator,
                     remat: bool = True):
    """Row-sharded FT-HMC: ntraj leapfrog trajectories from the global
    latent z0 with the lattice rows sharded over ``mesh`` and the flow
    parameters alike on every rank; ``generator`` is the shared one.
    Returns (this rank's rows of the final latents, history dict of (ntraj,
    B) tensors, alike on every rank)."""
    z, q, step_from = _fthmc_setup(mesh, params, spec, lf, beta, z0, remat)
    z, _, hist = _domain_run(step_from, z, q, generator, mesh, ntraj)
    return z, hist._asdict()


def run_domain_fthmc_chunked(mesh: Mesh, params, spec: FlowSpec,
                             lf: LeapfrogConfig, *, beta: float, ntraj: int,
                             z0, generator, block: int = 256, callback=None,
                             remat: bool = True):
    """run_domain_fthmc in blocks of ``block`` trajectories, histories on
    the host, ``callback(done, block_history)`` after each. Returns (this
    rank's rows of the latents, dict of CPU (ntraj, B) tensors)."""
    z, q, step_from = _fthmc_setup(mesh, params, spec, lf, beta, z0, remat)

    def run(n, s):
        z, q, hist = _domain_run(step_from, *s, generator, mesh, n)
        return (z, q), hist

    (z, _), hist = _run_blocks(run, ntraj, block, (z, q), callback)
    return z, hist
