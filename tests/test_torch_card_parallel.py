"""The parallel drivers (fthmc_tpu_torch.parallel) at world size 1 on an
NCCL group made from a HashStore (no TCP port), at the paths' shapes: the
chain-sharded drivers against their single-device drivers bit for bit,
data-parallel training against the single-device era, and the row-sharded
drivers (every halo row through the all-gather) against the physics.

Marked ``cuda``: each test skips without a card. Imports only torch, numpy
and the port (tests/test_torch_cuda.py gives the command)."""
import dataclasses

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import lattice
from fthmc_tpu_torch import train as ttrain
from fthmc_tpu_torch.config import HMCConfig, LeapfrogConfig
from fthmc_tpu_torch.hmc import ft_force, hmc_step, run_fthmc, run_hmc
from fthmc_tpu_torch.models import priors
from fthmc_tpu_torch.ops.conv import full_fp32
from fthmc_tpu_torch.parallel import domain as pdom
from fthmc_tpu_torch.parallel import domain_fermion as pdferm
from fthmc_tpu_torch.parallel import domain_flow as pdflow
from fthmc_tpu_torch.parallel import mesh as pmesh
from fthmc_tpu_torch.schwinger import (SchwingerConfig, force_evaluations,
                                       run_hmc_dyn)
from test_torch_card_samplers import DYN
from test_torch_card_training import REF_TRAIN
from test_torch_cuda import (FT_BETA, FT_L, FT_NSTEP, FT_TAU,  # noqa: F401
                             HEADLINE_CFG, _close_traj, _counted, _expect,
                             card, flagship, near_equilibrium)

pytestmark = pytest.mark.cuda

# The chain-sharded runs held bit for bit to their single-device drivers:
# trajectories of the headline ('auto': K2), of the flagship FT path and
# of path B (K11 on chains-last planes).
PAR_TRAJ = {"hmc": 20, "fthmc": 6, "hmc_dyn": 4}
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
# run of 8 chains x 96 trajectories read <exp(-dH)> 1.000: (trajectories
# thermalizing near-equilibrium links on one device (K11), row-sharded
# trajectories measured from there), the block
PAR_DOMAIN_DYN = SchwingerConfig(L=16, beta=2.0, mass=0.2, tau=1.0, nstep=8,
                                 n_chains=16, cg_maxiter=2000)
PAR_DOMAIN_DYN_TRAJ, PAR_DOMAIN_DYN_BLOCK = (40, 10), 7


@pytest.fixture(scope="module")
def meshes(card):
    """A world-size-1 NCCL group (a HashStore), its chain and rows meshes;
    the group destroyed after the module's tests."""
    import torch.distributed as dist
    pmesh.initialize_multihost(num_processes=1, process_id=0,
                               store=dist.HashStore())
    try:
        yield (pmesh.make_chain_mesh(device=card),
               pdom.make_rows_mesh(device=card))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(PAR_TRAJ))
def test_chain_sharded_driver_is_its_single_device_run(card, flagship,
                                                       meshes, name):
    """sharded_run_hmc (the headline), sharded_run_fthmc (the flagship)
    and sharded_run_hmc_dyn (path B) against their single-device drivers
    run with rank_generator(g, 0): final chains and every history field
    bit for bit equal, the launches of each run equal to each other and to
    the path's count."""
    mesh, _ = meshes
    params, spec, z0 = flagship

    def gen(seed):
        return torch.Generator(device=card).manual_seed(seed)

    expect = _expect()
    if name == "hmc":
        hc = dataclasses.replace(HEADLINE_CFG, ntraj=PAR_TRAJ["hmc"])
        x0 = torch.zeros((hc.n_chains, 2, hc.L, hc.L), device=card)
        expect["K2"] = expect["K12"] = hc.ntraj

        def sharded():
            return pmesh.sharded_run_hmc(mesh, hc, x0=x0, generator=gen(61))

        def single():
            return run_hmc(hc, x0=x0, device=card,
                           generator=pmesh.rank_generator(gen(61), 0))
    elif name == "fthmc":
        lf, n = LeapfrogConfig(tau=FT_TAU, nstep=FT_NSTEP), PAR_TRAJ["fthmc"]
        n_force, nl = 2 * FT_NSTEP + 1, spec.n_layers
        expect.update({"K1": n_force * n, "K6": 2 * nl * n + nl,
                       "K7": n_force * nl * n, "K8": n_force * nl * n})
        kw = dict(beta=FT_BETA, ntraj=n, z0=z0, integrator="omelyan")

        def sharded():
            return pmesh.sharded_run_fthmc(mesh, params, spec, lf,
                                           generator=gen(62), **kw)

        def single():
            return run_fthmc(params, spec, lf, device=card,
                             generator=pmesh.rank_generator(gen(62), 0),
                             **kw)
    else:
        cfg = dataclasses.replace(DYN["B"], ntraj=PAR_TRAJ["hmc_dyn"])
        xb = near_equilibrium(gen(63), cfg.n_chains, cfg.L, cfg.beta, card)
        n_force = force_evaluations(cfg)["dyn"]
        expect.update({"K1": n_force * cfg.ntraj,        # K11: a solve a
                       "K11": (n_force + 1) * cfg.ntraj})  # force, one MH

        def sharded():
            return pmesh.sharded_run_hmc_dyn(mesh, cfg, x0=xb,
                                             generator=gen(64))

        def single():
            return run_hmc_dyn(cfg, x0=xb, device=card,
                               generator=pmesh.rank_generator(gen(64), 0))
    (x1, h1), l1, _ = _counted(single)
    (xs, hs), ls, _ = _counted(sharded)
    assert torch.equal(x1, xs) and all(torch.equal(a, b)
                                       for a, b in zip(h1, hs))
    assert ls == l1 == expect, (ls, l1, expect)


def test_data_parallel_training_is_the_single_device_era(card, meshes):
    """train(cfg, mesh=) for one era of the reference configuration: its
    first step's loss and gradients (``_dp_loss_and_grads``) against
    train's ``loss_and_grads`` on the same latents, then the era's losses
    against train_era's on the rank generator's draws, within 1e-5
    relative; the losses finite and the ESS in (0, 1]."""
    mesh, _ = meshes
    cfg = dataclasses.replace(REF_TRAIN, n_era=1)
    gen = torch.Generator(device=card).manual_seed(65)
    state = ttrain.init_train_state(gen, cfg, device=card)
    z = priors.uniform_link_prior(cfg.L, device=card).sample_n(
        pmesh.rank_generator(gen, 1), cfg.batch_size)
    loss_m, _, grads_m, _ = pmesh._dp_loss_and_grads(
        mesh, state.params, cfg.flow, z, cfg.beta, cfg.dkl_factor)
    loss_1, _, grads_1 = ttrain.loss_and_grads(state.params, cfg.flow, z,
                                               cfg.beta, cfg.dkl_factor)
    g_m, g_1 = (torch.cat([g.reshape(-1) for g in gg])
                for gg in (grads_m, grads_1))
    assert abs(float(loss_m - loss_1)) <= 1e-5 * abs(float(loss_1))
    assert float((g_m - g_1).norm()) <= 1e-5 * max(float(g_1.norm()), 1e-30)
    single = state._replace(generator=pmesh.rank_generator(gen, 0))
    _, hm = ttrain.train(cfg, state, mesh=mesh)
    _, h1 = ttrain.train_era(single, cfg.flow, cfg.batch_size, cfg.L,
                             cfg.beta, cfg.dkl_factor, cfg.base_lr,
                             cfg.n_epoch)
    lm, l1 = np.asarray(hm["loss_dkl"]), np.asarray(h1["loss_dkl"])
    ess = np.asarray(hm["ess"])
    assert float(np.max(np.abs(lm - l1) / np.abs(l1))) <= 1e-5
    assert np.isfinite(lm).all() and ((ess > 0) & (ess <= 1)).all()


def test_row_sharded_hmc(card, meshes):
    """The row-sharded HMC at 64^2 x 64 (every halo row through the
    all-gather): one step's core against hmc_step's 'xla' path on the same
    draws (dH within dh_tolerance, the accept equal but within it of the
    threshold, x' within 1e-4 where it agrees); from links thermalized on
    one device, a run's <exp(-dH)> within 0.05 of 1; no kernel launched."""
    _, rows = meshes
    cfg = dataclasses.replace(PAR_DOMAIN_HMC, ntraj=1)
    g = torch.Generator(device=card).manual_seed(66)
    x = near_equilibrium(g, cfg.n_chains, cfg.L, cfg.beta, card)
    state = g.get_state()
    v0 = torch.randn(x.shape, generator=g, device=card)
    u = torch.rand((cfg.n_chains,), generator=g, device=card)
    g.set_state(state)
    q0 = lattice.topo_charge(x)
    xr, _, mr = hmc_step(g, x, q0, cfg.beta, cfg.dt, cfg.nstep,
                         backend="xla", device=card)
    xd, _, md = pdom._domain_hmc_step_from(
        pdom.shard_rows(rows, x), q0, pdom.shard_rows(rows, v0), u,
        beta=cfg.beta, dt=cfg.dt, nstep=cfg.nstep, mesh=rows)
    _close_traj((pdom.gather_rows(rows, xd), md.dh, md.acc.bool()),
                (xr, mr.dh, mr.acc.bool()), x, v0, u, cfg.beta, cfg.dt,
                cfg.nstep)
    therm, meas = PAR_DOMAIN_HMC_TRAJ
    x, _ = run_hmc(dataclasses.replace(PAR_DOMAIN_HMC, ntraj=therm), x0=x,
                   device=card)
    (_, h), launches, _ = _counted(lambda: pdom.run_domain_hmc(
        rows, dataclasses.replace(PAR_DOMAIN_HMC, ntraj=meas), x0=x,
        generator=torch.Generator(device=card).manual_seed(67)))
    em = float(h["exp_mdh"].mean())
    assert abs(em - 1.0) <= 0.05, em
    assert not any(launches.values()), launches


def test_row_sharded_fthmc(card, flagship, meshes):
    """ft_force_sharded at the flagship against the autograd force within
    1e-4 x max|F|; a few row-sharded FT trajectories: finite, integer
    charges, no kernel launched."""
    _, rows = meshes
    params, spec, z0 = flagship
    with full_fp32():
        f_d = pdom.gather_rows(rows, pdflow.ft_force_sharded(
            params, spec, pdom.shard_rows(rows, z0), FT_BETA, FT_L, rows))
        f_a = ft_force(params, spec, z0, FT_BETA, device=card)
    assert float((f_d - f_a).abs().max()) <= 1e-4 * float(f_a.abs().max())
    lf = LeapfrogConfig(tau=FT_TAU, nstep=FT_NSTEP)
    (zd, h), launches, _ = _counted(lambda: pdflow.run_domain_fthmc(
        rows, params, spec, lf, beta=FT_BETA, ntraj=PAR_DOMAIN_FT_TRAJ,
        z0=z0, generator=torch.Generator(device=card).manual_seed(68)))
    assert all(bool(torch.isfinite(t).all()) for t in h.values()) \
        and bool(torch.isfinite(zd).all())
    q = h["q"]
    assert bool((q - q.round()).abs().max() <= 1e-3)
    assert not any(launches.values()), launches


def test_row_sharded_dynamical_hmc(card, meshes):
    """Row-sharded dynamical HMC at the JAX package's sharded test
    configuration from links thermalized on one device: <exp(-dH)> within
    0.05 of 1, no kernel launched."""
    _, rows = meshes
    therm, meas = PAR_DOMAIN_DYN_TRAJ
    g = torch.Generator(device=card).manual_seed(69)
    single = dataclasses.replace(PAR_DOMAIN_DYN, ntraj=therm)
    x = near_equilibrium(g, single.n_chains, single.L, single.beta, card)
    x, _ = run_hmc_dyn(single, x0=x, generator=g, device=card)
    (_, h), launches, _ = _counted(lambda: pdferm.run_domain_hmc_dyn_chunked(
        rows, dataclasses.replace(PAR_DOMAIN_DYN, ntraj=meas), x0=x,
        block=PAR_DOMAIN_DYN_BLOCK, cg_log=tf.CGLog(),
        generator=torch.Generator(device=card).manual_seed(70)))
    em = float(h["exp_mdh"].mean())
    assert abs(em - 1.0) <= 0.05, em
    assert not any(launches.values()), launches
