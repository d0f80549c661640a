"""The chain-sharded drivers of fthmc_tpu_torch.parallel.mesh and
train(mesh=) on CPU gloo groups of 2 and 4 ranks.

Four ranks are spawned once (``parallel.launch.spawn``: a FileStore
under tmp_path, no TCP port; one torch thread and a nice of 10 a rank),
the group of 2 their first two, and each group runs the port's side of
every check; the references run here. Bounds:
- the data-parallel loss and gradients (reverse KL, with the force term's
  grad of grad) against jax.value_and_grad on the z the JAX key draws,
  split over the ranks: 1e-10 in float64;
- the step-level functions against the single-device steps on the same
  generator (the whole batch's draws, sliced): 1e-12 in float64;
- an era against train_step_at on the ranks' draws concatenated, epoch by
  epoch: 1e-10 in float64, the parameters alike on every rank;
- the whole-run drivers against the single-device drivers run on each
  rank's chains with ``rank_generator(g, rank)``: bit for bit;
- a run's statistics as tests/test_mesh.py holds them.
This module imports no JAX at its top: the ranks import it.
"""
import dataclasses
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch import schwinger as ts
from fthmc_tpu_torch import train as tt
from fthmc_tpu_torch.config import (FlowSpec, HMCConfig, LeapfrogConfig,
                                    TrainConfig)
from fthmc_tpu_torch.models.priors import uniform_link_prior
from fthmc_tpu_torch.parallel import mesh as pm
from fthmc_tpu_torch.parallel.launch import spawn
from fthmc_tpu_torch.weights import flow_params_from_numpy

SIZES = (2, 4)
KW = {"ncp": dict(n_layers=2, coupling="ncp", n_mixture=2,
                  hidden_sizes=(4,)),
      "rncp": dict(n_layers=2, coupling="rncp", n_mixture=2,
                   hidden_sizes=(4,), s_clip=3.0)}
SPEC = FlowSpec(**KW["ncp"])
BATCH, L, BETA = 8, 8, 2.5
HMC = HMCConfig(beta=2.0, L=8, tau=1.0, nstep=10, ntraj=96, n_chains=16,
                randinit=True, seed=3)
TRAIN = TrainConfig(L=8, beta=2.0, batch_size=8, flow=SPEC, seed=0,
                    n_era=2, n_epoch=3)
DYN = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.5, nstep=4,
                         n_chains=8, ntraj=3, cg_tol_force=1e-10,
                         cg_tol_mh=1e-12, cg_maxiter=300)
LF = LeapfrogConfig(tau=0.5, nstep=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here too (each rank runs one): the suite runs in
    several worker processes that share the cores, and OpenMP's parallel
    regions on these small tensors stall when the workers' threads
    outnumber them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(kw, seed):
    rng = np.random.default_rng(seed)
    M = kw["n_mixture"]
    out = 2 * M + 1 if kw["coupling"] == "rncp" else M + 1
    sizes = (2, *kw["hidden_sizes"], out)
    return [[{"w": rng.uniform(-1 / 3, 1 / 3, (co, ci, 3, 3)),
              "b": rng.uniform(-1 / 3, 1 / 3, (co,))}
             for ci, co in zip(sizes[:-1], sizes[1:])]
            for _ in range(kw["n_layers"])]


def _params(dtype=torch.float32, fam="ncp"):
    return flow_params_from_numpy(np_tree(KW[fam], 1), FlowSpec(**KW[fam]),
                                  device="cpu", dtype=dtype)


def _x64(seed, B=16, l=8):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -math.pi, math.pi, (B, 2, l, l)))


def _state(cfg, dtype=torch.float32):
    params = _params(dtype)
    return tt.init_train_state(torch.Generator().manual_seed(0), cfg,
                               params=params, device="cpu")


def _mesh_checks(mesh, inp):
    """Every check's port side on this rank of ``mesh``."""
    out = {"rank": mesh.rank, "size": mesh.size}
    # the data-parallel loss and gradients at this rank's slice of z
    for (fam, fw), z in inp["z"].items():
        params = _params(torch.float64, fam)
        loss, scal, grads, _ = pm._dp_loss_and_grads(
            mesh, params, FlowSpec(**KW[fam]), pm.shard_chains(
                mesh, torch.from_numpy(z)), BETA, 0.7, fw)
        out[("dp", fam, fw)] = (loss, scal, grads)
    # step-level functions on the global batch's draws
    x = _x64(1)
    q = tl.topo_charge(x)
    step = pm.sharded_hmc_step(mesh, beta=2.0, dt=0.2, nstep=8)
    xs, qs, ms = step(torch.Generator().manual_seed(0),
                      pm.shard_chains(mesh, x), pm.shard_chains(mesh, q))
    out["hmc_step"] = (pm.gather_chains(mesh, xs),
                       pm.gather_metrics(mesh, ms._replace(
                           **{k: v[None] for k, v in ms._asdict().items()})))
    fstep = pm.sharded_fthmc_step(mesh, SPEC, beta=2.0, dt=0.1, nstep=3)
    p64 = _params(torch.float64)
    zs, ys, qs, ms = fstep(p64, torch.Generator().manual_seed(1),
                           pm.shard_chains(mesh, x), pm.shard_chains(mesh, q))
    out["fthmc_step"] = (pm.gather_chains(mesh, zs),
                         pm.gather_chains(mesh, ms.dh))
    tstep = pm.sharded_train_step(mesh, SPEC, batch=BATCH, L=L, beta=2.0,
                                  dkl_factor=1.0, base_lr=1e-3)
    st, met = tstep(_state(TRAIN, torch.float64))
    out["train_step"] = (int(st.step), {k: float(v) for k, v in met.items()},
                         tt.param_leaves(st.params))
    # an era, and train(mesh=)
    betas = torch.linspace(2.0, 2.5, 4, dtype=torch.float64)
    st, hist = pm.sharded_train_era(mesh, _state(TRAIN, torch.float64), SPEC,
                                    batch=BATCH, L=L, beta=2.5, n_epoch=4,
                                    betas=betas, grad_clip=1.0)
    out["era"] = (int(st.step), hist, tt.param_leaves(st.params))
    st, hist = tt.train(TRAIN, _state(TRAIN), mesh=mesh)
    out["train"] = (int(st.step), hist)
    # replicate, gather, shard
    tree = {"a": torch.full((3,), float(mesh.rank)),
            "b": [torch.arange(4) * (mesh.rank + 1)],
            "g": torch.Generator().manual_seed(100 + mesh.rank)}
    rep = pm.replicate(mesh, tree)
    out["replicate"] = (rep["a"], rep["b"][0],
                        torch.rand(3, generator=rep["g"]))
    # the whole-run drivers
    g = torch.Generator().manual_seed(11)
    out["run_hmc"] = pm.sharded_run_hmc(mesh, HMC, generator=g)
    out["run_hmc_again"] = pm.sharded_run_hmc(
        mesh, HMC, generator=torch.Generator().manual_seed(11))[0]
    p32 = _params()
    z0 = _x64(2).float()
    out["run_fthmc"] = pm.sharded_run_fthmc(
        mesh, p32, SPEC, LF, beta=2.0, ntraj=3, z0=z0,
        generator=torch.Generator().manual_seed(12))
    seen = []
    out["run_fthmc_chunked"] = pm.sharded_run_fthmc_chunked(
        mesh, p32, SPEC, LF, beta=2.0, ntraj=3, z0=z0,
        generator=torch.Generator().manual_seed(12), block=2,
        callback=lambda done, h: seen.append((done, h.dh.shape)))
    out["fthmc_seen"] = seen
    out["run_hmc_dyn"] = pm.sharded_run_hmc_dyn(
        mesh, DYN, generator=torch.Generator().manual_seed(13))
    out["run_hmc_dyn_chunked"] = pm.sharded_run_hmc_dyn_chunked(
        mesh, DYN, block=2, generator=torch.Generator().manual_seed(13))
    zd = _x64(3, DYN.n_chains, DYN.L).float()
    out["run_fthmc_dyn"] = pm.sharded_run_fthmc_dyn(
        mesh, p32, SPEC, dataclasses.replace(DYN, ntraj=2), z0=zd,
        generator=torch.Generator().manual_seed(14))
    out["run_fthmc_dyn_chunked"] = pm.sharded_run_fthmc_dyn_chunked(
        mesh, p32, SPEC, dataclasses.replace(DYN, ntraj=2), block=1, z0=zd,
        generator=torch.Generator().manual_seed(14))
    # refusals
    with pytest.raises(ValueError, match="ranks"):
        pm.make_chain_mesh(n_devices=mesh.size + 1, group=mesh.group,
                           device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.make_chain_mesh()
    pm._BACKEND_OF["cpu"] = "nccl"
    try:
        with pytest.raises(ValueError, match="does not serve"):
            pm.make_chain_mesh(device="cpu")
    finally:
        pm._BACKEND_OF["cpu"] = "gloo"
    with pytest.raises(ValueError, match="split"):
        pm.sharded_run_hmc(mesh, dataclasses.replace(
            HMC, n_chains=mesh.size * 2 + 1))
    return out


def _jax_z():
    """The z the JAX key draws (float64): every case's latents."""
    import jax
    import jax.numpy as jnp
    from fthmc_tpu.models.priors import uniform_link_prior as jax_prior
    with jax.enable_x64():
        return np.asarray(jax_prior(L, jnp.float64).sample_n(
            jax.random.PRNGKey(5), BATCH))


def _mesh_rank(rank, inp):
    """The port's side of every check on a group of each size in SIZES,
    the first n of the spawned ranks (a niced process each, so that the
    other test workers' threads keep their cores): {n: results} on the
    ranks of each group."""
    os.nice(10)
    out = {}
    for n in SIZES:
        group = (None if n == dist.get_world_size()
                 else dist.new_group(list(range(n))))
        if rank < n:
            mesh = pm.make_chain_mesh(group=group, device="cpu")
            out[n] = _mesh_checks(mesh, inp)
        dist.barrier()
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The ranks spawned once, max(SIZES) of them (gloo, a FileStore, one
    torch thread each), on a thread so that they run while the JAX
    references compute here."""
    z = _jax_z()
    inp = {"z": {(fam, fw): z for fam in KW for fw in (0.0, 0.3)}}
    pool = ThreadPoolExecutor(1)
    yield pool.submit(spawn, _mesh_rank, max(SIZES), inp,
                      workdir=str(tmp_path_factory.mktemp("gloo")))
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_refs():
    """{(family, force_weight): JAX's loss, D_KL and gradient leaves} at
    the key's z, float64."""
    import jax
    import jax.numpy as jnp
    from fthmc_tpu import train as jt
    from fthmc_tpu.config import FlowSpec as JSpec
    key = jax.random.PRNGKey(5)
    refs = {}
    with jax.enable_x64():
        for fam in KW:
            jspec = JSpec(**KW[fam])
            jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              np_tree(KW[fam], 1))
            for fw in (0.0, 0.3):
                def loss_fn(p, fw=fw):
                    return jt.reverse_kl_loss(p, jspec, key, BATCH, L, BETA,
                                              0.7, dtype=jnp.float64,
                                              force_weight=fw)
                (loss, aux), g = jax.value_and_grad(loss_fn,
                                                    has_aux=True)(jp)
                refs[(fam, fw)] = (float(loss), float(aux["dkl"]), [
                    np.asarray(c[k]) for net in g for c in net
                    for k in ("w", "b")])
    return refs


@pytest.fixture(scope="module")
def ranks(groups, jax_refs):
    """{n: every rank's results}, joined after the JAX references."""
    out = groups.result()
    return {n: [r[n] for r in out[:n]] for n in SIZES}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fam,fw", [("ncp", 0.0), ("rncp", 0.0),
                                    ("ncp", 0.3), ("rncp", 0.3)])
def test_data_parallel_loss_and_grads_match_jax(ranks, jax_refs, n, fam,
                                                fw):
    """The ranks' slices of the JAX key's z: the all-reduced loss, D_KL
    and gradients equal jax.value_and_grad of reverse_kl_loss on the whole
    batch (force_weight > 0: the force term's grad of grad), on every
    rank."""
    loss_j, dkl_j, g_j = jax_refs[(fam, fw)]
    tol = 1e-10 * max(1.0, max(np.abs(r).max() for r in g_j))
    for r in ranks[n]:
        loss, scal, grads = r[("dp", fam, fw)]
        assert abs(float(loss) - loss_j) <= 1e-10 * max(1.0, abs(loss_j))
        assert abs(float(scal[0]) - dkl_j) <= 1e-10 * max(1.0, abs(dkl_j))
        for a, b in zip(grads, g_j):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_hmc_step_is_the_single_device_step(ranks, n):
    """The whole batch's draws from one generator, sliced: the gathered
    step equals hmc_step('xla') on the whole batch with that generator."""
    xs, ms = ranks[n][0]["hmc_step"]
    x = _x64(1)
    x1, q1, m = th.hmc_step(torch.Generator().manual_seed(0), x,
                            tl.topo_charge(x), 2.0, 0.2, 8, backend="xla",
                            device="cpu")
    np.testing.assert_allclose(xs.numpy(), x1.numpy(), rtol=0, atol=1e-12)
    for a, b in zip(ms, m):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_fthmc_and_train_steps_are_the_single_device_steps(ranks,
                                                                   n):
    zs, dh = ranks[n][0]["fthmc_step"]
    x = _x64(1)
    z1, _, _, m = th.fthmc_step(_params(torch.float64), SPEC,
                                torch.Generator().manual_seed(1), x,
                                tl.topo_charge(x), 2.0, 0.1, 3,
                                device="cpu")
    assert bool(torch.isfinite(dh).all())
    np.testing.assert_allclose(zs.numpy(), z1.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dh.numpy(), m.dh.numpy(), rtol=0, atol=1e-10)
    step, met, leaves = ranks[n][0]["train_step"]
    st, m = tt.train_step(_state(TRAIN, torch.float64), SPEC, BATCH, L, 2.0,
                          1.0, 1e-3)
    assert step == int(st.step) == 1
    assert 0.0 < met["ess"] <= 1.0 + 1e-12
    for k in ("loss_dkl", "dkl", "ess", "logp", "logq", "plaq"):
        assert abs(met[k] - float(m[k])) <= 1e-10 * max(1.0, abs(met[k]))
    for a, b in zip(leaves, tt.param_leaves(st.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_train_era_is_the_steps_on_the_ranks_draws(ranks, n):
    """An annealed era with clipping: each epoch's latents are the ranks'
    draws from their rank generators, concatenated; train_step_at on them
    epoch by epoch gives the era's losses and parameters (1e-10), which
    every rank holds alike; ESS in (0, 1]; beta the schedule."""
    state = _state(TRAIN, torch.float64)
    gens = [pm.rank_generator(state.generator, r) for r in range(n)]
    prior = uniform_link_prior(L, torch.float64, device="cpu")
    betas = torch.linspace(2.0, 2.5, 4, dtype=torch.float64)
    losses = []
    for b in betas:
        z = torch.cat([prior.sample_n(g, BATCH // n) for g in gens])
        state, m = tt.train_step_at(state, SPEC, z, b, 1.0, 1e-3,
                                    grad_clip=1.0)
        losses.append(float(m["loss_dkl"]))
    step, hist, leaves = ranks[n][0]["era"]
    assert step == 4
    np.testing.assert_allclose(hist["loss_dkl"], losses, rtol=1e-10)
    np.testing.assert_allclose(hist["beta"], betas.numpy(), atol=1e-6)
    assert np.all((hist["ess"] > 0) & (hist["ess"] <= 1 + 1e-12))
    for a, b in zip(leaves, tt.param_leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-10)
    for r in ranks[n][1:]:
        assert all(torch.equal(a, b) for a, b in zip(r["era"][2], leaves))


@pytest.mark.parametrize("n", SIZES)
def test_train_with_a_mesh_trains(ranks, n):
    """train(cfg, mesh=m): both eras, finite losses, ESS in (0, 1], the
    JAX sharded era's metric names."""
    step, hist = ranks[n][0]["train"]
    assert step == TRAIN.n_era * TRAIN.n_epoch
    assert set(hist) == {"loss_dkl", "dkl", "ess", "logp", "logq",
                         "dq_mean", "plaq", "beta", "lr_scale", "dt"}
    assert len(hist["loss_dkl"]) == TRAIN.n_era * TRAIN.n_epoch
    assert np.isfinite(hist["loss_dkl"]).all()
    ess = np.asarray(hist["ess"])
    assert np.all((ess > 0) & (ess <= 1 + 1e-6))


def test_train_with_a_mesh_refuses_what_jax_refuses():
    mesh = pm.Mesh(None, "chains", 0, 2, torch.device("cpu"))
    for kw in ({"with_force": True}, {"ferm_mass": 0.2,
                                      "force_weight": 1.0}):
        with pytest.raises(ValueError, match="single-device"):
            tt.train(dataclasses.replace(TRAIN, **kw), mesh=mesh)


@pytest.mark.parametrize("n", SIZES)
def test_replicate_and_gather(ranks, n):
    """replicate: rank 0's tensors and generator state on every rank."""
    ref = torch.rand(3, generator=torch.Generator().manual_seed(100))
    for r in ranks[n]:
        a, b, u = r["replicate"]
        assert torch.equal(a, torch.zeros(3))
        assert torch.equal(b, torch.arange(4))
        assert torch.equal(u, ref)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_run_hmc_is_the_single_device_runs(ranks, n):
    """Rank r's chains and history columns equal run_hmc on its slice of
    the global hot start with rank_generator(g, r), bit for bit; the run
    repeats itself; exactness and <plaq> as tests/test_mesh.py holds
    them, against the single-device run of the whole batch."""
    g = torch.Generator().manual_seed(11)
    x0 = tl.hot_start(g, HMC.n_chains, HMC.L, device="cpu")
    B = HMC.n_chains // n
    hist = ranks[n][0]["run_hmc"][1]
    assert hist.acc.shape == (HMC.ntraj, HMC.n_chains)
    for r, out in enumerate(ranks[n]):
        xr, hr = th.run_hmc(dataclasses.replace(HMC, n_chains=B),
                            x0=x0[r * B:(r + 1) * B],
                            generator=pm.rank_generator(g, r), device="cpu")
        assert torch.equal(out["run_hmc"][0], xr)
        assert torch.equal(out["run_hmc_again"], xr)
        for a, b, c in zip(out["run_hmc"][1], hr, hist):
            assert torch.equal(a[:, r * B:(r + 1) * B], b)
            assert torch.equal(a, c)
    _, h1 = th.run_hmc(HMC, device="cpu")
    t = 32
    assert abs(float(hist.exp_mdh[t:].mean()) - 1.0) < 0.05
    assert abs(float(hist.plaq[t:].mean()) - float(h1.plaq[t:].mean())) \
        < 0.02


def _equal_runs(outs, key, run_local, x0, n, hist_len):
    B = x0.shape[0] // n
    for r, out in enumerate(outs):
        x, hist = out[key]
        xr, hr = run_local(r, x0[r * B:(r + 1) * B])
        assert torch.equal(x, xr), key
        assert hist.dh.shape == (hist_len, x0.shape[0])
        for a, b in zip(hist, hr):
            assert torch.equal(a[:, r * B:(r + 1) * B].cpu(), b.cpu()), key


@pytest.mark.parametrize("n", SIZES)
def test_sharded_flow_runs_are_the_single_device_runs(ranks, n):
    """sharded_run_fthmc[_chunked] against run_fthmc[_chunked] on each
    rank's chains with its rank generator, bit for bit; the chunked
    callback sees each block's global history."""
    z0 = _x64(2).float()
    p32 = _params()
    g = torch.Generator().manual_seed(12)

    def run(r, z):
        return th.run_fthmc(p32, SPEC, LF, beta=2.0, ntraj=3, z0=z,
                            generator=pm.rank_generator(g, r), device="cpu")

    _equal_runs(ranks[n], "run_fthmc", run, z0, n, 3)
    _equal_runs(ranks[n], "run_fthmc_chunked", run, z0, n, 3)
    assert ranks[n][0]["fthmc_seen"] == [(2, (2, 16)), (3, (1, 16))]


@pytest.mark.parametrize("n", SIZES)
def test_sharded_dynamical_runs_are_the_single_device_runs(ranks, n):
    """sharded_run_hmc_dyn[_chunked] and sharded_run_fthmc_dyn[_chunked]
    against the single-device drivers on each rank's chains with its rank
    generator (the start a hot start from the generator), bit for bit."""
    g = torch.Generator().manual_seed(13)
    x0 = tl.hot_start(g, DYN.n_chains, DYN.L, device="cpu")
    B = DYN.n_chains // n

    def run(r, x):
        return ts.run_hmc_dyn(dataclasses.replace(DYN, n_chains=B), x0=x,
                              generator=pm.rank_generator(g, r),
                              device="cpu")

    _equal_runs(ranks[n], "run_hmc_dyn", run, x0, n, DYN.ntraj)
    _equal_runs(ranks[n], "run_hmc_dyn_chunked", run, x0, n, DYN.ntraj)
    zd = _x64(3, DYN.n_chains, DYN.L).float()
    g = torch.Generator().manual_seed(14)
    cfg = dataclasses.replace(DYN, ntraj=2, n_chains=B)

    def run_ft(r, z):
        return ts.run_fthmc_dyn(_params(), SPEC, cfg, z0=z,
                                generator=pm.rank_generator(g, r),
                                device="cpu")

    _equal_runs(ranks[n], "run_fthmc_dyn", run_ft, zd, n, 2)
    _equal_runs(ranks[n], "run_fthmc_dyn_chunked", run_ft, zd, n, 2)


def test_rank_generator_is_a_pure_function_of_state_and_rank():
    """Like fold_in: equal states and ranks give equal streams, the rank
    changes it, and the caller's generator does not advance."""
    g = torch.Generator().manual_seed(5)
    before = g.get_state()
    a = torch.rand(4, generator=pm.rank_generator(g, 1))
    assert torch.equal(g.get_state(), before)
    assert torch.equal(a, torch.rand(4, generator=pm.rank_generator(
        torch.Generator().manual_seed(5), 1)))
    assert not torch.equal(a, torch.rand(4, generator=pm.rank_generator(
        g, 0)))


def test_mesh_needs_an_initialized_group_and_nccl_a_card():
    with pytest.raises(RuntimeError, match="not initialized"):
        pm.make_chain_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gloo"):
            pm.initialize_multihost()
