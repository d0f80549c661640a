"""The row-sharded drivers of fthmc_tpu_torch.parallel (domain,
domain_flow) against fthmc_tpu, on CPU gloo groups of 2 and 4 ranks.

Four ranks are spawned once (``parallel.launch.spawn``: a FileStore
under tmp_path, no TCP port; one torch thread and a nice of 10 a rank),
the group of 2 their first two, and each group runs the port's side of
every check; the JAX sides run here, the sharded JAX functions on the
conftest's virtual mesh of the same number of devices. Bounds: 1e-10 in
float64, where both packages take it (the stencils, the flow's output and
log-det, S_eff and its force, the step cores against the single-device
steps on the same draws); the JAX sharded functions of a float64 field
too. The drivers' runs are held by their invariants: every rank's history
identical (the shared accept draws), integer charges, and a short fp32
run's <exp(-dH)> and <plaq>. This module imports no JAX at its top: the
ranks import it.
"""
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig
from fthmc_tpu_torch.hmc import fthmc_step, hmc_step
from fthmc_tpu_torch.parallel import domain as pd
from fthmc_tpu_torch.parallel import domain_flow as pdf
from fthmc_tpu_torch.parallel.launch import spawn
from fthmc_tpu_torch.parallel.mesh import Mesh
from fthmc_tpu_torch.weights import flow_params_from_numpy

TOL = 1e-10
B, L, BETA = 3, 8, 2.0
KW = {"ncp": dict(n_layers=2, coupling="ncp", n_mixture=2,
                  hidden_sizes=(4,)),
      "rncp": dict(n_layers=2, coupling="rncp", n_mixture=2,
                   hidden_sizes=(4,), s_clip=3.0)}
RUN = HMCConfig(beta=2.0, L=L, tau=1.0, nstep=8, ntraj=160, n_chains=8,
                randinit=True, seed=3)
RUN_THERM = 40
SIZES = (2, 4)


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
    tree = []
    for _ in range(kw["n_layers"]):
        net = []
        for ci, co in zip(sizes[:-1], sizes[1:]):
            bound = 1.0 / math.sqrt(9 * ci)
            net.append({"w": rng.uniform(-bound, bound, (co, ci, 3, 3)),
                        "b": rng.uniform(-bound, bound, (co,))})
        tree.append(net)
    return tree


def inputs():
    rng = np.random.default_rng(2026)
    return {"x": rng.uniform(-3.0, 3.0, (B, 2, L, L)),
            "x1": rng.uniform(-3.0, 3.0, (B, 2, L, L)),
            "z": rng.uniform(-2.0, 2.0, (B, 2, L, L)),
            "tree": {k: np_tree(kw, i) for i, (k, kw) in enumerate(
                KW.items())}}


def _same_draws(seed: int, like: torch.Tensor):
    """(a generator, the momenta and accept uniforms the single-device
    step draws from it first), the generator set back."""
    g = torch.Generator().manual_seed(seed)
    state = g.get_state()
    v0 = torch.randn(like.shape, generator=g, dtype=like.dtype)
    u = torch.rand((like.shape[0],), generator=g, dtype=like.dtype)
    g.set_state(state)
    return g, v0, u


def _domain_checks(mesh, inp):
    """Every check's port side on this rank of ``mesh``; gathered
    (global) tensors."""

    def g(t, dim=-2):
        return pd.gather_rows(mesh, t, dim)

    x, x1, z = (torch.from_numpy(inp[k]) for k in ("x", "x1", "z"))
    xs, x1s, zs = (pd.shard_rows(mesh, t) for t in (x, x1, z))
    out = {"plaq": g(pd.plaq_phase_sharded(xs, mesh), -2),
           "force": g(pd.force_sharded(xs, BETA, mesh)),
           "action": pd.action_sharded(xs, BETA, mesh),
           "q": pd.topo_charge_sharded(xs, mesh),
           "plaq_mean": pd.plaq_mean_sharded(xs, mesh),
           "delta_action": pd.delta_action_sharded(x1s, xs, BETA, mesh)}
    nf, npv = pd._fetch(mesh, (xs[..., :1, :], 1), (xs[..., -1:, :], -1))
    out["neighbors"] = (g(nf), g(npv))
    for fam, kw in KW.items():
        spec = FlowSpec(**kw)
        params = flow_params_from_numpy(inp["tree"][fam], spec,
                                        device="cpu", dtype=torch.float64)
        y, ld = pdf.flow_forward_sharded(params, xs, spec, L, mesh)
        y_nr, ld_local = pdf.flow_forward_sharded(
            params, xs, spec, L, mesh, remat=False, reduce=False)
        out[f"{fam}_flow"] = (g(y), ld, g(y_nr),
                              pd._psum(mesh, ld_local))
        out[f"{fam}_action"] = pdf.ft_action_sharded(params, spec, zs, BETA,
                                                     L, mesh)
        out[f"{fam}_force"] = g(pdf.ft_force_sharded(params, spec, zs, BETA,
                                                     L, mesh))
        out[f"{fam}_force_noremat"] = g(pdf.ft_force_sharded(
            params, spec, zs, BETA, L, mesh, remat=False))
    # the step cores on the draws of the single-device steps
    gen, v0, u = _same_draws(5, x)
    q0 = tl.topo_charge(x)
    xd, qd, md = pd._domain_hmc_step_from(
        xs, q0, pd.shard_rows(mesh, v0), u, beta=BETA, dt=0.1, nstep=6,
        mesh=mesh)
    xr, qr, mr = hmc_step(gen, x, q0, BETA, 0.1, 6, backend="xla",
                          device="cpu")
    out["hmc_step"] = ((g(xd), qd, md._asdict()), (xr, qr, mr._asdict()))
    spec = FlowSpec(**KW["rncp"])
    params = flow_params_from_numpy(inp["tree"]["rncp"], spec, device="cpu",
                                    dtype=torch.float64)
    gen, v0, u = _same_draws(6, z)
    zd, qd, md = pdf._domain_fthmc_step_from(
        params, zs, q0, pd.shard_rows(mesh, v0), u, spec=spec, beta=BETA,
        dt=0.1, nstep=4, L0=L, mesh=mesh)
    zr, _, qr, mr = fthmc_step(params, spec, gen, z, q0, BETA, 0.1, 4,
                               force_backend="autograd", device="cpu")
    out["fthmc_step"] = ((g(zd), qd, md._asdict()), (zr, qr, mr._asdict()))
    # the drivers (fp32)
    _, out["run"] = pd.run_domain_hmc(
        mesh, RUN, generator=torch.Generator().manual_seed(7))
    seen = []
    xc, out["chunked"] = pd.run_domain_hmc_chunked(
        mesh, HMCConfig(beta=2.0, L=L, tau=0.5, nstep=4, ntraj=12,
                        n_chains=4, randinit=True, seed=4),
        block=5, callback=lambda done, h: seen.append(done))
    out["chunked_seen"] = seen
    out["chunked_x"] = g(xc)
    step = pd.make_domain_hmc_step(mesh, beta=BETA, dt=0.1, nstep=4)
    gen = torch.Generator().manual_seed(8)
    x32 = pd.shard_rows(mesh, x.float())
    _, _, out["step_fn"] = step(gen, x32, tl.topo_charge(x.float()))
    spec32 = FlowSpec(**KW["ncp"])
    p32 = flow_params_from_numpy(inp["tree"]["ncp"], spec32, device="cpu")
    seen = []
    zc, out["ft_chunked"] = pdf.run_domain_fthmc_chunked(
        mesh, p32, spec32, LeapfrogConfig(tau=0.4, nstep=4), beta=BETA,
        ntraj=5, z0=z.float(), generator=torch.Generator().manual_seed(9),
        block=2, callback=lambda done, h: seen.append(done))
    out["ft_seen"] = seen
    fstep = pdf.make_domain_fthmc_step(mesh, spec32, beta=BETA, dt=0.1,
                                       nstep=2, L0=L)
    _, _, out["ft_step_fn"] = fstep(p32, torch.Generator().manual_seed(10),
                                    pd.shard_rows(mesh, z.float()),
                                    torch.zeros(B))
    return out


def _domain_rank(rank, inp):
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
            mesh = pd.make_rows_mesh(group=group, device="cpu")
            out[n] = _domain_checks(mesh, inp)
        dist.barrier()
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The ranks spawned once, max(SIZES) of them (gloo, a FileStore, one
    torch thread each), on a thread so that they run while the JAX
    references compute here."""
    inp = inputs()
    pool = ThreadPoolExecutor(1)
    yield pool.submit(spawn, _domain_rank, max(SIZES), inp,
                      workdir=str(tmp_path_factory.mktemp("gloo")))
    pool.shutdown()


@pytest.fixture(scope="module")
def ranks(groups, jax_refs):
    """{n: every rank's results}, joined after the JAX references."""
    out = groups.result()
    return {n: [r[n] for r in out[:n]] for n in SIZES}


def _jnp64(a):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.float64)


def _jax_sharded(n, fn, out_specs, *args):
    """fn(*args) under shard_map over n virtual devices, the first arg a
    row-sharded field."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as P
    return jax.jit(jax.shard_map(
        fn, mesh=JMesh(np.array(jax.devices()[:n]), ("rows",)),
        in_specs=(P(None, None, "rows", None),), out_specs=out_specs,
        check_vma=False))(*args)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's single-device references in float64."""
    import jax
    from fthmc_tpu import lattice as jl
    from fthmc_tpu.config import FlowSpec as JSpec
    from fthmc_tpu.hmc import ft_action, ft_force
    from fthmc_tpu.models.flow import flow_forward
    inp = inputs()
    with jax.enable_x64():
        x, x1, z = (_jnp64(inp[k]) for k in ("x", "x1", "z"))
        ref = {"plaq": jl.batch_plaqs(x), "force": jl.batch_force(x, BETA),
               "action": jl.batch_action(x, BETA),
               "q": jl.batch_charges(x),
               "plaq_mean": jl.batch_plaq_mean(x),
               "delta_action": jl.batch_action(x1, BETA)
               - jl.batch_action(x, BETA)}
        for fam, kw in KW.items():
            spec = JSpec(**kw)
            tree = jax.tree.map(_jnp64, inp["tree"][fam])
            ref[f"{fam}_flow"] = flow_forward(tree, x, spec)
            ref[f"{fam}_action"] = ft_action(tree, spec, z, BETA)
            ref[f"{fam}_force"] = ft_force(tree, spec, z, BETA)
        return {k: jax.tree.map(np.asarray, v) for k, v in ref.items()}


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_stencils_match_jax(ranks, jax_refs, n):
    got = ranks[n][0]
    for k in ("plaq", "force", "action", "q", "plaq_mean"):
        _close(got[k], jax_refs[k], TOL * max(1.0, float(np.abs(
            jax_refs[k]).max())))
    _close(got["delta_action"], jax_refs["delta_action"], 1e-9)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_stencils_match_the_jax_sharded_ones(ranks, n):
    import jax
    from jax.sharding import PartitionSpec as P
    from fthmc_tpu.parallel import domain as jd
    got = ranks[n][0]
    with jax.enable_x64():
        x = _jnp64(inputs()["x"])
        ref = _jax_sharded(
            n, lambda xx: (jd.plaq_phase_sharded(xx, "rows"),
                           jd.force_sharded(xx, BETA, "rows"),
                           jd.action_sharded(xx, BETA, "rows"),
                           jd.topo_charge_sharded(xx, "rows")),
            (P(None, "rows", None), P(None, None, "rows", None), P(), P()),
            x)
    for k, r in zip(("plaq", "force", "action", "q"), ref):
        _close(got[k], r, TOL * max(1.0, float(np.abs(r).max())))


@pytest.mark.parametrize("n", SIZES)
def test_halo_exchange_fetches_the_ring_neighbours_rows(ranks, n):
    """_fetch of (first row, +1) and (last row, -1): the next rank's first
    row and the previous rank's last row on every rank, assembled: np.roll
    of the edge rows by one block."""
    nf, npv = ranks[n][0]["neighbors"]
    x = inputs()["x"]
    rows = L // n
    blocks = np.arange(n) * rows
    np.testing.assert_array_equal(nf.numpy(), np.roll(
        x[..., blocks, :], -1, axis=-2))
    np.testing.assert_array_equal(npv.numpy(), np.roll(
        x[..., blocks + rows - 1, :], 1, axis=-2))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fam", list(KW))
def test_flow_forward_sharded_matches_jax(ranks, jax_refs, n, fam):
    """y and the log-det (all-reduced, and as the sum of the ranks' local
    contributions, with and without remat) against flow_forward."""
    y, ld, y_nr, ld_sum = ranks[n][0][f"{fam}_flow"]
    yr, ldr = jax_refs[f"{fam}_flow"]
    for got, ref in ((y, yr), (y_nr, yr), (ld, ldr), (ld_sum, ldr)):
        _close(got, ref, TOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fam", list(KW))
def test_ft_action_and_force_sharded_match_jax(ranks, jax_refs, n, fam):
    """S_eff and F_eff = dS_eff/dz (autograd of the local action, the halo
    exchange's backward carrying the cross-rank terms; remat or not)
    against ft_action and jax.grad on one device."""
    got = ranks[n][0]
    _close(got[f"{fam}_action"], jax_refs[f"{fam}_action"],
           TOL * float(np.abs(jax_refs[f"{fam}_action"]).max()))
    for k in ("force", "force_noremat"):
        _close(got[f"{fam}_{k}"], jax_refs[f"{fam}_force"],
               TOL * max(1.0, float(np.abs(jax_refs[f"{fam}_force"]).max())))


@pytest.mark.parametrize("n", SIZES)
def test_flow_and_force_match_the_jax_sharded_ones(ranks, n):
    """The rncp flow and its force against the JAX domain_flow functions
    on n virtual devices, float64 both."""
    import jax
    from jax.sharding import PartitionSpec as P
    from fthmc_tpu.config import FlowSpec as JSpec
    from fthmc_tpu.parallel import domain_flow as jdf
    got = ranks[n][0]
    spec = JSpec(**KW["rncp"])
    with jax.enable_x64():
        tree = jax.tree.map(_jnp64, inputs()["tree"]["rncp"])
        xs = P(None, None, "rows", None)
        (y, ld), f = _jax_sharded(
            n, lambda zz: (jdf.flow_forward_sharded(tree, zz, spec, L,
                                                    "rows"),
                           jdf.ft_force_sharded(tree, spec, zz, BETA, L,
                                                "rows")),
            ((xs, P()), xs), _jnp64(inputs()["z"]))
        y0, _ = _jax_sharded(
            n, lambda xx: jdf.flow_forward_sharded(tree, xx, spec, L,
                                                   "rows"),
            (xs, P()), _jnp64(inputs()["x"]))
    _close(got["rncp_flow"][0], y0, TOL * 10)
    _close(got["rncp_force"], f, TOL * max(1.0, float(np.abs(f).max())))


def _step_equal(pair, tol):
    (xd, qd, md), (xr, qr, mr) = pair
    _close(xd, xr, tol)
    _close(qd, qr, tol)
    for k in ("dh", "exp_mdh", "acc", "plaq", "q", "dq"):
        _close(md[k], mr[k], tol * max(1.0, float(mr[k].abs().max())))


@pytest.mark.parametrize("n", SIZES)
def test_domain_step_cores_equal_the_single_device_steps(ranks, n):
    """_domain_hmc_step_from on the sharded momenta equals hmc_step's
    'xla' path on the same draws; _domain_fthmc_step_from equals
    fthmc_step with the autograd force (leapfrog), float64."""
    _step_equal(ranks[n][0]["hmc_step"], 1e-10)
    _step_equal(ranks[n][0]["fthmc_step"], 1e-9)


@pytest.mark.parametrize("n", SIZES)
def test_every_rank_holds_the_same_history(ranks, n):
    """The accept uniforms come from the shared generator: every rank's
    accept decisions and metrics are identical, so the field does not
    tear across ranks."""
    for k in ("run", "chunked", "ft_chunked"):
        for r in ranks[n][1:]:
            for f in ranks[n][0][k]:
                assert torch.equal(r[k][f], ranks[n][0][k][f]), (k, f)
    for k in ("step_fn", "ft_step_fn"):
        for r in ranks[n][1:]:
            assert all(torch.equal(a, b) for a, b in zip(r[k],
                                                         ranks[n][0][k]))


@pytest.mark.parametrize("n", SIZES)
def test_run_domain_hmc_physics(ranks, n):
    """160 fp32 trajectories at 8^2, beta=2, 8 chains: exactness, the
    exact plaquette (loose: a short run), integer charges, 0/1 accepts."""
    h = ranks[n][0]["run"]
    assert h["acc"].shape == (RUN.ntraj, RUN.n_chains)
    assert set(np.unique(h["acc"].numpy())) <= {0.0, 1.0}
    t = RUN_THERM
    assert abs(float(h["exp_mdh"][t:].mean()) - 1.0) < 0.05
    assert abs(float(h["plaq"][t:].mean()) - tl.PLAQ_EXACT[2.0]) < 0.03
    q = h["q"].numpy()
    assert np.allclose(q, np.round(q), atol=1e-3)


@pytest.mark.parametrize("n", SIZES)
def test_chunked_drivers_and_step_functions(ranks, n):
    got = ranks[n][0]
    assert got["chunked_seen"] == [5, 10, 12]
    assert got["chunked"]["acc"].shape == (12, 4)
    assert got["chunked_x"].shape == (4, 2, L, L)
    assert got["ft_seen"] == [2, 4, 5]
    h = got["ft_chunked"]
    assert h["dh"].shape == (5, B)
    assert all(bool(torch.isfinite(v).all()) for v in h.values())
    q = h["q"].numpy()
    assert np.allclose(q, np.round(q), atol=1e-3)
    for k in ("step_fn", "ft_step_fn"):
        dh, acc = got[k]
        assert dh.shape == acc.shape == (B,)
        assert bool(torch.isfinite(dh).all())
        assert set(acc.tolist()) <= {0.0, 1.0}


def test_domain_spline_raises():
    """Spline couplings are refused by the domain flow (NotImplementedError,
    as the JAX domain flow refuses them), before any collective."""
    mesh = Mesh(None, "rows", 0, 1, torch.device("cpu"))
    spec = FlowSpec(n_layers=2, n_mixture=2, hidden_sizes=(4,),
                    coupling="spline")
    z = torch.zeros((1, 2, 4, 4))
    with pytest.raises(NotImplementedError):
        pdf.flow_forward_sharded([], z, spec, 4, mesh)
    with pytest.raises(NotImplementedError):
        pdf.ft_force_sharded([], spec, z, 1.0, 4, mesh)
    with pytest.raises(NotImplementedError):
        pdf.run_domain_fthmc(mesh, [], spec, LeapfrogConfig(0.1, 1),
                             beta=1.0, ntraj=1, z0=z,
                             generator=torch.Generator())
