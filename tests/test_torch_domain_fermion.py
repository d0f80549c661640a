"""The row-sharded dynamical fermions of fthmc_tpu_torch.parallel
(domain_fermion) against fthmc_tpu, on CPU gloo groups of 2 and 4 ranks.

The JAX fermion code is fp32 (complex64) whatever the dtype, so these
comparisons are fp32, at the JAX sharded tests' own bounds
(tests/test_domain_fermion.py): the Dirac operators and the parity mask
2e-5 (the mask exactly), the CG solutions 5e-5, the forces (gauge plus
fermion, and the flowed force's one backward) 5e-4, the heatbath's start
action against the exact one 1e-4 relative; against the single-device
JAX functions and, for the operators, the solves and the force, the JAX
sharded functions on the conftest's virtual mesh of as many devices. The
dynamical step cores equal the port's single-device steps on the same
draws to fp32 roundoff. The CG's stop test reads the all-reduced
residual: every rank makes the same iterations, with one host read each
and one. Four ranks are spawned once (``parallel.launch.spawn``, a
FileStore under tmp_path), the group of 2 their first two; this module
imports no JAX at its top.
"""
import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fthmc_tpu_torch import fermion as tf
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch import schwinger as ts
from fthmc_tpu_torch.config import FlowSpec
from fthmc_tpu_torch.models.flow import flow_forward
from fthmc_tpu_torch.parallel import domain as pd
from fthmc_tpu_torch.parallel import domain_fermion as pdx
from fthmc_tpu_torch.parallel.launch import spawn
from fthmc_tpu_torch.parallel.mesh import Mesh, rank_generator
from fthmc_tpu_torch.weights import flow_params_from_numpy

B, L, MASS, BETA = 2, 8, 0.2, 2.0
SIZES = (2, 4)
FLOW = dict(n_layers=2, coupling="ncp", n_mixture=2, hidden_sizes=(4,))
CFG = ts.SchwingerConfig(L=L, beta=BETA, mass=MASS, tau=0.5, nstep=2,
                         n_chains=B, cg_tol_force=1e-12, cg_tol_mh=1e-12,
                         cg_maxiter=2000)
SOLVE = dict(tol=1e-12, maxiter=2000)


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


def np_tree(seed):
    rng = np.random.default_rng(seed)
    sizes = (2, *FLOW["hidden_sizes"], FLOW["n_mixture"] + 1)
    return [[{"w": rng.uniform(-1 / 3, 1 / 3, (co, ci, 3, 3)),
              "b": rng.uniform(-1 / 3, 1 / 3, (co,))}
             for ci, co in zip(sizes[:-1], sizes[1:])]
            for _ in range(FLOW["n_layers"])]


def _cn(rng, shape):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            * math.sqrt(0.5)).astype(np.complex64)


def _even(shape):
    return ((np.arange(shape[-3])[:, None] + np.arange(shape[-2])[None, :])
            % 2 == 0).astype(np.float32)[..., None]


def inputs():
    """theta, z, psi (even-masked too), the steps' draws, the flow tree
    and the pseudofermion fields (phi_eo, phi: D^dag chi by the JAX
    package's own heatbath formula, on theta; phi_y on f(z))."""
    rng = np.random.default_rng(2027)
    shape = (B, L, L, 2)
    inp = {"theta": rng.uniform(-3.0, 3.0, (B, 2, L, L)).astype(np.float32),
           "z": rng.uniform(-2.0, 2.0, (B, 2, L, L)).astype(np.float32),
           "psi": _cn(rng, shape), "chi": _cn(rng, shape),
           "v0": rng.normal(size=(B, 2, L, L)).astype(np.float32),
           "u": rng.uniform(size=(B,)).astype(np.float32),
           "tree": np_tree(3)}
    inp["psi_e"] = inp["psi"] * _even(shape)
    theta = torch.from_numpy(inp["theta"])
    chi = torch.from_numpy(inp["chi"])
    for eo in (False, True):
        inp[f"phi_{int(eo)}"] = tf.pf_refresh_from(chi, theta, MASS,
                                                   eo)[0].numpy()
    spec = FlowSpec(**FLOW)
    params = flow_params_from_numpy(inp["tree"], spec, device="cpu")
    y, _ = flow_forward(params, torch.from_numpy(inp["z"]), spec)
    inp["phi_y"] = tf.pf_refresh_from(chi, y.detach(), MASS,
                                      True)[0].numpy()
    return inp


def _fermion_checks(mesh, inp):
    """Every check's port side on this rank of ``mesh``; gathered
    tensors."""
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "tree"}

    def links(k):
        return pd.shard_rows(mesh, t[k])

    def spinor(k):
        return pd.shard_rows(mesh, t[k], -3)

    def g(a, dim=-3):
        return pd.gather_rows(mesh, a, dim)

    th, psi, psi_e = links("theta"), spinor("psi"), spinor("psi_e")
    out = {"dirac": g(pdx.dirac_sharded(th, psi, 0.1, mesh)),
           "dirac_dag": g(pdx.dirac_dag_sharded(th, psi, 0.1, mesh)),
           "mdagm": g(pdx.apply_mdagm_sharded(th, psi, 0.1, mesh)),
           "mdagm_eo": g(pdx.apply_mdagm_eo_sharded(th, psi_e, 0.1, mesh)),
           "parity": g(pdx.parity_mask_sharded(psi.shape, mesh), 0)}
    for eo in (False, True):
        b = psi_e if eo else psi
        res = pdx.cg_solve_sharded(th, b, MASS, eo=eo, mesh=mesh, **SOLVE)
        out[f"cg_{int(eo)}"] = (g(res.x), res.iters, res.reads)
        phi = spinor(f"phi_{int(eo)}")
        f, res = pdx.dyn_force_sharded(th, phi, BETA, MASS,
                                       torch.zeros_like(phi), eo=eo,
                                       mesh=mesh, **SOLVE)
        out[f"dyn_force_{int(eo)}"] = g(f, -2)
    phi, s0 = pdx.pf_refresh_sharded(rank_generator(
        torch.Generator().manual_seed(4), mesh.rank), th, MASS, eo=True,
        mesh=mesh)
    s, res = pdx.pf_action_exact_sharded(th, phi, MASS, eo=True, mesh=mesh,
                                         **SOLVE)
    lin = pdx.pf_action_lin_sharded(th, phi, res.x, MASS, eo=True,
                                    mesh=mesh)
    out["pf_refresh"] = (s0, s, res.iters, lin)
    spec = FlowSpec(**FLOW)
    params = flow_params_from_numpy(inp["tree"], spec, device="cpu")
    f, _ = pdx.ft_dyn_force_sharded(params, spec, links("z"), CFG,
                                    spinor("phi_y"),
                                    torch.zeros_like(spinor("phi_y")), L,
                                    mesh)
    out["ft_dyn_force"] = g(f, -2)
    # the step cores on the single-device steps' draws
    draws = (links("v0"), spinor("chi"), t["u"])
    q0 = tl.topo_charge(t["theta"])
    x, q, m = pdx._domain_hmc_dyn_step_from(th, q0, CFG, draws, mesh)
    out["hmc_dyn_step"] = (g(x, -2), q, m._asdict())
    z, q, m = pdx._domain_fthmc_dyn_step_from(params, links("z"), q0, CFG,
                                              spec, L, draws, mesh)
    out["fthmc_dyn_step"] = (g(z, -2), q, m._asdict())
    seen = []
    _, out["run"] = pdx.run_domain_hmc_dyn_chunked(
        mesh, ts.SchwingerConfig(L=L, beta=BETA, mass=MASS, tau=0.5,
                                 nstep=2, n_chains=4, ntraj=4,
                                 cg_maxiter=2000),
        block=3, generator=torch.Generator().manual_seed(5),
        callback=lambda done, h: seen.append(done))
    out["run_seen"] = seen
    log = tf.CGLog()
    _, out["ft_run"] = pdx.run_domain_fthmc_dyn_chunked(
        mesh, params, spec, ts.SchwingerConfig(
            L=L, beta=BETA, mass=MASS, tau=0.25, nstep=1, n_chains=2,
            ntraj=2, cg_maxiter=2000), block=1, cg_log=log,
        generator=torch.Generator().manual_seed(6))
    out["ft_run_reads"] = [e[2] - e[0] for s in log.solves.values()
                           for e in s]
    return out


def _fermion_rank(rank, inp):
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
            out[n] = _fermion_checks(mesh, inp)
        dist.barrier()
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The ranks spawned once, max(SIZES) of them (gloo, a FileStore, one
    torch thread each), on a thread so that they run while the JAX
    references compute here."""
    inp = inputs()
    pool = ThreadPoolExecutor(1)
    yield pool.submit(spawn, _fermion_rank, max(SIZES), inp,
                      workdir=str(tmp_path_factory.mktemp("gloo")))
    pool.shutdown()


@pytest.fixture(scope="module")
def ranks(groups, jax_refs):
    """{n: every rank's results}, joined after the JAX references."""
    out = groups.result()
    return {n: [r[n] for r in out[:n]] for n in SIZES}


@pytest.fixture(scope="module")
def jax_refs():
    """The single-device JAX package's operators, solves and forces."""
    import jax.numpy as jnp
    from fthmc_tpu import fermion as jf
    from fthmc_tpu import schwinger as js
    from fthmc_tpu.config import FlowSpec as JSpec
    inp = inputs()
    th, psi, psi_e = (jnp.asarray(inp[k]) for k in ("theta", "psi",
                                                     "psi_e"))
    ref = {"dirac": jf.dirac(th, psi, 0.1),
           "dirac_dag": jf.dirac_dag(th, psi, 0.1),
           "mdagm": jf.apply_mdagm(th, psi, 0.1),
           "mdagm_eo": jf.apply_mdagm_eo(th, psi_e, 0.1),
           "parity": jf.parity_mask(psi.shape, 0)}
    for eo in (False, True):
        b = psi_e if eo else psi
        ref[f"cg_{int(eo)}"] = jf.cg_solve(th, b, MASS, eo=eo,
                                           backend="xla", **SOLVE).x
        phi = jnp.asarray(inp[f"phi_{int(eo)}"])
        ref[f"dyn_force_{int(eo)}"] = js.dyn_force(
            th, phi, BETA, MASS, jnp.zeros_like(phi), 1e-12, 2000, eo=eo)[0]
    tree = [[{k: jnp.asarray(v, jnp.float32) for k, v in c.items()}
             for c in net] for net in inp["tree"]]
    phi_y = jnp.asarray(inp["phi_y"])
    ref["ft_dyn_force"] = js.ft_dyn_force(
        tree, JSpec(**FLOW), jnp.asarray(inp["z"]), CFG, phi_y,
        jnp.zeros_like(phi_y), False)[0]
    return {k: np.asarray(v) for k, v in ref.items()}


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("n", SIZES)
def test_dirac_operators_match_jax(ranks, jax_refs, n):
    got = ranks[n][0]
    for k in ("dirac", "dirac_dag", "mdagm", "mdagm_eo"):
        _close(got[k], jax_refs[k], 2e-5)
    np.testing.assert_array_equal(got["parity"].numpy(), jax_refs["parity"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("eo", [False, True])
def test_cg_solve_sharded_matches_jax(ranks, jax_refs, n, eo):
    """The sharded CG's solution; every rank made the same iterations,
    with one host read each and one."""
    x, iters, reads = ranks[n][0][f"cg_{int(eo)}"]
    _close(x, jax_refs[f"cg_{int(eo)}"], 5e-5)
    assert reads == iters + 1
    assert all(r[f"cg_{int(eo)}"][1] == iters for r in ranks[n])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("eo", [False, True])
def test_dyn_force_sharded_matches_jax(ranks, jax_refs, n, eo):
    """The gauge stencil plus autograd of the LOCAL fermion action equals
    the single-device dyn_force (the halo exchange's backward carries the
    cross-rank terms)."""
    _close(ranks[n][0][f"dyn_force_{int(eo)}"],
           jax_refs[f"dyn_force_{int(eo)}"], 5e-4)


@pytest.mark.parametrize("n", SIZES)
def test_ops_solve_and_force_match_the_jax_sharded_ones(ranks, n):
    """The operators, the eo solve and the eo force against the JAX
    domain_fermion functions on n virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from jax.sharding import PartitionSpec as P
    from fthmc_tpu.parallel import domain_fermion as jdf
    inp = inputs()
    th, psi, psi_e, phi = (jnp.asarray(inp[k]) for k in (
        "theta", "psi", "psi_e", "phi_1"))
    xs, ps = P(None, None, "rows", None), P(None, "rows", None, None)

    def local(t, p, pe, ph):
        return (jdf.apply_mdagm_sharded(t, p, 0.1, "rows"),
                jdf.apply_mdagm_eo_sharded(t, pe, 0.1, "rows"),
                jdf.cg_solve_sharded(t, pe, MASS, eo=True, axis_name="rows",
                                     **SOLVE).x,
                jdf.dyn_force_sharded(t, ph, BETA, MASS, jnp.zeros_like(ph),
                                      eo=True, axis_name="rows", **SOLVE)[0])

    ref = jax.jit(jax.shard_map(
        local, mesh=JMesh(np.array(jax.devices()[:n]), ("rows",)),
        in_specs=(xs, ps, ps, ps), out_specs=(ps, ps, ps, xs),
        check_vma=False))(th, psi, psi_e, phi)
    got = ranks[n][0]
    for k, r, tol in zip(("mdagm", "mdagm_eo", "cg_1", "dyn_force_1"), ref,
                         (2e-5, 2e-5, 5e-5, 5e-4)):
        _close(got[k][0] if k == "cg_1" else got[k], r, tol)


@pytest.mark.parametrize("n", SIZES)
def test_pf_refresh_action_consistency(ranks, n):
    """The sharded heatbath's start action chi^dag chi equals the exact
    S_pf of a tight sharded solve, and the variational form
    pf_action_lin_sharded at that solution equals S_pf."""
    s0, s, iters, lin = ranks[n][0]["pf_refresh"]
    assert iters < SOLVE["maxiter"]
    np.testing.assert_allclose(lin.numpy(), s.numpy(), rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-4)


@pytest.mark.parametrize("n", SIZES)
def test_ft_dyn_force_sharded_matches_jax(ranks, jax_refs, n):
    """The one-backward latent force (gauge + log-det + fermion) through
    the sharded flow and the sharded CG equals schwinger.ft_dyn_force."""
    _close(ranks[n][0]["ft_dyn_force"], jax_refs["ft_dyn_force"], 5e-4)


def _single_steps():
    """The port's single-device dynamical steps on the test's draws."""
    inp = inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items() if k != "tree"}
    draws = (t["v0"], t["chi"], t["u"])
    q0 = tl.topo_charge(t["theta"])
    plain = ts._hmc_step_dyn(t["theta"], q0, CFG, draws)
    spec = FlowSpec(**FLOW)
    params = flow_params_from_numpy(inp["tree"], spec, device="cpu")

    def flow(zz):
        return flow_forward(params, zz, spec, remat=False)

    z, _, q, m = ts._fthmc_step_dyn(params, spec, t["z"], q0, CFG, draws,
                                    False, "autograd", flow)
    return plain, (z, q, m)


@pytest.fixture(scope="module")
def single_steps():
    return _single_steps()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["hmc_dyn_step", "fthmc_dyn_step"])
def test_dyn_step_cores_equal_the_single_device_steps(ranks, single_steps,
                                                      n, kind):
    """The row-sharded dynamical step cores on the sharded draws equal the
    single-device steps (schwinger._hmc_step_dyn, _fthmc_step_dyn with the
    autograd force) on the same draws: the fields within 1e-4 (wrapped),
    dH within 1e-3 (fp32 sums of a few hundred sites and solves at
    1e-12), the accept decisions and charges equal."""
    (xd, qd, md) = ranks[n][0][kind]
    xr, qr, mr = single_steps[0 if kind == "hmc_dyn_step" else 1]
    d = torch.remainder(xd - xr + math.pi, 2 * math.pi) - math.pi
    assert float(d.abs().max()) < 1e-4
    _close(md["dh"], mr.dh, 1e-3)
    np.testing.assert_array_equal(md["acc"].numpy(), mr.acc.numpy())
    _close(qd, qr, 1e-4)


@pytest.mark.parametrize("n", SIZES)
def test_dynamical_drivers(ranks, n):
    """The blocked drivers: every rank's history identical (the shared
    accept draws), the callback after each block, finite dH, 0/1 accepts,
    and one host read an iteration and one in every solve."""
    got = ranks[n]
    assert got[0]["run_seen"] == [3, 4]
    for k in ("run", "ft_run"):
        for r in got[1:]:
            for f in got[0][k]:
                assert torch.equal(r[k][f], got[0][k][f]), (k, f)
        h = got[0][k]
        assert bool(torch.isfinite(h["dh"]).all())
        assert set(np.unique(h["acc"].numpy())) <= {0.0, 1.0}
    assert got[0]["run"]["dh"].shape == (4, 4)
    assert got[0]["ft_run"]["dh"].shape == (2, 2)
    assert set(got[0]["ft_run_reads"]) == {1}


def test_domain_dyn_refuses_mts_hasenbusch_and_odd_shards():
    """The JAX module's refusals, before any collective: multi-timescale,
    Hasenbusch, and eo with an odd number of rows a rank."""
    mesh = Mesh(None, "rows", 0, 4, torch.device("cpu"))
    for cfg in (ts.SchwingerConfig(L=16, n_inner=2, ntraj=2),
                ts.SchwingerConfig(L=16, hasenbusch_dm=0.2, ntraj=2),
                ts.SchwingerConfig(L=12, ntraj=2),
                ts.SchwingerConfig(L=10, eo_precond=False, ntraj=2)):
        with pytest.raises(ValueError):
            pdx.make_domain_hmc_dyn_step(mesh, cfg)
        with pytest.raises(ValueError):
            pdx.run_domain_hmc_dyn_chunked(mesh, cfg)
    with pytest.raises(NotImplementedError):
        pdx.run_domain_fthmc_dyn_chunked(
            mesh, [], FlowSpec(coupling="spline"),
            ts.SchwingerConfig(L=16, ntraj=2))
