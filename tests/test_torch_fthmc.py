"""FT-HMC in fthmc_tpu_torch against fthmc_tpu: the effective action and
force (the kernel chain's plain twins and autograd), whole trajectories with
their dH, and port-only exactness checks.

Float64 comparisons to 1e-10 (a few thousand fp64 operations per site
through a 3-layer flow; roundoff ~1e-12). The JAX side is its plain
reference (hmc.ft_force, hmc.omelyan/leapfrog), fed the momenta the port
drew."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import hmc as jh
from fthmc_tpu import lattice as jl
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.models import flow as jf
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.config import FlowSpec as TSpec
from fthmc_tpu_torch.config import LeapfrogConfig
from fthmc_tpu_torch.models.flow import flow_forward
from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel
from fthmc_tpu_torch.weights import flow_params_from_numpy

TOL = 1e-10
PI = math.pi
KW = dict(n_layers=3, coupling="rncp", n_mixture=3, hidden_sizes=(6,),
          s_clip=3.0)


def np_tree(kw, seed, identity=False):
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
        if identity:   # s = r = t = 0: the identity map, logJ = 0
            net[-1] = {k: np.zeros_like(v) for k, v in net[-1].items()}
        tree.append(net)
    return tree


def both(kw=KW, seed=0, identity=False, dtype=torch.float64):
    tree = np_tree(kw, seed, identity)
    tspec = TSpec(**kw)
    return (JSpec(**kw), jax.tree.map(jnp.asarray, tree), tspec,
            flow_params_from_numpy(tree, tspec, device="cpu", dtype=dtype))


def links(seed, B=4, L=8):
    return np.random.default_rng(seed).uniform(-PI, PI, (B, 2, L, L))


def test_ft_action_and_forces_match_jax():
    z = links(1)
    with jax.enable_x64():
        jspec, jp, tspec, tp = both()
        s_ref = np.asarray(jh.ft_action(jp, jspec, jnp.asarray(z), 2.0))
        f_ref = np.asarray(jh.ft_force(jp, jspec, jnp.asarray(z), 2.0))
    zt = torch.as_tensor(z)
    np.testing.assert_allclose(
        th.ft_action(tp, tspec, zt, 2.0).detach().numpy(), s_ref, rtol=0,
        atol=TOL)
    np.testing.assert_allclose(ft_force_kernel(tp, tspec, zt, 2.0).numpy(),
                               f_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        th.ft_force(tp, tspec, zt, 2.0, device="cpu").numpy(), f_ref,
        rtol=0, atol=TOL)


@pytest.mark.parametrize("integrator,backend", [("omelyan", "kernel"),
                                                ("leapfrog", "autograd")])
def test_trajectory_and_dh_match_jax(integrator, backend):
    """fthmc_step from (z, v0): the JAX integrator on the same v0 gives the
    same (z1, v1), and its dH formula (hmc.py:430-435) the same dH."""
    beta, dt, nstep, seed = 2.0, 0.1, 3, 5
    z = links(2)
    zt = torch.as_tensor(z)
    jspec, _, tspec, tp = both(seed=1)
    gen = torch.Generator().manual_seed(seed)
    z_new, y_new, _, m = th.fthmc_step(
        tp, tspec, gen, zt, torch.zeros(4, dtype=torch.float64), beta, dt,
        nstep, integrator=integrator, force_backend=backend, device="cpu")
    v0 = torch.randn(z.shape, generator=torch.Generator().manual_seed(seed),
                     dtype=torch.float64).numpy()
    with jax.enable_x64():
        _, jp, _, _ = both(seed=1)
        integ = jh.omelyan if integrator == "omelyan" else jh.leapfrog
        z1, v1 = integ(jnp.asarray(z), jnp.asarray(v0), dt, nstep,
                       lambda zz: jh.ft_force(jp, jspec, zz, beta))
        z1 = jl.wrap(z1)
        y0, ld0 = jf.flow_forward(jp, jnp.asarray(z), jspec)
        y1, ld1 = jf.flow_forward(jp, z1, jspec)
        dsw = -beta * jnp.sum((jnp.cos(jl.batch_plaqs(y1))
                               - jnp.cos(jl.batch_plaqs(y0))
                               ).reshape(4, -1), axis=-1)
        dh = dsw - (ld1 - ld0) + jh._kinetic_delta(v1, jnp.asarray(v0))
        z1, dh = np.asarray(z1), np.asarray(dh)
    np.testing.assert_allclose(m.dh.numpy(), dh, rtol=0, atol=TOL)
    acc = m.acc.numpy().astype(bool)
    np.testing.assert_allclose(z_new.numpy(),
                               np.where(acc[:, None, None, None], z1, z),
                               rtol=0, atol=TOL)
    y_chk, _ = flow_forward(tp, z_new, tspec)
    np.testing.assert_allclose(y_new.numpy(), y_chk.detach().numpy(),
                               atol=TOL)


@pytest.mark.parametrize("backend", ["kernel", "autograd"])
def test_identity_flow_is_plain_hmc(backend):
    _, _, tspec, tp = both(identity=True)
    x = torch.as_tensor(links(3))
    q0 = tl.topo_charge(x)
    z1, y1, q1, m = th.fthmc_step(tp, tspec, torch.Generator().manual_seed(4),
                                  x, q0, 2.0, 0.1, 5, force_backend=backend,
                                  device="cpu")
    x1, qh, mh = th.hmc_step(torch.Generator().manual_seed(4), x, q0, 2.0,
                             0.1, 5, device="cpu")
    np.testing.assert_allclose(z1.numpy(), x1.numpy(), atol=TOL)
    np.testing.assert_allclose(y1.numpy(), x1.numpy(), atol=TOL)
    for a, b in zip(m, mh):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL)


@pytest.mark.parametrize("backend", ["kernel", "autograd"])
def test_random_flow_is_exact(backend):
    """<exp(-dH)> = 1 in equilibrium for any flow (area preservation and
    reversibility of the latent-space integrator): after 30 thermalizing
    trajectories from a hot start, the mean over 30 trajectories x 16
    chains is held to 5 standard errors (chains and trajectories treated
    as independent)."""
    kw = dict(n_layers=2, coupling="rncp", n_mixture=2, hidden_sizes=(4,),
              s_clip=3.0)
    _, _, tspec, tp = both(kw, seed=7, dtype=torch.float32)
    z0 = tl.hot_start(torch.Generator().manual_seed(1), 16, 8, device="cpu")
    z, hist = th.run_fthmc(tp, tspec, LeapfrogConfig(tau=1.0, nstep=4),
                           beta=2.0, ntraj=60, z0=z0,
                           generator=torch.Generator().manual_seed(2),
                           force_backend=backend, device="cpu")
    e = hist.exp_mdh[30:].flatten()
    assert z.shape == z0.shape and bool(torch.isfinite(e).all())
    sem = float(e.std()) / math.sqrt(e.numel())
    assert abs(float(e.mean()) - 1.0) < 5 * sem
    assert 0.5 < float(hist.acc[30:].mean()) <= 1.0
    assert abs(float(hist.plaq[30:].mean()) - tl.PLAQ_EXACT[2.0]) < 0.03


def test_run_fthmc_chunked_blocks():
    _, _, tspec, tp = both(dtype=torch.float32)
    z0 = torch.as_tensor(links(4), dtype=torch.float32)
    seen = []
    z, hist = th.run_fthmc_chunked(
        tp, tspec, LeapfrogConfig(tau=0.2, nstep=2), beta=2.0, ntraj=5,
        z0=z0, generator=torch.Generator().manual_seed(0), block=3,
        callback=lambda done, h: seen.append(done), device="cpu")
    assert seen == [3, 5]
    assert all(t.shape == (5, 4) and t.device.type == "cpu" for t in hist)


@pytest.mark.parametrize("backend", ["kernel", "autograd"])
def test_run_fthmc_thinned_is_every_thin_th_trajectory(backend):
    """run_fthmc_thinned from the same generator state is run_fthmc's
    history at trajectories thin - 1, 2 thin - 1, ..., the same final
    state, and its summary the exact means over every trajectory."""
    _, _, tspec, tp = both(dtype=torch.float64)
    z0 = torch.as_tensor(links(5))
    lf = LeapfrogConfig(tau=0.3, nstep=3)
    z, hist = th.run_fthmc(tp, tspec, lf, beta=2.0, ntraj=6, z0=z0,
                           generator=torch.Generator().manual_seed(3),
                           force_backend=backend, device="cpu")
    zt, thin_hist, summary = th.run_fthmc_thinned(
        tp, tspec, lf, beta=2.0, ntraj=6, thin=3, z0=z0,
        generator=torch.Generator().manual_seed(3), force_backend=backend,
        device="cpu")
    assert torch.equal(zt, z)
    for full, thin in zip(hist, thin_hist):
        assert thin.shape == (2, 4)
        assert torch.equal(thin, full[2::3])
    for k, t in (("acc", hist.acc), ("plaq", hist.plaq),
                 ("exp_mdh", hist.exp_mdh), ("abs_dh", hist.dh.abs())):
        assert abs(float(summary[k]) - float(t.mean())) < 1e-12
    with pytest.raises(ValueError, match="multiple"):
        th.run_fthmc_thinned(tp, tspec, lf, beta=2.0, ntraj=5, thin=3,
                             z0=z0, generator=torch.Generator(),
                             device="cpu")


def test_resolve_force_backend():
    spec = TSpec(n_layers=1, coupling="rncp", n_mixture=2, hidden_sizes=(4,))
    f32 = torch.float32
    shape = (4, 2, 8, 8)
    assert th.resolve_force_backend("auto", spec, shape, f32, "cpu") == \
        "autograd"
    assert th.resolve_force_backend("auto", spec, shape, f32, "cuda") == \
        "kernel"
    assert th.resolve_force_backend("kernel", spec, shape, f32, "cpu") == \
        "kernel"
    spline = TSpec(n_layers=1, coupling="spline")
    assert th.resolve_force_backend("auto", spline, shape, f32, "cpu") == \
        "autograd"
    assert th.resolve_force_backend("autograd", spline, shape, f32,
                                    "cuda") == "autograd"
    # on the card 'auto' is 'kernel': what the kernels do not take raises
    # under either name instead of running the autograd force
    for bad_spec, bad_shape, dtype in [
            (spline, shape, f32),
            (TSpec(n_layers=1, conv_dtype="bfloat16"), shape, f32),
            (spec, shape, torch.float64),
            (spec, (4, 2, 6, 6), f32)]:
        for backend in ("kernel", "auto"):
            with pytest.raises(ValueError):
                th.resolve_force_backend(backend, bad_spec, bad_shape, dtype,
                                         "cuda")
    # the CPU's plain twins take fp64 fields
    assert th.resolve_force_backend("kernel", spec, shape, torch.float64,
                                    "cpu") == "kernel"
    with pytest.raises(ValueError):
        th.resolve_force_backend("xla", spec, shape, f32, "cpu")
    assert th.resolve_remat("auto", (64, 2, 16, 16)) is False
    assert th.resolve_remat("auto", (128, 2, 128, 128)) is True
