"""The port's API facade (fthmc_tpu_torch.api) against fthmc_tpu.api on the
CPU: the same names; the lattice aliases and BatchAction in float64 within
1e-10; the flow and FieldTransformation's action and force (both force
backends: on the CPU 'kernel' runs the kernel chain's plain twins) on one
set of numpy weights (``weights.flow_params_from_numpy``) in float64 within
1e-10, the bound of tests/test_torch_fthmc.py; and mirrors of
tests/test_api.py.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu import api as japi
from fthmc_tpu.config import FlowSpec as JSpec
from fthmc_tpu.config import LeapfrogConfig as JLf
from fthmc_tpu_torch import api
from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
from fthmc_tpu_torch.weights import flow_params_from_numpy

TOL = 1e-10
KW = dict(n_layers=3, coupling="rncp", n_mixture=3, hidden_sizes=(6,),
          s_clip=3.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the ranks run one too): the suite runs in
    several worker processes that share the cores, and OpenMP's parallel
    regions on these small tensors stall when the workers' threads
    outnumber them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(kw, seed, identity=False):
    rng = np.random.default_rng(seed)
    M = kw["n_mixture"]
    out = 2 * M + 1 if kw.get("coupling", "ncp") == "rncp" else M + 1
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
    spec = FlowSpec(**kw)
    return (JSpec(**kw), jax.tree.map(jnp.asarray, tree), spec,
            flow_params_from_numpy(tree, spec, device="cpu", dtype=dtype))


def wrapped_diff(a, b) -> float:
    return float(np.max(np.abs(np.remainder(a - b + math.pi, 2 * math.pi)
                               - math.pi)))


def links(seed, B=4, L=8):
    return np.random.default_rng(seed).uniform(-math.pi, math.pi,
                                                (B, 2, L, L))


def test_all_matches_jax():
    assert api.__all__ == japi.__all__
    for name in api.__all__:
        assert hasattr(api, name), name


# (name, takes beta, batched): the batched names take (B, 2, L, L); the
# JAX package's unbatched ones one configuration (2, L, L)
ALIASES = [("plaq_phase", False, False), ("batch_plaqs", False, True),
           ("batch_charges", False, True), ("batch_action", True, True),
           ("topo_charge", False, False), ("action", True, False),
           ("force", True, False), ("wrap", False, True),
           ("regularize", False, True)]


@pytest.mark.parametrize("name,beta,batched", ALIASES)
def test_lattice_alias_matches_jax(name, beta, batched):
    x = links(1) * (3.0 if name in ("wrap", "regularize") else 1.0)
    x = x if batched else x[0]
    args = (2.5,) if beta else ()
    with jax.enable_x64():
        want = np.asarray(getattr(japi, name)(jnp.asarray(x), *args))
    got = getattr(api, name)(torch.as_tensor(x), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_gauge_transforms_and_plaq_exact():
    x = links(2)
    alpha = np.random.default_rng(3).uniform(0, 2 * math.pi, (8, 8))
    with jax.enable_x64():
        want = np.asarray(japi.gauge_transform(jnp.asarray(x[0]),
                                               jnp.asarray(alpha)))
    got = api.gauge_transform(torch.as_tensor(x[0]), torch.as_tensor(alpha))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    xt = torch.as_tensor(x)
    y = api.random_gauge_transform(torch.Generator().manual_seed(0), xt)
    assert not torch.allclose(y, xt)
    np.testing.assert_allclose(api.batch_action(y, 2.0).numpy(),
                               api.batch_action(xt, 2.0).numpy(), atol=1e-9)
    assert api.PLAQ_EXACT == japi.PLAQ_EXACT


def test_batch_action_matches_jax():
    x = links(4)
    with jax.enable_x64():
        want = np.asarray(japi.BatchAction(3.0)(jnp.asarray(x)))
    got = api.BatchAction(3.0)(torch.as_tensor(x))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_flow_and_facade_match_jax():
    """ft_flow / ft_flow_inv and FieldTransformation's action and force
    (autograd and the kernel chain) against JAX on the same weights."""
    z = links(5)
    with jax.enable_x64():
        jspec, jp, spec, tp = both()
        jz = jnp.asarray(z)
        jft = japi.FieldTransformation(jp, jspec, 2.0, JLf(1.0, 4))
        ref = {"y": np.asarray(japi.ft_flow(jp, jspec, jz)),
               "inv": np.asarray(japi.ft_flow_inv(jp, jspec, jz)),
               "action": np.asarray(jft.action(jz)),
               "force": np.asarray(jft.force(jz))}
    zt = torch.as_tensor(z)
    # angles compared modulo 2 pi; the bisection inverses take the same
    # branch at every halving in both packages (tests/test_torch_flow.py)
    assert wrapped_diff(api.ft_flow(tp, spec, zt).detach().numpy(),
                        ref["y"]) < TOL
    assert wrapped_diff(api.ft_flow_inv(tp, spec, zt).numpy(),
                        ref["inv"]) < TOL
    for backend in ("auto", "autograd", "kernel"):
        ft = api.FieldTransformation(tp, spec, 2.0, LeapfrogConfig(1.0, 4),
                                     force_backend=backend, device="cpu")
        np.testing.assert_allclose(ft.action(zt).detach().numpy(),
                                   ref["action"], rtol=0, atol=TOL)
        np.testing.assert_allclose(ft.force(zt).numpy(), ref["force"],
                                   rtol=0, atol=TOL)
    ft = api.FieldTransformation(tp, spec, 2.0, LeapfrogConfig(1.0, 4),
                                 force_backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="force_backend"):
        ft.force(zt)                  # the port's names, not JAX's


def test_make_flow_matches_jax_shapes():
    params, spec = api.make_flow(torch.Generator().manual_seed(0),
                                 n_layers=3, hidden_sizes=(4, 4),
                                 device="cpu")
    jparams, jspec = japi.make_flow(jax.random.PRNGKey(0), n_layers=3,
                                    hidden_sizes=(4, 4))
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert api.count_parameters(params) == japi.count_parameters(jparams)
    shapes = [[tuple(c[k].shape) for c in net for k in ("w", "b")]
              for net in params]
    jshapes = [[tuple(c[k].shape) for c in net for k in ("w", "b")]
               for net in jparams]
    assert shapes == jshapes


# ----------------------------------------- mirrors of tests/test_api.py

@pytest.fixture(scope="module")
def flow2():
    """A tiny 2-layer ncp flow (the tests' spec2) and its identity twin."""
    kw = dict(n_layers=2, n_mixture=2, hidden_sizes=(4,), kernel_size=3)
    spec = FlowSpec(**kw)
    return (spec,
            flow_params_from_numpy(np_tree(kw, 7), spec, device="cpu"),
            flow_params_from_numpy(np_tree(kw, 7, identity=True), spec,
                                   device="cpu"))


def _x_batch():
    return torch.as_tensor(links(3), dtype=torch.float32)


def test_batch_action_callable():
    act = api.BatchAction(2.0)
    s = act(_x_batch())
    assert s.shape == (4,)


def test_ft_flow_roundtrip(flow2):
    spec, params, _ = flow2
    x = _x_batch()
    y = api.ft_flow(params, spec, x).detach()
    x2 = api.ft_flow_inv(params, spec, y)
    assert float(api.wrap(x2 - x).abs().max()) < 1e-4


def test_field_transformation_facade(flow2):
    spec, _, identity = flow2
    ft = api.FieldTransformation(identity, spec, beta=2.0,
                                 lf=LeapfrogConfig(tau=1.0, nstep=4),
                                 device="cpu")
    z = ft.initializer(torch.Generator().manual_seed(0), 2, 8)
    assert z.shape == (2, 2, 8, 8) and z.device.type == "cpu"
    s = ft.action(z)
    np.testing.assert_allclose(s.detach().numpy(),
                               api.batch_action(z, 2.0).numpy(), rtol=1e-5)
    f = ft.force(z)
    assert f.shape == z.shape
    z1, y1, q1, m = ft.hmc(torch.Generator().manual_seed(1), z)
    assert torch.isfinite(m.dh).all()
    zc = ft.initializer(None, 2, 8, rand=False)
    assert not zc.any()
    z2, hist = ft.run(torch.Generator().manual_seed(2), z, num_trajs=3)
    assert hist.acc.shape == (3, 2) and z2.shape == z.shape


def test_apply_flow_to_prior(flow2):
    spec, params, _ = flow2
    x, z, logq = api.apply_flow_to_prior(
        params, spec, torch.Generator().manual_seed(0), batch_size=4, L=8)
    assert x.shape == (4, 2, 8, 8) and z.shape == (4, 2, 8, 8)
    assert logq.shape == (4,)
    assert torch.isfinite(logq).all()
    y, logdet = api.FieldTransformation(
        params, spec, 2.0, LeapfrogConfig(), device="cpu").flow_forward(z)
    torch.testing.assert_close(x, y)
    prior = api.uniform_link_prior(8, device="cpu")
    torch.testing.assert_close(logq, prior.log_prob(z) - logdet)


def test_facade_defaults_to_the_card(monkeypatch, flow2):
    """Without a card the facade's tensors raise unless device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, params, _ = flow2
    ft = api.FieldTransformation(params, spec, 2.0, LeapfrogConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.initializer(torch.Generator(), 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.make_flow(torch.Generator(), n_layers=1)
