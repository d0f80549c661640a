"""The trained flows carried across: each of fthmc_tpu_torch/data's six
npz files against the orbax checkpoint it was exported from, and the
converted flow against fthmc_tpu's forward map."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fthmc_tpu.checkpoint import load_checkpoint_auto
from fthmc_tpu.models.flow import flow_forward as jax_flow_forward
from fthmc_tpu_torch.models.flow import count_parameters, flow_forward
from fthmc_tpu_torch.weights import (DATA_DIR, FLAGSHIP_NPZ, FLOWS,
                                     flow_params_from_numpy, load_flow_npz)

PI = math.pi


@pytest.fixture(scope="module", params=FLOWS)
def orbax_flow(request):
    """(name, the orbax flow's numpy tree, its FlowSpec)."""
    state, _, spec, _ = load_checkpoint_auto(f"artifacts/{request.param}")
    return (request.param, jax.tree_util.tree_map(np.asarray, state.params),
            spec)


def test_npz_equals_orbax_leaf_by_leaf(orbax_flow):
    name, tree, jspec = orbax_flow
    params, spec = load_flow_npz(device="cpu", name=name)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    n_convs = len(spec.hidden_sizes) + 1
    assert len(params) == len(tree) == spec.n_layers
    with np.load(DATA_DIR / f"{name}.npz") as data:
        assert len(data.files) == spec.n_layers * n_convs * 2
    for net_t, net_j in zip(params, tree):
        assert len(net_t) == len(net_j) == n_convs
        for conv_t, conv_j in zip(net_t, net_j):
            for leaf in ("w", "b"):
                assert conv_t[leaf].dtype == torch.float32
                np.testing.assert_array_equal(conv_t[leaf].numpy(),
                                              conv_j[leaf])
    assert count_parameters(params) == sum(
        conv[leaf].size for net in tree for conv in net for leaf in "wb")
    if name == FLAGSHIP_NPZ.stem:
        assert count_parameters(params) == 354456
        assert load_flow_npz(device="cpu")[1] == spec


def test_converted_flow_forward_matches_jax(orbax_flow):
    """fp32 through 12-32 layers at 8^2, 4 chains: the two packages sum in
    other orders, so the bound is fp32 roundoff grown over the stack:
    1e-4 on the wrapped field (2.4e-5 measured at most, over the six flows)
    and 1e-5 * max(1, |logdet|) on logdet."""
    name, tree, jspec = orbax_flow
    params, spec = load_flow_npz(device="cpu", name=name)
    z = np.random.default_rng(0).uniform(-PI, PI, (4, 2, 8, 8)).astype(
        np.float32)
    yj, ldj = jax_flow_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                               jnp.asarray(z), jspec)
    yj, ldj = np.asarray(yj), np.asarray(ldj)
    with torch.no_grad():
        yt, ldt = flow_forward(params, torch.as_tensor(z), spec)
    dy = np.abs(np.remainder(yt.numpy() - yj + PI, 2 * PI) - PI).max()
    assert dy < 1e-4
    np.testing.assert_allclose(ldt.numpy(), ldj, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ldj).max()))


def test_flow_params_from_numpy_checks_shapes(orbax_flow):
    name, tree, _ = orbax_flow
    _, spec = load_flow_npz(device="cpu", name=name)
    with pytest.raises(ValueError):
        flow_params_from_numpy(tree[:3], spec, device="cpu")
    bad = [list(net) for net in tree]
    bad[0][1] = {"w": bad[0][1]["w"][:5], "b": bad[0][1]["b"]}
    with pytest.raises(ValueError):
        flow_params_from_numpy(bad, spec, device="cpu")


def test_load_flow_npz_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown flow"):
        load_flow_npz(device="cpu", name="flow8x8_nonexistent")


@pytest.mark.parametrize("kw,tol", [
    (dict(n_layers=3, coupling="spline", n_knots=6, hidden_sizes=(8,),
          s_clip=3.0), (1e-4, 1e-5)),
    (dict(n_layers=3, coupling="rncp", n_mixture=3, hidden_sizes=(8,),
          s_clip=3.0, conv_dtype="bfloat16"), (1e-2, 1e-1))])
def test_jax_spline_and_bf16_flows_carry_across(tmp_path, kw, tol):
    """A fresh JAX flow of a spec the trained flows do not cover (a spline,
    3K + 1 conditioner outputs; a bf16-conv rncp) written with
    save_flow_npz and read back with load_flow_npz gives JAX's forward on
    fp32 inputs: the spline to fp32 roundoff (1e-4 wrapped, 1e-5 *
    max(1, |logdet|)); the bf16 flow within one bf16 rounding of a conv
    output (0.01, 0.1 * max(1, |logdet|); test_torch_mixed_precision.py)."""
    from fthmc_tpu.config import FlowSpec as JSpec
    from fthmc_tpu.models.flow import init_flow_params as jax_init
    from fthmc_tpu_torch.config import FlowSpec as TSpec
    from fthmc_tpu_torch.weights import save_flow_npz
    jspec = JSpec(**kw)
    jparams = jax_init(jax.random.PRNGKey(4), jspec)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    save_flow_npz(tmp_path / "flow.npz", tree, TSpec(**kw))
    params, spec = load_flow_npz(tmp_path / "flow.npz", device="cpu")
    assert spec == TSpec(**kw)
    z = np.random.default_rng(1).uniform(-PI, PI, (4, 2, 8, 8)).astype(
        np.float32)
    yj, ldj = jax_flow_forward(jparams, jnp.asarray(z), jspec)
    yj, ldj = np.asarray(yj), np.asarray(ldj)
    with torch.no_grad():
        yt, ldt = flow_forward(params, torch.as_tensor(z), spec)
    dy = np.abs(np.remainder(yt.numpy() - yj + PI, 2 * PI) - PI).max()
    assert dy < tol[0]
    np.testing.assert_allclose(ldt.numpy(), ldj, rtol=0,
                               atol=tol[1] * max(1.0, np.abs(ldj).max()))
