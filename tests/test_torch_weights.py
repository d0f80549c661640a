"""The trained flagship flow carried across: fthmc_tpu_torch/data's npz
against the orbax checkpoint it was exported from, and the converted flow
against fthmc_tpu's forward map."""
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
from fthmc_tpu_torch.weights import (FLAGSHIP_NPZ, flow_params_from_numpy,
                                     load_flow_npz)

PI = math.pi


@pytest.fixture(scope="module")
def orbax_flow():
    state, _, spec, _ = load_checkpoint_auto(
        "artifacts/flow8x8_b3_rncp24_ftb6")
    return jax.tree_util.tree_map(np.asarray, state.params), spec


def test_npz_equals_orbax_leaf_by_leaf(orbax_flow):
    tree, jspec = orbax_flow
    params, spec = load_flow_npz(device="cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert len(params) == len(tree) == 24
    with np.load(FLAGSHIP_NPZ) as data:
        assert len(data.files) == 24 * 6
    for net_t, net_j in zip(params, tree):
        assert len(net_t) == len(net_j) == 3
        for conv_t, conv_j in zip(net_t, net_j):
            for leaf in ("w", "b"):
                assert conv_t[leaf].dtype == torch.float32
                np.testing.assert_array_equal(conv_t[leaf].numpy(),
                                              conv_j[leaf])
    assert count_parameters(params) == 354456


def test_converted_flow_forward_matches_jax(orbax_flow):
    """fp32 through 24 layers at 8^2, 4 chains: the two packages sum in
    other orders, so the bound is fp32 roundoff grown over the stack:
    1e-4 on the wrapped field and 1e-4 * max(1, |logdet|) on logdet."""
    tree, jspec = orbax_flow
    params, spec = load_flow_npz(device="cpu")
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
                               atol=1e-4 * max(1.0, np.abs(ldj).max()))


def test_flow_params_from_numpy_checks_shapes(orbax_flow):
    tree, _ = orbax_flow
    _, spec = load_flow_npz(device="cpu")
    with pytest.raises(ValueError):
        flow_params_from_numpy(tree[:3], spec, device="cpu")
    bad = [list(net) for net in tree]
    bad[0][1] = {"w": bad[0][1]["w"][:5], "b": bad[0][1]["b"]}
    with pytest.raises(ValueError):
        flow_params_from_numpy(bad, spec, device="cpu")
