"""The plain reference agrees with the port on the CPU at a tiny size: the
flow and its log det and the FT force in float64 on seeded fields, and a
whole run of each sampler's cell through the harness (the port's drivers
on the CPU, their kernels' plain twins)."""
import io
import json

import pytest
import torch

from benchmark import harness
from benchmark.reference.flow import Flow, load_npz
from benchmark.reference.sampler import FlowedHMC

from conftest import BENCH

FLAGSHIP = json.loads((BENCH / "configs" / "fthmc_flagship_16.json")
                      .read_text())


def _port_flow(dtype):
    from fthmc_tpu_torch.config import FlowSpec
    from fthmc_tpu_torch.weights import flow_params_from_numpy
    fl = FLAGSHIP["flow"]
    spec = FlowSpec(n_layers=fl["n_layers"], n_mixture=fl["n_mixture"],
                    hidden_sizes=tuple(fl["hidden_sizes"]),
                    coupling=fl["coupling"], activation=fl["activation"],
                    s_clip=fl["s_clip"])
    tree = load_npz(BENCH / fl["file"], fl["n_layers"], 3)
    return flow_params_from_numpy(tree, spec, device="cpu",
                                  dtype=dtype), spec


def _fields(B=3, L=8, dtype=torch.float64):
    g = torch.Generator().manual_seed(7)
    return (torch.rand((B, 2, L, L), generator=g, dtype=dtype) * 2 - 1) * 1.5


def test_flow_and_log_det_match_the_port():
    from fthmc_tpu_torch.models.flow import flow_forward
    params, spec = _port_flow(torch.float64)
    ref = Flow(FLAGSHIP["flow"], BENCH / FLAGSHIP["flow"]["file"],
               torch.float64, "cpu")
    z = _fields()
    y_p, ld_p = flow_forward(params, z, spec, remat=False)
    y_r, ld_r = ref.forward(z)
    assert torch.allclose(y_p, y_r, atol=1e-10)
    assert torch.allclose(ld_p, ld_r, atol=1e-9)


def test_ft_force_matches_the_port():
    from fthmc_tpu_torch.hmc import ft_force
    params, spec = _port_flow(torch.float64)
    ref = FlowedHMC(Flow(FLAGSHIP["flow"], BENCH / FLAGSHIP["flow"]["file"],
                         torch.float64, "cpu"), 6.0, 0.5, 8)
    z = _fields()
    f_p = ft_force(params, spec, z, 6.0, remat=False, device="cpu")
    f_r = ref.force(z)
    assert (f_p - f_r).abs().max() <= 1e-9 * max(1.0, f_r.abs().max())


def test_plain_force_matches_the_port():
    from fthmc_tpu_torch import lattice
    from benchmark.reference import lattice as rl
    x = _fields(4, 8)
    assert torch.allclose(lattice.force(x, 6.0), rl.force(x, 6.0),
                          atol=1e-12)
    assert torch.allclose(lattice.topo_charge(x), rl.charge(x), atol=1e-12)


@pytest.mark.parametrize("cell", ["tiny_hmc", "tiny_ft"])
def test_a_run_compares_correct(tiny, cell):
    r = harness.run_cell(tiny, cell, 2 ** 33 + 5, 0.2, False, "cpu", 0.0,
                         log=io.StringIO())
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"
    for k, v in r["check"].items():
        assert v["value"] <= v["limit"], k
