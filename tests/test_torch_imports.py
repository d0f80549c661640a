"""The port stands alone: no module of fthmc_tpu_torch, and not
chip_smoke.py, imports jax, orbax or fthmc_tpu; entry points run on the
card unless the caller asks for the CPU; chip_smoke.py refuses to run
without a card or without the package beside it."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from fthmc_tpu_torch import device as tdev
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.config import FlowSpec, LeapfrogConfig
from fthmc_tpu_torch.models.flow import init_flow_params
from fthmc_tpu_torch.weights import load_flow_npz

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "orbax", "fthmc_tpu", "optax", "flax")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_fthmc_tpu():
    files = sorted((ROOT / "fthmc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {mod}"


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    spec = FlowSpec(n_layers=1, coupling="rncp", n_mixture=2,
                    hidden_sizes=(4,))
    g = torch.Generator().manual_seed(0)
    params = init_flow_params(spec, g, device="cpu")
    z = torch.zeros((2, 2, 8, 8))
    q = torch.zeros(2)
    calls = [
        lambda: init_flow_params(spec, g),
        lambda: th.run_fthmc(params, spec, LeapfrogConfig(0.1, 1), beta=1.0,
                             ntraj=1, z0=z, generator=g),
        lambda: th.fthmc_step(params, spec, g, z, q, 1.0, 0.1, 1),
        lambda: th.ft_force(params, spec, z, 1.0),
        lambda: load_flow_npz(),
        lambda: tl.hot_start(g, 2, 8),
        lambda: tdev.resolve_device(None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # and with device="cpu" they run
    assert th.ft_force(params, spec, z, 1.0, device="cpu").shape == z.shape
    assert load_flow_npz(device="cpu")[1].n_layers == 24
    with pytest.raises(ValueError):   # parameters on another device
        th.ft_force(params, spec, z, 1.0, device="meta")


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
