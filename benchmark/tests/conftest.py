"""Shared fixtures of the benchmark's own tests (CPU; a test that needs the
card is marked ``cuda`` and skips inside the ``card`` fixture)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "benchmark"
# the committed cell whose check each tiny cell takes
CELL_OF = {"tiny_hmc": "hmc64_headline", "tiny_ft": "fthmc16_flagship"}


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One host thread a test process, as a benchmark run has: the tiny
    flows' many small operations slow down many times over when several
    test processes each spread them over every core."""
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def card():
    """The first CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_root(tmp: Path) -> Path:
    """A benchmark root of its own, holding copies of the drivers, metrics
    and data and two tiny cells added as files alone: ``tiny_hmc`` (the
    headline's physics at 8^2, 4 chains, blocks of 3) and ``tiny_ft`` (the
    flagship's at 8^2, 4 chains, blocks of 2, the kernels' plain twins),
    each compared by the numbers, limits and margin of the cell it shrinks
    (``CELL_OF``)."""
    root = tmp / "bench"
    for d in ("drivers", "metrics", "data"):
        shutil.copytree(BENCH / d, root / d)
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    hmc = json.loads((BENCH / "configs" / "hmc_headline_64.json").read_text())
    hmc.update(name="tiny_hmc", L=8)
    ft = json.loads((BENCH / "configs"
                     / "fthmc_flagship_16.json").read_text())
    ft.update(name="tiny_ft", L=8, force_backend="kernel")
    for cfg in (hmc, ft):
        (root / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
    cells = {"tiny_hmc": dict(config="tiny_hmc", chains=4, block=3,
                              therm=6, keep=2),
             "tiny_ft": dict(config="tiny_ft", chains=4, block=2, therm=2,
                             keep=2)}
    for name, c in cells.items():
        check = dict(cell_check(CELL_OF[name]), blocks=c["keep"])
        cell = {"config": c["config"], "traffic": name, "chips": 1,
                "chains": c["chains"], "block": c["block"],
                "therm": c["therm"], "check": check,
                "why": "a tiny cell for the CPU tests"}
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return root


def cell_check(cell: str) -> dict:
    """The ``check`` of a committed cell."""
    return json.loads((BENCH / "workloads" / f"{cell}.json")
                      .read_text())["check"]


@pytest.fixture
def short_slices(monkeypatch):
    """Traced slices of a fifth of a second, for the tiny cells."""
    from benchmark import tracing
    monkeypatch.setattr(tracing, "SLICE_S", 0.2)


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
