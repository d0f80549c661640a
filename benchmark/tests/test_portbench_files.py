"""BENCHMARK.json and the benchmark's files agree, and each file is found
by its name."""
import json
import re

import pytest

from benchmark import harness
from benchmark.check import JUDGED, NUMBERS

from conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = harness.Cell(BENCH, cell)
    assert c.cell["config"] == entry["config"]
    assert c.cell["traffic"] == entry["traffic"]
    assert c.cell.get("chips", 1) == entry["chips"] == 1
    assert c.cell["why"] == entry["why"] and len(entry["why"]) <= 200
    limits = set(c.cell["check"]["limits"])
    assert limits <= set(NUMBERS)
    # a decision margin only where a compared number reads it
    assert ("decision_margin" in c.cell["check"]) == bool(limits & set(JUDGED))
    assert hasattr(c.driver, "Sampler") and hasattr(c.driver, "reference")


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_files(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    assert entry["file"] == f"benchmark/configs/{config}.json"
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["name"] == config and cfg["reduced"] == entry["reduced"]
    assert (BENCH / "drivers" / f"{cfg['sampler']}.py").exists()
    if "flow" in cfg:
        assert (BENCH / cfg["flow"]["file"]).exists()


def test_every_per_layer_metric_has_a_reader():
    readers = harness.Cell(BENCH, SPEC["workloads"][0]["name"]).readers()
    names = {m["name"] for m in SPEC["per_layer"]}
    assert names == set(readers)
    for r in readers.values():
        assert callable(r.read) and r.UNIT
    for m in SPEC["per_layer"]:
        assert m["unit"] == readers[m["name"]].UNIT


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
