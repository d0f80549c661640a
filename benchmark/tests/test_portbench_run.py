"""The command line without a card, and a cell, a configuration and a
per-layer metric added as files alone."""
import io
import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import BENCH, REPO


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fthmc16_flagship",
         "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_no_card_exits_non_zero_without_a_result(no_card):
    out = _run(REPO)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""
    assert "no card" in out.stderr


def test_benchmark_alone_exits_non_zero(no_card, tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_config_and_metric_added_as_files(tiny, short_slices):
    """The tiny cells and configurations exist only as files in a folder of
    their own; a metric's reader added there is read in a traced run."""
    (tiny / "metrics" / "blocks_in_slice.py").write_text(
        'UNIT = "blocks"\n\n\ndef read(ctx):\n'
        '    return float(ctx["slice"]["blocks"])\n')
    r = harness.run_cell(tiny, "tiny_hmc", 12345, 0.2, True, "cpu", 0.0,
                         log=io.StringIO())
    assert r["metrics"]["blocks_in_slice"]["value"] >= 1
    # the device metrics find nothing to read on the CPU
    assert set(r["metrics"]) == {"blocks_in_slice"}
    assert r["device"]["window_s"] > 0
    assert r["correct"] and list(r)[-1] == "check"
    json.dumps(r)


def test_window_metrics_on_the_cpu(tiny):
    r = harness.run_cell(tiny, "tiny_hmc", 7, 0.3, False, "cpu", 0.0,
                         log=io.StringIO())
    m = r["metrics"]
    assert set(m) == {"chain_steps_per_s", "block_ms_p95", "acceptance",
                      "setup_s"}
    assert 0 < m["acceptance"]["value"] <= 1
    assert r["attempted"] % 4 == 0


EXTRA_DRIVER = '''"""Plain HMC drawing 3 uniforms of its own before each block's
trajectories, and a reference that replays that draw order."""
import torch

from benchmark.drivers import hmc
from benchmark.reference.sampler import PlainHMC

launches = hmc.launches
EXTRA = 3


class Sampler(hmc.Sampler):
    def run_block(self, callback):
        torch.rand(EXTRA, generator=self.generator, device=self.device)
        super().run_block(callback)


class ExtraDraw(PlainHMC):
    def draws(self, g, x):
        torch.rand(EXTRA, generator=g, device=g.device)
        return super().draws(g, x)


def reference(config, root, device, dtype, allow_tf32=False):
    cls = ExtraDraw if REPLAYS_EXTRA else PlainHMC
    return cls(config["beta"], config["tau"], config["nstep"])
'''


@pytest.mark.parametrize("replays_extra", [True, False])
def test_a_sampler_with_its_own_draw_order(tiny, replays_extra):
    """A sampler whose program draws in another order than the default
    (extra draws before a block's trajectories, as a pseudofermion field
    would be) is added as files alone: its driver's reference replays that
    order, and the harness calls the reference's own replay. Without the
    extra draw in the replay the same run is not correct."""
    (tiny / "drivers" / "hmc_extra.py").write_text(
        EXTRA_DRIVER + f"\n\nREPLAYS_EXTRA = {replays_extra}\n")
    cfg = json.loads((tiny / "configs" / "tiny_hmc.json").read_text())
    cfg.update(name="tiny_extra", sampler="hmc_extra")
    (tiny / "configs" / "tiny_extra.json").write_text(json.dumps(cfg))
    cell = json.loads((tiny / "workloads" / "tiny_hmc.json").read_text())
    cell.update(config="tiny_extra", traffic="tiny_extra")
    (tiny / "workloads" / "tiny_extra.json").write_text(json.dumps(cell))
    r = harness.run_cell(tiny, "tiny_extra", 2 ** 31 + 77, 0.2, False,
                         "cpu", 0.0, log=io.StringIO())
    assert r["correct"] is replays_extra, r["check"]
