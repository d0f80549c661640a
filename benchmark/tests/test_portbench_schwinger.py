"""The ``schwinger`` configuration and its cell ``schw16_ft``: the files
load, the driver and the reference import nothing of JAX or the JAX
package (the reference nothing of the port either), the CG-tolerance
control and a stale state fail the cell's own limits where the program
passes them, and the two per-layer metrics read the solves of the
driver's ``CGLog``, and nothing where there are none. On the CPU at a tiny
size: 8^2, 4 chains, the frozen flow, the kernels' plain twins."""
import io
import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness

from conftest import BENCH, REPO, cell_check

CELL = "schw16_ft"
FORBIDDEN = {"jax", "jaxlib", "flax", "fthmc_tpu"}


def _tiny_schw(root, **config):
    """A tiny cell ``tiny_schw`` of the configuration in ``root``, compared
    by schw16_ft's numbers, limits and margin; ``config`` overrides the
    configuration's fields."""
    cfg = json.loads((BENCH / "configs" / "schwinger_ft_16.json")
                     .read_text())
    cfg.update(name="tiny_schw", L=8, force_backend="kernel", **config)
    (root / "configs" / "tiny_schw.json").write_text(json.dumps(cfg))
    cell = {"config": "tiny_schw", "traffic": "tiny_schw", "chips": 1,
            "chains": 4, "block": 1, "therm": 2,
            "check": dict(cell_check(CELL), blocks=2),
            "why": "a tiny cell for the CPU tests"}
    (root / "workloads" / "tiny_schw.json").write_text(json.dumps(cell))
    return "tiny_schw"


def test_the_config_and_the_cell_load():
    c = harness.Cell(BENCH, CELL)
    assert c.config["sampler"] == "schwinger"
    assert (c.cell["chains"], c.cell["block"]) == (4096, 1)
    assert c.config["reduced"] == [] and c.config["eo_precond"]
    assert (c.config["cg_backend"], c.config["force_backend"]) == ("auto",
                                                                   "auto")
    assert callable(c.driver.launches)
    flagship = json.loads((BENCH / "configs" / "fthmc_flagship_16.json")
                          .read_text())
    assert c.config["flow"] == flagship["flow"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_driver_and_the_reference_import_nothing_forbidden():
    run = _loaded(
        "import sys\n"
        "from benchmark import harness\n"
        f"harness.Cell(harness.ROOT, {CELL!r}).readers()\n"
        "import fthmc_tpu_torch.schwinger, fthmc_tpu_torch.weights\n"
        "print(*{m.split('.')[0] for m in sys.modules})\n")
    assert "fthmc_tpu_torch" in run and not run & FORBIDDEN
    ref = _loaded(
        "import sys\n"
        "import benchmark.reference.schwinger, benchmark.counts.fermion\n"
        "print(*{m.split('.')[0] for m in sys.modules})\n")
    assert not ref & (FORBIDDEN | {"fthmc_tpu_torch"})


@pytest.mark.parametrize("cg_tol_force", [1e-9, 1e-5])
def test_the_cg_tolerance_control_is_not_correct(tiny, cg_tol_force):
    """The program as configured passes schw16_ft's limits; with the force's
    solves at 1e-5 (the CG-tolerance control) it does not."""
    name = _tiny_schw(tiny, cg_tol_force=cg_tol_force)
    r = harness.run_cell(tiny, name, 2 ** 31 + 5, 0.3, False, "cpu", 0.0,
                         log=io.StringIO())
    assert r["correct"] is (cg_tol_force == 1e-9), r["check"]


def _slice(tiny, name):
    """The traced slice of a tiny cell through the harness, with the
    entries that the driver's ``CG_LOG`` gained over it."""
    cell = harness.Cell(tiny, name)
    sampler = cell.driver.Sampler(cell.config, cell.cell, 17, "cpu",
                                  cell.root)
    tally = harness.Tally(sampler, 0, np.random.default_rng(0))
    tally.block()
    log = getattr(cell.driver, "CG_LOG", None)
    before = {k: len(v) for k, v in log.solves.items()} if log else {}
    window = {"traj": 1, "seconds": 1.0, "chains": sampler.chains,
              "block_median_ms": 1e3}
    metrics, _, sl = harness._traced(cell, sampler, tally, window, False)
    new = ({k: v[before.get(k, 0):] for k, v in log.solves.items()}
           if log else {})
    return metrics, sl, new


def test_cg_iters_per_solve_is_the_logs_mean(tiny, short_slices):
    metrics, sl, new = _slice(tiny, _tiny_schw(tiny))
    solves = [e for v in new.values() for e in v]
    assert len(solves) == sl["traj"] * 9      # 8 force solves and 1 mh
    assert sl["launches"]["cg_solves.force"] == len(new["force"])
    assert sl["launches"]["cg_iters.mh"] == sum(e[0] for e in new["mh"])
    assert metrics["cg_iters_per_solve"]["value"] == pytest.approx(
        sum(e[0] for e in solves) / len(solves), rel=1e-12)
    # K11's share is a device number: nothing to read on the CPU
    assert "k11_roofline_pct" not in metrics


def test_the_metrics_read_nothing_without_the_counters(tiny, short_slices):
    """A cell of another sampler counts no solve, and a Schwinger slice
    without the counters reads nothing either."""
    metrics, sl, _ = _slice(tiny, "tiny_ft")
    assert not any(k.startswith("cg_") for k in sl["launches"])
    assert "cg_iters_per_solve" not in metrics
    readers = harness.Cell(BENCH, CELL).readers()
    cfg = harness.read_json(BENCH / "configs" / "schwinger_ft_16.json")
    ctx = {"config": cfg, "on_card": True, "window": {"chains": 4096},
           "slice": {"kernels": {"cg_kernel": [9, 0.010]},
                     "launches": {"K11": 9}}}
    assert readers["cg_iters_per_solve"].read(ctx) is None
    assert readers["k11_roofline_pct"].read(ctx) is None


def _stale(orig):
    """The step hands back the state it was given, with the readings of the
    state it chose."""
    def step(params, spec, z, *a, **k):
        return (z, *orig(params, spec, z, *a, **k)[1:])
    return step


def test_a_stale_state_is_not_correct(tiny, monkeypatch):
    """A driver that keeps its state while reporting the chains' new
    readings reads ``correct`` false, by ``start_gap`` alone: every
    trajectory it replays is the one the program ran."""
    from fthmc_tpu_torch import schwinger
    monkeypatch.setattr(schwinger, "_fthmc_step_dyn",
                        _stale(schwinger._fthmc_step_dyn))
    r = harness.run_cell(tiny, _tiny_schw(tiny), 2 ** 31 + 5, 0.3, False,
                         "cpu", 0.0, log=io.StringIO())
    assert not r["correct"], r["check"]
    failed = [k for k, v in r["check"].items() if v["value"] > v["limit"]]
    assert failed == ["start_gap"], r["check"]


@pytest.mark.cuda
def test_a_stale_state_is_not_correct_on_the_card(card, monkeypatch):
    """At the cell's own size, through the kernels, a 1 s window."""
    from fthmc_tpu_torch import schwinger
    monkeypatch.setattr(schwinger, "_fthmc_step_dyn",
                        _stale(schwinger._fthmc_step_dyn))
    r = harness.run_cell(harness.ROOT, CELL, 99, 1.0, False, card, 0.0,
                         log=io.StringIO())
    assert not r["correct"], r["check"]


def test_k11_roofline_reads_the_counted_work_over_k11s_time():
    """A slice as the card gives one: 9 solves of 40 iterations at 16^2 x
    4096 chains in 10 ms of ``cg_kernel``."""
    from benchmark.counts import fermion as counts
    from benchmark.counts.work import PEAK_FP32_FLOPS
    reader = harness.Cell(BENCH, CELL).readers()["k11_roofline_pct"]
    cfg = harness.read_json(BENCH / "configs" / "schwinger_ft_16.json")
    name = "void (anonymous namespace)::cg_kernel<false, true, true, float>"
    ctx = {"config": cfg, "on_card": True, "window": {"chains": 4096},
           "slice": {"kernels": {name: [9, 0.010]},
                     "launches": {"K11": 9, "cg_solves.force": 8,
                                  "cg_iters.force": 320, "cg_solves.mh": 1,
                                  "cg_iters.mh": 40}}}
    ops = 360 * 120 * 4096 * 256
    assert counts.k11_bound(4096, 16, 9, 360)["flops"] == ops
    assert reader.read(ctx) == pytest.approx(
        100.0 * ops / PEAK_FP32_FLOPS / 0.010)
    ctx["on_card"] = False
    assert reader.read(ctx) is None
