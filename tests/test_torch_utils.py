"""The port's utils (fthmc_tpu_torch.utils) against fthmc_tpu.utils on the
CPU: the logger's strings and MetricsWriter's lines equal JAX's exactly
(torch tensors read as the numpy arrays they hold); therm_arr,
moving_average and drop_nans equal; plotting runs headless; TBWriter
writes, and writes nothing when torch.utils.tensorboard cannot be
imported; profiling.trace writes a Chrome trace that shows a span. With
mirrors of the logger, plotting and table tests of
tests/test_diagnostics.py.
"""
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from fthmc_tpu.utils import logger as jlog
from fthmc_tpu.utils import plotting as jplot
from fthmc_tpu.utils import tboard as jtb
from fthmc_tpu_torch.utils import logger as tlog
from fthmc_tpu_torch.utils import plotting as tplot
from fthmc_tpu_torch.utils import profiling as tprof
from fthmc_tpu_torch.utils import tboard as ttb
from fthmc_tpu_torch.utils.logger import (Logger, MetricsWriter,
                                          format_metrics)

METRICS = {"loss": 0.123456789, "n": 7, "flag": True, "name": "ft",
           "ess": np.asarray([0.1, 0.3]), "one": np.asarray([[2.5]]),
           "big": 12345678.9, "tiny": 1.5e-9, "neg": -0.5}


def _as_torch(m: dict) -> dict:
    return {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in m.items()}


def test_all_match_jax():
    for a, b in ((tlog, jlog), (tplot, jplot), (ttb, jtb)):
        assert a.__all__ == b.__all__
    # JAX's trace, and the samplers' span where JAX has its Timer
    assert tprof.__all__ == ["trace", "span"]


@pytest.mark.parametrize("torch_values", [False, True])
def test_format_metrics_equals_jax(torch_values):
    m = _as_torch(METRICS) if torch_values else METRICS
    assert tlog.format_metrics(m) == jlog.format_metrics(METRICS)
    assert (tlog.format_metrics(m, skip=("name", "n"))
            == jlog.format_metrics(METRICS, skip=("name", "n")))
    hist = {"loss": [0.5, 0.25, 0.125, 1.0], "ess": [np.asarray([1.0, 2.0])]}
    thist = ({"loss": [torch.tensor(v) for v in hist["loss"]],
              "ess": [torch.tensor([1.0, 2.0])]} if torch_values else hist)
    assert (tlog.format_metrics(m, window=3, history=thist)
            == jlog.format_metrics(METRICS, window=3, history=hist))


def test_format_table_and_colors_equal_jax():
    rows = [{"beta": 6.0, "acc": 0.94521, "who": "plain"},
            {"beta": 8.0, "acc": 0.812, "who": "FT", "x": 3}]
    for color in (False, True):
        assert (tlog.format_table(rows, title="t", color=color)
                == jlog.format_table(rows, title="t", color=color))
        assert (tlog.format_table([[1, 2.5], ["a", None]], headers=["x", "y"],
                                  color=color)
                == jlog.format_table([[1, 2.5], ["a", None]],
                                     headers=["x", "y"], color=color))
    for style in ("red", "bold cyan", "nope", "dim"):
        for on in (False, True):
            assert tlog.colorize("s", style, on) == jlog.colorize("s", style,
                                                                  on)


def _strip_stamps(s: str) -> str:
    return re.sub(r"\[\s*\d+\.\d+s\]", "[t]", s)


def test_logger_lines_equal_jax(monkeypatch):
    monkeypatch.delenv("NO_COLOR", raising=False)
    outs = []
    for mod, m in ((tlog, _as_torch(METRICS)), (jlog, METRICS)):
        buf = io.StringIO()
        log = mod.Logger(stream=buf, color=False)
        log.rule("title")
        log.log("hello")
        s = log.print_metrics(m, pre=["step=3"], skip=("name",))
        log.table([{"a": 1.0, "b": "x"}], title="T")
        outs.append((_strip_stamps(buf.getvalue()), s))
    assert outs[0] == outs[1]
    for color in (False, True):
        assert (tlog.Logger(color=color).color
                == jlog.Logger(color=color).color == color)
    monkeypatch.setenv("NO_COLOR", "1")
    assert not tlog.supports_color(sys.stdout)


def test_metrics_writer_lines_equal_jax(tmp_path):
    paths = []
    for mod, m in ((tlog, _as_torch(METRICS)), (jlog, METRICS)):
        path = str(tmp_path / mod.__name__.split(".")[0] / "m.jsonl")
        with mod.MetricsWriter(path) as w:
            w.write(1, m, prefix="training")
            w.write(2, {"a": 1.0, "ragged": [1, [2, 3]], "s": "x"})
        paths.append(path)
    a, b = (open(p).read() for p in paths)
    assert a == b and len(a.splitlines()) == 2


def test_therm_arr_moving_average_drop_nans_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 3))
    for frac, thin in ((0.2, 0), (0.5, 3), (0.0, 1)):
        for got, want in zip(tplot.therm_arr(torch.as_tensor(x), frac, thin),
                             jplot.therm_arr(x, frac, thin)):
            np.testing.assert_array_equal(got, want)
    for w in (1, 3, 15, 60):
        np.testing.assert_array_equal(tplot.moving_average(x[:, 0], w),
                                      jplot.moving_average(x[:, 0], w))
    y = x.copy()
    y[3, 1] = np.nan
    y[7, 0] = np.inf
    for arr in (y, y[:, 0], y.reshape(50, 3, 1)):
        np.testing.assert_array_equal(ttb.drop_nans(torch.as_tensor(arr)),
                                      jtb.drop_nans(arr))


# ------------------- mirrors of tests/test_diagnostics.py (utils part)

def test_metrics_writer_and_format(tmp_path):
    path = os.path.join(str(tmp_path), "m.jsonl")
    with MetricsWriter(path) as w:
        w.write(1, {"loss": 0.5, "ess": torch.tensor([0.1, 0.3])},
                prefix="training")
    lines = [json.loads(ln) for ln in open(path)]
    assert lines[0]["step"] == 1
    assert abs(lines[0]["training/ess"] - 0.2) < 1e-7
    s = format_metrics({"a": 1.23456, "b": np.asarray([2.0, 4.0])})
    assert "a=1.235" in s and "b=3" in s


def test_plotting_headless(tmp_path):
    hist = {"plaq": np.random.rand(50, 3), "acc": torch.rand(50),
            "name": ["a"] * 50}
    out = tplot.plot_history(hist, outdir=str(tmp_path))
    assert os.path.exists(out["plaq"]) and os.path.exists(out["acc"])
    assert "name" not in out
    S = np.random.randn(100) * 2 + 5
    slope, intercept, fname = tplot.plot_action_logq_regression(
        torch.as_tensor(S), -(S + np.random.randn(100) * 0.1),
        outdir=str(tmp_path))
    assert abs(slope - 1.0) < 0.2
    assert os.path.exists(fname)


def test_logger_prints(capsys):
    log = Logger()
    log.rule("hello")
    log.print_metrics({"x": torch.tensor(1.0)})
    out = capsys.readouterr().out
    assert "hello" in out and "x=1" in out


def test_moving_average():
    x = np.arange(10.0)
    y = tplot.moving_average(x, window=3)
    assert len(y) == 8 and abs(y[0] - 1.0) < 1e-12   # mean(0,1,2)
    # shorter-than-window passes through
    assert np.array_equal(tplot.moving_average(x[:2], window=5), x[:2])


def test_live_joint_plot_headless(tmp_path):
    """The live loss/ESS monitor's headless fallback saves a PNG per
    update throttle."""
    lp = tplot.LiveJointPlot(outdir=str(tmp_path), save_every=2)
    loss, ess = [], []
    for i in range(6):
        loss.append(1.0 / (i + 1))
        ess.append(torch.tensor(0.1 * (i + 1)))
        lp.update(loss, ess)
    fname = os.path.join(str(tmp_path), "live_training.png")
    assert os.path.exists(fname)
    # 2D (chain-axis) histories are averaged, longer series still render
    lp.update(np.tile(np.asarray(loss)[:, None], (1, 4)), ess)
    lp.close()


def test_format_table_dict_rows_and_alignment():
    rows = [{"beta": 6.0, "acc": 0.94521, "who": "plain"},
            {"beta": 8.0, "acc": 0.812, "who": "FT"}]
    out = tlog.format_table(rows, title="ladder")
    lines = out.splitlines()
    assert lines[0] == "ladder"
    assert "beta" in lines[2] and "acc" in lines[2] and "who" in lines[2]
    assert "0.9452" in out and "plain" in out      # 4-sig-fig floats
    # all box lines equal width
    widths = {len(ln) for ln in lines[1:]}
    assert len(widths) == 1


def test_format_table_list_rows_requires_headers():
    assert "x" in tlog.format_table([[1, 2]], headers=["x", "y"])
    with pytest.raises(ValueError):
        tlog.format_table([[1, 2]])


def test_color_off_for_non_tty(capsys):
    log = Logger()
    assert not tlog.supports_color(log.stream)      # capsys stream: no tty
    log.log("hello")
    out = capsys.readouterr().out
    assert "\033[" not in out                        # plain fallback
    assert "hello" in out


def test_colorize_respects_enabled_flag():
    assert tlog.colorize("x", "red", enabled=False) == "x"
    assert "\033[31m" in tlog.colorize("x", "red", enabled=True)


def test_logger_table_prints(capsys):
    Logger().table([{"a": 1.0}], title="T")
    out = capsys.readouterr().out
    assert "T" in out and "| a" in out


# ------------------------------------------------- tensorboard, profiler

def test_tbwriter_writes_scalars_and_histograms(tmp_path):
    w = ttb.TBWriter(str(tmp_path))
    assert w._w is not None
    w.write({"acc": torch.tensor([0.5, 1.0]), "traj": 3,
             "plaq": torch.rand(4, 2), "bad": float("nan")}, step=1,
            prefix="ftHMC")
    w.close()
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    ea = EventAccumulator(str(tmp_path))
    ea.Reload()
    assert ea.Tags()["scalars"] == ["ftHMC/acc"]
    assert ea.Scalars("ftHMC/acc")[0].value == pytest.approx(0.75)
    assert ea.Tags()["histograms"] == ["ftHMC/plaq"]


def test_tbwriter_is_a_no_op_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = ttb.TBWriter(str(tmp_path / "tb"))
    assert w._w is None
    w.write({"acc": 1.0}, step=0)
    w.close()
    assert not (tmp_path / "tb").exists()


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(None):
        pass
    with tprof.trace(str(tmp_path / "tr")):
        with tprof.span("fthmc.test"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    (name,) = os.listdir(tmp_path / "tr")
    assert name.startswith(f"trace_{os.getpid()}_") and name.endswith(".json")
    with open(tmp_path / "tr" / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]
    assert "fthmc.test" in names
