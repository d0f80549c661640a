"""The port's bench functions run on the CPU at tiny sizes and return the
dicts of fthmc_tpu/bench.py: the same keys (read from the JAX source's
return statements, so no JAX program runs), metric names and units.
bench_fthmc_force_backends names the port's backends: 'autograd' for the
JAX package's 'xla', 'kernel' for its Pallas kernels.

The one-line entry (``python -m fthmc_tpu_torch.bench``, ``main``) against
the JAX package's root bench.py at 8^2 (extras at 4^2): exactly one stdout
line, the JSON object with the keys the JAX script prints (read from its
source); an extra that fails or outlives the watchdog makes it return 1
after that line; it writes no BENCH_extra.json (the JAX package's record),
only the file --extra-json names."""
import ast
import json
import os
import pathlib
import time

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import bench as tb

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_return(name: str) -> tuple[set, str]:
    """(keys of the dict fthmc_tpu/bench.py's ``name`` returns, the fixed
    start of its metric name)."""
    tree = ast.parse((ROOT / "fthmc_tpu" / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ret = next(n.value for n in ast.walk(fn)
               if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    keys = [k.value for k in ret.keys]
    metric = ret.values[keys.index("metric")]
    return set(keys), metric.values[0].value


RENAMED = {"xla_ms": "autograd_ms", "pallas_ms": "kernel_ms",
           "pallas_gated_off": "kernel_gated_off"}

CASES = {
    "bench_hmc_leapfrog": dict(L=4, chains=2, ntraj=2, repeats=1),
    "bench_fthmc_leapfrog": dict(L=4, chains=2, n_layers=1, nstep=2,
                                 ntraj=1, repeats=1),
    "bench_fthmc_flagship": dict(L=4, chains=1, nstep=1, ntraj=1,
                                 repeats=1),
    "bench_fthmc_force_backends": dict(L=4, chains=2, n_layers=2, reps=1),
    "bench_train": dict(batch=4, n_layers=1, steps=2),
    "bench_flow_sampling": dict(n_chains=2, batch_size=4, n_layers=1,
                                num_samples=9, repeats=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bench_function_returns_the_jax_keys(name):
    out = getattr(tb, name)(device="cpu", **CASES[name])
    keys, metric = jax_return(name)
    assert set(out) == {RENAMED.get(k, k) for k in keys}
    assert out["metric"].startswith(metric)
    for k, v in out.items():
        if k in ("value", "vs_baseline", "s_per_traj", "autograd_ms",
                 "kernel_ms", "speedup"):
            assert np.isfinite(v) and v > 0, (k, v)
    if "unit" in out:
        assert out["unit"].endswith("/chip")


def test_run_benchmarks_names_what_it_ran(capsys):
    out = tb.run_benchmarks(L=4, chains=2, which="hmc", device="cpu")
    assert set(out) == {"hmc"}
    assert out["hmc"]["metric"] == "hmc_leapfrog_chain_steps_per_sec_L4"
    assert "hmc_leapfrog" in capsys.readouterr().out


def test_flagship_bench_takes_the_bf16_recipe_by_named_backend():
    """bench_fthmc_flagship passes force_backend to run_fthmc: the bf16
    recipe runs with 'autograd' named, and 'kernel' refuses it (as 'auto'
    does on the card). One intra-op thread, as in test_torch_spline.py:
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _bf16_bench()
    finally:
        torch.set_num_threads(n)


def _bf16_bench():
    kw = dict(L=4, chains=1, nstep=1, ntraj=1, repeats=1, device="cpu",
              conv_dtype="bfloat16")
    out = tb.bench_fthmc_flagship(force_backend="autograd", **kw)
    assert out["conv_dtype"] == "bfloat16" and out["value"] > 0
    with pytest.raises(ValueError, match="conv_dtype"):
        tb.bench_fthmc_flagship(force_backend="kernel", **kw)


# the entry at 8^2, its extras at 4^2 with one chain, one step and one
# trajectory
SMALL = ["--device", "cpu", "--L", "8", "--chains", "2", "--ntraj", "2",
         "--repeats", "1", "--ft-L", "4", "--ft-chains", "1", "--ft-nstep",
         "1", "--ft-ntraj", "1", "--ft-repeats", "1", "--bf16-L", "4",
         "--bf16-chains", "1", "--bf16-ntraj", "1"]


def jax_headline_keys() -> list:
    """The keys of the dict the JAX root bench.py prints (json.dumps)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    call = next(n for n in ast.walk(tree)
                if isinstance(n, ast.Call) and getattr(n.func, "attr", None)
                == "dumps" and isinstance(n.args[0], ast.Dict))
    return [k.value for k in call.args[0].keys]


@pytest.fixture
def entry_cwd(tmp_path, monkeypatch):
    """The entry run in an empty directory with one intra-op thread."""
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def _headline(out: str) -> dict:
    lines = out.splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert list(line) == jax_headline_keys() == list(tb.HEADLINE_KEYS)
    assert line["metric"] == "hmc_leapfrog_chain_steps_per_sec_L8"
    assert line["unit"] == "chain-steps/s/chip" and line["value"] > 0
    return line


def test_entry_prints_one_headline_line(entry_cwd, capsys):
    rc = tb.main(SMALL + ["--extra-json", "extra.json"])
    out = capsys.readouterr()
    assert rc == 0
    line = _headline(out.out)
    assert "flagship FT 4^2 fp32" in out.err
    assert "flagship FT 4^2 bf16" in out.err
    assert sorted(os.listdir(entry_cwd)) == ["extra.json"]
    extra = json.loads((entry_cwd / "extra.json").read_text())
    assert set(extra) == {"headline", "fthmc_flagship_L4",
                          "fthmc_flagship_L4_bf16"}
    assert extra["headline"]["value"] == line["value"]
    assert extra["fthmc_flagship_L4_bf16"]["conv_dtype"] == "bfloat16"


def test_entry_exits_nonzero_when_an_extra_fails(entry_cwd, capsys,
                                                 monkeypatch):
    """A failing extra, then one that outlives the watchdog: the headline
    line is out, the error is on stderr and in the extras record, the
    return is 1, and no BENCH_extra.json appears."""
    def boom(**kw):
        raise RuntimeError("extra made to fail")

    monkeypatch.setattr(tb, "bench_fthmc_flagship", boom)
    assert tb.main(SMALL + ["--extra-json", "extra.json"]) == 1
    out = capsys.readouterr()
    _headline(out.out)
    assert "extra made to fail" in out.err
    extra = json.loads((entry_cwd / "extra.json").read_text())
    assert extra["fthmc_flagship_error"] == "RuntimeError: extra made to fail"
    monkeypatch.setattr(tb, "bench_fthmc_flagship",
                        lambda **kw: time.sleep(30))
    t0 = time.perf_counter()
    assert tb.main(SMALL + ["--timeout", "1"]) == 1
    assert time.perf_counter() - t0 < 20
    out = capsys.readouterr()
    _headline(out.out)
    assert "watchdog" in out.err
    assert sorted(os.listdir(entry_cwd)) == ["extra.json"]
