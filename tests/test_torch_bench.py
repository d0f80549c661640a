"""The port's bench functions run on the CPU at tiny sizes and return the
dicts of fthmc_tpu/bench.py: the same keys (read from the JAX source's
return statements, so no JAX program runs), metric names and units.
bench_fthmc_force_backends names the port's backends: 'autograd' for the
JAX package's 'xla', 'kernel' for its Pallas kernels."""
import ast
import pathlib

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
