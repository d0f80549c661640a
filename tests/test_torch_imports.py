"""The port stands alone: no module of fthmc_tpu_torch, and no file of the
card suite (the test files marked ``cuda``), imports jax, orbax or
fthmc_tpu; entry points run on the card unless the caller asks for the
CPU."""
import ast
import pathlib
import pytest
import torch

from fthmc_tpu_torch import device as tdev
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import lattice as tl
from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig
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


def _assert_imports_no_jax(files):
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_port_imports_no_jax_and_nothing_of_fthmc_tpu():
    files = sorted((ROOT / "fthmc_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    _assert_imports_no_jax(files)


def _marks_module_cuda(path: pathlib.Path) -> bool:
    """The file sets ``pytestmark = pytest.mark.cuda``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    return any(isinstance(node, ast.Assign)
               and any(getattr(t, "id", None) == "pytestmark"
                       for t in node.targets)
               and ast.unparse(node.value) == "pytest.mark.cuda"
               for node in tree.body)


def test_card_suite_imports_no_jax():
    """The card suite runs on a machine without JAX (``--noconftest -m
    cuda``): no test file marked ``cuda`` imports jax, orbax or
    fthmc_tpu, nor another test file that does."""
    files = sorted(p for p in (ROOT / "tests").glob("test_*.py")
                   if _marks_module_cuda(p))
    names = {p.name for p in files}
    assert {"test_torch_cuda.py", "test_torch_card_samplers.py",
            "test_torch_card_training.py", "test_torch_card_parallel.py",
            "test_torch_card_entry.py"} <= names
    _assert_imports_no_jax(files)
    for path in files:
        for mod in _imported_modules(path):
            if mod.startswith("test_"):
                assert f"{mod}.py" in names, f"{path.name} imports {mod}"


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
        lambda: th.hmc_step(g, z, q, 1.0, 0.1, 1),
        lambda: th.run_hmc(HMCConfig(L=8, ntraj=1, n_chains=2), generator=g),
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


def test_fermion_entry_points_raise_without_cuda(no_cuda):
    """The dynamical-fermion samplers default to the card and raise
    without one; with device='cpu' they run there."""
    from fthmc_tpu_torch import fermion as tf
    from fthmc_tpu_torch import schwinger as ts
    spec = FlowSpec(n_layers=1, coupling="rncp", n_mixture=2,
                    hidden_sizes=(4,))
    params = init_flow_params(spec, torch.Generator().manual_seed(0),
                              device="cpu")
    cfg = ts.SchwingerConfig(L=4, beta=1.0, mass=0.5, tau=0.1, nstep=1,
                             n_chains=2, ntraj=1, cg_maxiter=50)
    x = torch.zeros((2, 2, 4, 4))
    q = torch.zeros(2)
    calls = [
        lambda **kw: ts.hmc_step_dyn(torch.Generator(), x, q, cfg, **kw),
        lambda **kw: ts.run_hmc_dyn(cfg, generator=torch.Generator(), **kw),
        lambda **kw: ts.run_hmc_dyn_chunked(cfg, generator=torch.Generator(),
                                            **kw),
        lambda **kw: ts.fthmc_step_dyn(params, spec, torch.Generator(), x,
                                       q, cfg, **kw),
        lambda **kw: ts.run_fthmc_dyn(params, spec, cfg, z0=x,
                                      generator=torch.Generator(), **kw),
        lambda **kw: ts.run_fthmc_dyn_chunked(params, spec, cfg, z0=x,
                                              generator=torch.Generator(),
                                              **kw),
        lambda **kw: tf.parity_mask((4, 4, 2), 0, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")


def test_training_sampling_and_bench_entry_points_raise_without_cuda(
        no_cuda, tmp_path):
    """The flow-training slice's entry points default to the card and raise
    without one; with device='cpu' they run there."""
    from fthmc_tpu_torch import bench as tb
    from fthmc_tpu_torch import checkpoint as tck
    from fthmc_tpu_torch import sampling as tsm
    from fthmc_tpu_torch import train as tt
    from fthmc_tpu_torch.config import TrainConfig
    from fthmc_tpu_torch.models import priors
    spec = FlowSpec(n_layers=1, coupling="ncp", n_mixture=2,
                    hidden_sizes=(2,))
    cfg = TrainConfig(L=8, n_era=1, n_epoch=1, batch_size=2, flow=spec)
    params = init_flow_params(spec, torch.Generator().manual_seed(0),
                              device="cpu")
    state = tt.init_train_state(torch.Generator(), cfg, device="cpu")
    tck.save_checkpoint(str(tmp_path), state, era=0, epoch=1, train_cfg=cfg)
    sample = dict(beta=1.0, L=8, batch_size=2, num_samples=3)
    calls = [
        lambda **kw: tt.init_train_state(None, cfg, **kw),
        lambda **kw: tt.train(cfg, **kw),
        lambda **kw: tt.anneal_betas(TrainConfig(beta_init=1.0), 0, **kw),
        lambda **kw: tck.load_checkpoint_auto(str(tmp_path), **kw),
        lambda **kw: tsm.make_mcmc_ensemble(
            params, spec, generator=torch.Generator(), **sample, **kw),
        lambda **kw: tsm.generate_ensemble(params, spec, beta=1.0, L=8,
                                           ensemble_size=3, batch_size=2,
                                           **kw),
        lambda **kw: priors.uniform_link_prior(8, **kw),
        lambda **kw: priors.normal_prior((2, 8, 8), **kw),
        lambda **kw: load_flow_npz(name="flow8x8_b2_16l", **kw),
        lambda **kw: tb.bench_train(batch=2, n_layers=1, steps=1, **kw),
        lambda **kw: tb.bench_flow_sampling(n_chains=1, batch_size=2,
                                            n_layers=1, num_samples=3,
                                            repeats=1, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")


def test_probe_and_diagnostics_entry_points_raise_without_cuda(no_cuda):
    """The mobility probe defaults to the card and raises without one;
    with device='cpu' it runs there. The new modules (mobility,
    diagnostics, runner, models/spline) are in the import scan above."""
    from fthmc_tpu_torch import mobility as tm
    for name in ("mobility.py", "diagnostics.py", "runner.py",
                 "models/spline.py"):
        assert (ROOT / "fthmc_tpu_torch" / name).exists()
    kw = dict(L=4, beta=1.0, n_chains=2, ntraj=2, therm=1, tau=0.2, nstep=1,
              call_block=2, sampler="plain")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.mobility_probe(None, None, **kw)
    assert tm.mobility_probe(None, None, device="cpu", **kw)["ntraj"] == 2


def test_entry_modules_raise_without_cuda(no_cuda):
    """The bench entry, entry()/dryrun_multichip() and the three demos
    (in the import scan above) default to the card and raise without
    one, before any work."""
    from fthmc_tpu_torch import bench as tb
    from fthmc_tpu_torch import entry as te
    from fthmc_tpu_torch.examples import (demo_2d_u1, demo_highbeta,
                                          demo_schwinger)
    for name in ("bench.py", "entry.py", "examples/demo_2d_u1.py",
                 "examples/demo_highbeta.py", "examples/demo_schwinger.py"):
        assert (ROOT / "fthmc_tpu_torch" / name).exists()
    calls = [lambda: tb.main([]), te.entry, lambda: te.dryrun_multichip(1),
             lambda: demo_2d_u1.main([]), lambda: demo_highbeta.main([]),
             lambda: demo_schwinger.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
