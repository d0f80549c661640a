"""The port's demos (fthmc_tpu_torch.examples) against the JAX package's
``examples/``, on the CPU.

Flag parity: each JAX demo's parser is read by intercepting
``argparse.ArgumentParser.parse_args`` as its ``main`` starts (no JAX
program runs), and every option it has is the port's, with its flags,
default, choices, nargs and type, but for the listed differences: the
port's ``--device`` and run-length flags, the flows' defaults (the
exported ``.npz`` of the same flow where JAX names an orbax directory)
and ``--cg-backend``'s choices and default ('auto' added, the default).
Then each demo at ``--quick --device cpu``, cut further by its flags,
returns finite numbers; and demo_highbeta's flow, read from the ``.npz``,
is the JAX demo's (``load_checkpoint`` of ``artifacts/flow8x8_b3_rncp24``)
on the same z, in float64, to 1e-6.
"""
import argparse
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from fthmc_tpu_torch.examples import demo_2d_u1, demo_highbeta, \
    demo_schwinger
from fthmc_tpu_torch.weights import DATA_DIR

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Parsed(Exception):
    pass


def _jax_parser(name: str, monkeypatch) -> argparse.ArgumentParser:
    """The parser the JAX demo ``name`` builds, caught at its
    parse_args (the demo runs nothing)."""
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed):
            mod.main()
    return seen["parser"]


def _options(parser) -> dict:
    """{dest: (flags, default, choices, nargs, type, const)}, help left
    out."""
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.nargs,
                     a.type, a.const)
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


# the port's own options of each demo (besides --device)
PORT_ONLY = {"demo_2d_u1": set(demo_2d_u1.LENGTHS),
             "demo_highbeta": set(),
             "demo_schwinger": {"ntraj", "chains"}}
PORT = {"demo_2d_u1": demo_2d_u1, "demo_highbeta": demo_highbeta,
        "demo_schwinger": demo_schwinger}


@pytest.mark.parametrize("name", sorted(PORT))
def test_flags_match_the_jax_demo(name, monkeypatch):
    jax_opts = _options(_jax_parser(name, monkeypatch))
    opts = _options(PORT[name].build_parser())
    assert opts.pop("device") == (("--device",), None, None, None, None,
                                  None)
    for dest in PORT_ONLY[name]:
        flags, default, *_ = opts.pop(dest)
        assert default is None and flags == ("--" + dest.replace("_", "-"),)
    if "ckpt" in jax_opts:
        # the same trained flow, exported: <name>.npz for artifacts/<name>
        jflags, jdefault, *jrest = jax_opts.pop("ckpt")
        flags, default, *rest = opts.pop("ckpt")
        assert (flags, rest) == (jflags, jrest)
        assert pathlib.Path(default) == DATA_DIR / (
            pathlib.Path(jdefault).name + ".npz")
        assert pathlib.Path(default).exists()
    if name == "demo_schwinger":
        flags, default, choices, *rest = opts.pop("cg_backend")
        jflags, jdefault, jchoices, *jrest = jax_opts.pop("cg_backend")
        assert (flags, rest) == (jflags, jrest)
        assert (jdefault, default) == ("xla", "auto")
        assert choices == ("auto", *jchoices)
    assert opts == jax_opts


def _finite(d) -> bool:
    """Every number in a (nested) dict is finite."""
    if isinstance(d, dict):
        return all(_finite(v) for v in d.values())
    if isinstance(d, float):
        return math.isfinite(d)
    return True


def test_demo_2d_u1_quick():
    out = demo_2d_u1.main(["--quick", *CPU, "--hmc-ntraj", "16",
                           "--n-era", "1", "--n-epoch", "2",
                           "--ensemble-size", "64", "--ft-ntraj", "4",
                           "--transfer-ntraj", "2"])
    assert set(out) >= {"hmc", "train", "sample", "fthmc", "transfer"}
    assert out["lengths"]["hmc_ntraj"] == 16
    assert _finite({k: out[k] for k in ("hmc", "train", "sample")})
    assert _finite({k: out[k] for k in ("fthmc", "transfer")})
    assert 0.0 <= out["fthmc"]["acc"] <= 1.0
    assert abs(out["hmc"]["plaq"] - out["plaq_exact"]) < 0.1


def test_demo_highbeta_small():
    out = demo_highbeta.main([*CPU, "--L", "8", "--chains", "2", "--ntraj",
                              "4", "--nstep", "2"])
    assert _finite(out) and 0.0 <= out["acc"] <= 1.0
    assert out["therm"] == 1 and out["plaq_exact"] == pytest.approx(0.91236)
    with pytest.raises(FileNotFoundError):
        demo_highbeta.main([*CPU, "--ckpt", str(DATA_DIR / "missing.npz")])


def test_demo_schwinger_quick_with_the_row_sharded_leg():
    """Plain, FT (a small exported flow) and the row-sharded leg on two
    gloo ranks at 4^2; the process-wide CG backend is left as it was."""
    from fthmc_tpu_torch import fermion
    before = fermion._CG_BACKEND
    out = demo_schwinger.main([
        "--quick", *CPU, "--L", "4", "--ntraj", "4", "--chains", "2",
        "--cg-backend", "xla", "--ckpt",
        str(DATA_DIR / "flow8x8_b2_16l.npz"), "--shard-rows", "2"])
    assert fermion._CG_BACKEND == before
    assert out["g5_hermiticity"] <= 1e-8
    for leg in ("plain", "ft", "rows"):
        assert _finite(out[leg]) and 0.0 <= out[leg]["acc"] <= 1.0, leg
    assert math.isfinite(out["pion_asymmetry"])
    with pytest.raises(FileNotFoundError):
        demo_schwinger.main(["--quick", *CPU, "--L", "4", "--ntraj", "1",
                             "--chains", "1", "--ckpt",
                             str(DATA_DIR / "missing.npz")])


def test_demo_schwinger_leaves_out_what_it_cannot_run(capsys):
    """--ckpt '' leaves the FT leg out; --shard-rows that leaves an odd
    number of rows a rank is skipped with the JAX demo's note."""
    out = demo_schwinger.main(["--quick", *CPU, "--L", "4", "--ntraj", "2",
                               "--chains", "1", "--ckpt", "",
                               "--shard-rows", "4"])
    assert out["ft"] is None and out["rows"] is None
    text = capsys.readouterr().out
    assert "FT-HMC leg skipped" in text and "leg skipped" in text


def test_demo_highbeta_flow_is_the_jax_demos():
    """The demo's flow from the .npz and the JAX demo's from orbax map the
    same z alike, in float64, to 1e-6."""
    import jax
    import jax.numpy as jnp
    from fthmc_tpu.checkpoint import load_checkpoint
    from fthmc_tpu.config import FlowSpec as JSpec
    from fthmc_tpu.config import TrainConfig as JTrain
    from fthmc_tpu.models.flow import flow_forward as jflow
    from fthmc_tpu.train import init_train_state
    from fthmc_tpu_torch.models.flow import flow_forward
    jspec = JSpec(n_layers=24, coupling="rncp", n_mixture=8,
                  hidden_sizes=(32, 32), s_clip=3.0)
    state = init_train_state(jax.random.PRNGKey(0),
                             JTrain(L=8, beta=6.0, flow=jspec,
                                    grad_clip=1.0))
    state, _ = load_checkpoint(str(ROOT / "artifacts" / "flow8x8_b3_rncp24"),
                               state)
    params, spec = demo_highbeta.load_flow(demo_highbeta.DEFAULT_CKPT,
                                           device="cpu")
    z = np.random.default_rng(0).uniform(-np.pi, np.pi, (2, 2, 8, 8))
    with jax.enable_x64():
        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    state.params)
        y_j, ld_j = jflow(jp, jnp.asarray(z), jspec)
        y_j, ld_j = np.asarray(y_j), np.asarray(ld_j)
    p64 = [[{k: v.double() for k, v in c.items()} for c in net]
           for net in params]
    y, ld = flow_forward(p64, torch.as_tensor(z), spec)
    np.testing.assert_allclose(y.detach().numpy(), y_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ld.detach().numpy(), ld_j, rtol=1e-6)
