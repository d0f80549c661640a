"""The port's entry points (fthmc_tpu_torch.entry) against the JAX
package's ``__graft_entry__.py``, on the CPU.

``entry()``: JAX's parameters (PRNGKey(0)) and z (PRNGKey(2)) carried into
the port with ``weights.flow_params_from_numpy``; the effective action
S_eff(z) and its force (autograd, and the kernel chain's plain twin) held
to JAX's, and the trajectory of ``fn(*args)`` on the momenta and accept
uniforms JAX draws from its key PRNGKey(1): z', dH, the acceptance and
the charge. Both sides run in fp32 with their own sum orders, so the
bounds are fp32 roundoff grown through a 4-layer flow (a few thousand
operations a site): S_eff within 1e-5 relative, forces within 1e-4 x
max(1, max |F|), z' and the charge within 1e-5, dH within 1e-4 (measured
2.4e-7, 3.3e-6 of a largest |F| of 4.5, 4.8e-7, 7e-7 and 1.1e-5). ``dryrun_multichip(2, device="cpu")`` runs JAX's sequence on two
gloo ranks with JAX's asserts.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import entry as te
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch.ops.coupling_vjp_kernels import ft_force_kernel
from fthmc_tpu_torch.weights import flow_params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _graft():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_entry():
    """JAX's step output, its momenta and uniforms, S_eff and the force at
    z, and the parameter tree and z, as numpy."""
    import jax
    from fthmc_tpu import hmc as jh
    jfn, (jparams, key, jz, jq0) = _graft().entry()
    out = jax.jit(jfn)(jparams, key, jz, jq0)
    kv, ka = jax.random.split(key)
    v0 = jax.random.normal(kv, jz.shape, jz.dtype)
    u = jax.random.uniform(ka, (jz.shape[0],), jz.dtype)
    spec = te.ENTRY_SPEC
    seff = jh.ft_action(jparams, spec, jz, te.ENTRY_BETA)
    force = jh.ft_force(jparams, spec, jz, te.ENTRY_BETA)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return {"z1": np.asarray(out[0]), "y1": np.asarray(out[1]),
            "q1": np.asarray(out[2]),
            "m": {k: np.asarray(v) for k, v in out[3]._asdict().items()},
            "v0": np.asarray(v0), "u": np.asarray(u),
            "seff": np.asarray(seff), "force": np.asarray(force),
            "tree": tree, "z": np.asarray(jz)}


def _port_args(jax_entry):
    fn, (params, gen, z, q0) = te.entry(device="cpu")
    params = flow_params_from_numpy(jax_entry["tree"], te.ENTRY_SPEC,
                                    device="cpu")
    return fn, params, gen, torch.tensor(jax_entry["z"]), q0


def test_entry_spec_is_jax_entry_spec():
    """The step's flow and shapes are the JAX entry's: its FlowSpec, z of
    (4, 2, 8, 8) in (-3, 3), q0 of 4 zeros."""
    import jax
    from fthmc_tpu.config import FlowSpec as JSpec
    jfn, (jparams, _, jz, jq0) = _graft().entry()
    assert dataclasses.asdict(te.ENTRY_SPEC) == dataclasses.asdict(
        JSpec(n_layers=4, n_mixture=2, hidden_sizes=(8, 8)))
    fn, (params, gen, z, q0) = te.entry(device="cpu")
    assert z.shape == jz.shape and q0.shape == jq0.shape
    assert float(z.min()) >= -3.0 and float(z.max()) < 3.0
    assert len(params) == len(jparams) == 4
    for net, jnet in zip(params, jparams):
        for conv, jconv in zip(net, jnet):
            for leaf in ("w", "b"):
                assert conv[leaf].shape == jax.numpy.shape(jconv[leaf])
    _, _, _, m = fn(params, gen, z, q0)
    assert bool(torch.isfinite(m.dh).all())


def test_action_and_force_match_jax(jax_entry):
    _, params, _, z, _ = _port_args(jax_entry)
    spec, beta = te.ENTRY_SPEC, te.ENTRY_BETA
    seff = th.ft_action(params, spec, z, beta).detach().numpy()
    np.testing.assert_allclose(seff, jax_entry["seff"], rtol=1e-5)
    ref = jax_entry["force"]
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    for f in (th.ft_force(params, spec, z, beta, device="cpu"),
              ft_force_kernel(params, spec, z, beta)):
        np.testing.assert_allclose(f.numpy(), ref, rtol=0, atol=tol)


def test_trajectory_matches_jax_on_its_draws(jax_entry, monkeypatch):
    """fn(*args) with JAX's momenta and accept uniforms in place of the
    generator's draws: JAX's z', dH, acceptance and charge."""
    fn, params, gen, z, q0 = _port_args(jax_entry)
    draws = {"normal": torch.tensor(jax_entry["v0"]),
             "uniform": torch.tensor(jax_entry["u"])}
    monkeypatch.setattr(th, "_normal", lambda g, like: draws["normal"])
    monkeypatch.setattr(th, "_uniform", lambda g, like: draws["uniform"])
    z1, y1, q1, m = fn(params, gen, z, q0)
    jm = jax_entry["m"]
    np.testing.assert_allclose(m.dh.numpy(), jm["dh"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(m.acc.numpy(), jm["acc"])
    np.testing.assert_allclose(z1.numpy(), jax_entry["z1"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(q1.numpy(), jax_entry["q1"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(m.plaq.numpy(), jm["plaq"], rtol=0,
                               atol=1e-5)


def test_dryrun_multichip_on_two_gloo_ranks():
    """JAX's dry-run sequence on two gloo ranks: every stage passes its
    asserts (inside the ranks) and reports a finite number."""
    out = te.dryrun_multichip(2, device="cpu")
    assert set(out) == {
        "train_step", "fthmc_step", "domain_fthmc_step", "run_hmc",
        "run_fthmc", "train_era", "domain_hmc", "domain_fthmc",
        "run_hmc_dyn", "run_fthmc_dyn", "domain_hmc_dyn", "domain_fthmc_dyn"}
    assert all(np.isfinite(v) for v in out.values())


def test_entry_points_raise_without_a_card(monkeypatch):
    """Without a card, entry() and dryrun_multichip() raise naming
    device='cpu'; with a card but no process group, more than one rank
    raises naming torchrun and device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (te.entry, lambda: te.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="torchrun.*device='cpu'"):
        te.dryrun_multichip(2)


def test_module_main_runs_entry_then_the_dry_run(monkeypatch, capsys):
    """python -m fthmc_tpu_torch.entry: one step of entry(), then the dry
    run over the group's ranks (one without torchrun)."""
    calls = []
    monkeypatch.setattr(te, "dryrun_multichip",
                        lambda n, device=None: calls.append((n, device)))
    te.main(["--device", "cpu"])
    assert calls == [(1, "cpu")]
    assert capsys.readouterr().out.split() == [
        "entry", "OK", "dryrun_multichip", "OK"]
