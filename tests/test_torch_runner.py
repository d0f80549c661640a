"""fthmc_tpu_torch.runner: a mirror of tests/test_runner.py (the resilient
block + persist + resume runner, and the declarative stage queue), with the
port's step signature step_fn(generator, z, n). A resumed run restores the
generator's state, so it draws exactly what an uninterrupted run draws: the
resume tests hold them bit for bit. A CUDA error is re-raised at once, never
retried."""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fthmc_tpu_torch import runner as tr
from fthmc_tpu_torch.config import HMCConfig
from fthmc_tpu_torch.hmc import run_hmc
from fthmc_tpu_torch.runner import (BlockTimeout, load_queue, queue_status,
                                    run_queue, run_resilient)
from fthmc_tpu_torch.schwinger import SchwingerConfig, run_hmc_dyn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: the suite runs in several
    worker processes that share the cores, and OpenMP's parallel regions on
    these small tensors stall when the workers' threads outnumber them
    (a 1 s probe took 112 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _toy_step(generator, z, n):
    """Deterministic toy chain: z += 1 a 'trajectory'; the per-trajectory
    metrics carry the running counter so resume gaps and overlaps show."""
    base = z[0, 0, 0, 0]
    idx = base + 1.0 + torch.arange(n, dtype=z.dtype)
    h = {"acc": idx[:, None].repeat(1, z.shape[0]),
         "plaq": torch.zeros((n, z.shape[0])),
         "exp_mdh": torch.ones((n, z.shape[0])),
         "q": torch.zeros((n, z.shape[0]))}
    return z + n, h


def test_run_and_history_shapes(tmp_path):
    z0 = torch.zeros((2, 2, 4, 4))
    z, hist, info = run_resilient(
        _toy_step, z0, generator=_gen(), ntraj=10, block=4,
        state_path=str(tmp_path / "s.npz"), max_retries=0)
    assert info["done"] == 10 and info["retries"] == 0
    assert hist["acc"].shape == (10, 2)
    np.testing.assert_allclose(hist["acc"][:, 0], np.arange(1, 11))
    assert float(z[0, 0, 0, 0]) == 10.0


def test_resume_continues_exactly(tmp_path):
    """Stop after 6 of 10 trajectories; a fresh call with the same state
    file continues at 7 with no gap or overlap in the metric stream. With a
    step that draws (plain HMC), the resumed run equals an uninterrupted
    one bit for bit: fields, histories and the generator's state."""
    sp = str(tmp_path / "s.npz")
    z0 = torch.zeros((2, 2, 4, 4))
    run_resilient(_toy_step, z0, generator=_gen(), ntraj=6, block=3,
                  state_path=sp, max_retries=0)
    z, hist, info = run_resilient(
        _toy_step, z0, generator=_gen(), ntraj=10, block=3, state_path=sp,
        max_retries=0)
    assert info["done"] == 10
    np.testing.assert_allclose(hist["acc"][:, 0], np.arange(1, 11))
    assert float(z[0, 0, 0, 0]) == 10.0

    cfg = HMCConfig(beta=2.0, L=4, tau=0.5, nstep=4, n_chains=3)

    def hmc(generator, x, n):
        return run_hmc(dataclasses.replace(cfg, ntraj=n), x0=x,
                       generator=generator, device="cpu")

    x0 = torch.zeros((3, 2, 4, 4))
    sp2 = str(tmp_path / "h.npz")
    g_part = _gen(11)
    run_resilient(hmc, x0, generator=g_part, ntraj=6, block=4,
                  state_path=sp2, max_retries=0)
    g_resumed = _gen(99)               # its state comes from the file
    z_r, h_r, _ = run_resilient(hmc, x0, generator=g_resumed, ntraj=12,
                                block=4, state_path=sp2, max_retries=0)
    g_whole = _gen(11)
    z_w, h_w, _ = run_resilient(hmc, x0, generator=g_whole, ntraj=12,
                                block=4, max_retries=0)
    assert torch.equal(z_r, z_w)
    for k in h_w:
        np.testing.assert_array_equal(h_r[k], h_w[k])
    assert torch.equal(g_resumed.get_state(), g_whole.get_state())


def test_watchdog_fires_and_bounded_retries(tmp_path):
    calls = []

    def hang_step(generator, z, n):
        calls.append(n)
        time.sleep(5)
        return z, {k: torch.zeros((n, z.shape[0]))
                   for k in ("acc", "plaq", "exp_mdh", "q")}

    with pytest.raises(BlockTimeout):
        run_resilient(hang_step, torch.zeros((1, 2, 4, 4)),
                      generator=_gen(), ntraj=2, block=2, block_timeout=1,
                      retry_sleep=0.1, max_retries=2)
    assert len(calls) == 3  # first try + 2 retries, then it raises


def test_failing_step_retries_then_raises():
    calls = []

    def bad_step(generator, z, n):
        calls.append(n)
        raise RuntimeError("device exploded")

    with pytest.raises(RuntimeError):
        run_resilient(bad_step, torch.zeros((1, 2, 4, 4)), generator=_gen(),
                      ntraj=2, block=2, retry_sleep=0.05, max_retries=1)
    assert len(calls) == 2


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: device-side assert triggered"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.AcceleratorError("CUDA error: unspecified launch failure")
    if hasattr(torch, "AcceleratorError") else
    RuntimeError("CUDA error: unspecified launch failure")],
    ids=["assert", "illegal-address", "accelerator-error"])
def test_cuda_error_reraises_at_once(error):
    """A CUDA error poisons the context: under max_retries=None (retry
    forever) it is re-raised on the first failure instead of looping."""
    calls = []

    def step(generator, z, n):
        calls.append(n)
        raise error

    with pytest.raises(type(error), match="CUDA"):
        run_resilient(step, torch.zeros((1, 2, 4, 4)), generator=_gen(),
                      ntraj=2, block=2, retry_sleep=0.0, max_retries=None)
    assert len(calls) == 1


def test_default_sync_waits_for_cpu_tensors():
    """On the CPU the default sync has nothing to wait for; the event
    polling applies to CUDA tensors (tests/test_torch_cuda.py)."""
    tr._default_sync(torch.zeros(3))
    tr._default_sync(np.zeros(3))


def test_real_schwinger_chain_through_runner(tmp_path):
    """The port's dynamical-HMC sampler through the runner: exact physics
    (exp(-dH) ~ 1) and the persisted and returned histories agree."""
    cfg = SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.5, nstep=8,
                          n_chains=4, ntraj=0, cg_tol_force=1e-10,
                          cg_tol_mh=1e-12, cg_maxiter=300)
    sp = str(tmp_path / "s.npz")
    z0 = torch.zeros((4, 2, 4, 4))

    def step(generator, z, n):
        return run_hmc_dyn(dataclasses.replace(cfg, ntraj=n), x0=z,
                           generator=generator, device="cpu")

    z, hist, info = run_resilient(step, z0, generator=_gen(1), ntraj=8,
                                  block=4, state_path=sp, max_retries=0)
    assert hist["acc"].shape == (8, 4)
    assert abs(hist["exp_mdh"].mean() - 1.0) < 0.2
    data = np.load(sp)
    assert int(data["done"]) == 8
    np.testing.assert_allclose(data["q"], hist["q"])


def _q(tmp_path, stages):
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps(
        {"marker_dir": str(tmp_path / "markers"), "stages": stages}))
    return str(qf)


def _touch_cmd(path):
    return [sys.executable, "-c",
            f"open({str(path)!r}, 'w').write('x')"]


def test_queue_runs_and_copies_artifacts(tmp_path):
    out = tmp_path / "out.json"
    dst = tmp_path / "artifacts" / "out.json"
    qf = _q(tmp_path, [{
        "name": "s1", "cmd": _touch_cmd(out), "timeout": 60,
        "cooldown": 0, "artifacts": [[str(out), str(dst)]]}])
    res = run_queue(qf)
    assert res == {"s1": "done"}
    assert dst.read_text() == "x"
    assert (tmp_path / "markers" / "s1.done").exists()


def test_queue_resume_skips_done_stages(tmp_path):
    out = tmp_path / "out.txt"
    qf = _q(tmp_path, [{"name": "s1", "cmd": _touch_cmd(out),
                        "cooldown": 0, "timeout": 60}])
    assert run_queue(qf) == {"s1": "done"}
    out.unlink()                      # if it re-ran, the file would return
    assert run_queue(qf) == {"s1": "done"}
    assert not out.exists()


def test_queue_done_when_counts_prequeue_artifact(tmp_path):
    dw = tmp_path / "already.json"
    dw.write_text("{}")
    boom = [sys.executable, "-c", "raise SystemExit(9)"]
    qf = _q(tmp_path, [{"name": "s1", "cmd": boom, "timeout": 60,
                        "cooldown": 0, "done_when": str(dw)}])
    assert run_queue(qf) == {"s1": "done"}   # never executed the cmd


def test_queue_failure_marks_and_continues(tmp_path):
    out = tmp_path / "second.txt"
    boom = [sys.executable, "-c", "raise SystemExit(1)"]
    qf = _q(tmp_path, [
        {"name": "bad", "cmd": boom, "timeout": 60, "retries": 1,
         "retry_sleep": 0.01, "cooldown": 0},
        {"name": "good", "cmd": _touch_cmd(out), "timeout": 60,
         "cooldown": 0},
    ])
    res = run_queue(qf)
    assert res == {"bad": "failed", "good": "done"}
    assert (tmp_path / "markers" / "bad.failed").exists()
    assert out.exists()
    assert queue_status(qf) == {"bad": "failed", "good": "done"}


def test_queue_abort_on_continue_on_fail_false(tmp_path):
    out = tmp_path / "never.txt"
    boom = [sys.executable, "-c", "raise SystemExit(1)"]
    qf = _q(tmp_path, [
        {"name": "bad", "cmd": boom, "timeout": 60, "retries": 0,
         "cooldown": 0, "continue_on_fail": False},
        {"name": "after", "cmd": _touch_cmd(out), "timeout": 60,
         "cooldown": 0},
    ])
    res = run_queue(qf)
    assert res == {"bad": "failed"}
    assert not out.exists()


def test_queue_clean_removes_stale_state(tmp_path):
    stale = tmp_path / "scan.json"
    stale.write_text("stale")
    # cmd asserts the stale file is gone, then writes fresh output
    cmd = [sys.executable, "-c",
           (f"import os; assert not os.path.exists({str(stale)!r}); "
            f"open({str(stale)!r}, 'w').write('fresh')")]
    qf = _q(tmp_path, [{"name": "s1", "cmd": cmd, "timeout": 60,
                        "cooldown": 0, "clean": [str(stale)]}])
    assert run_queue(qf) == {"s1": "done"}
    assert stale.read_text() == "fresh"


def test_queue_missing_artifact_fails_stage(tmp_path):
    ok = [sys.executable, "-c", "pass"]
    qf = _q(tmp_path, [{"name": "s1", "cmd": ok, "timeout": 60,
                        "retries": 0, "cooldown": 0,
                        "artifacts": [[str(tmp_path / "no.json"),
                                       str(tmp_path / "dst.json")]]}])
    assert run_queue(qf) == {"s1": "failed"}


def test_queue_timeout_reaps_stage(tmp_path):
    slow = [sys.executable, "-c", "import time; time.sleep(30)"]
    qf = _q(tmp_path, [{"name": "s1", "cmd": slow, "timeout": 1,
                        "retries": 0, "cooldown": 0}])
    assert run_queue(qf) == {"s1": "failed"}


def test_queue_only_runs_single_stage(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    qf = _q(tmp_path, [
        {"name": "sa", "cmd": _touch_cmd(a), "timeout": 60, "cooldown": 0},
        {"name": "sb", "cmd": _touch_cmd(b), "timeout": 60, "cooldown": 0},
    ])
    res = run_queue(qf, only="sb")
    assert res["sb"] == "done" and res["sa"] == "pending"
    assert b.exists() and not a.exists()


def test_queue_rejects_duplicate_names_and_str_cmd(tmp_path):
    import pytest
    qf = _q(tmp_path, [{"name": "x", "cmd": ["true"]},
                       {"name": "x", "cmd": ["true"]}])
    with pytest.raises(ValueError):
        load_queue(qf)
    qf2 = _q(tmp_path, [{"name": "x", "cmd": "true"}])
    with pytest.raises(ValueError):
        load_queue(qf2)


# --- plan re-read, depends_on, failed-skip, cwd -----------------------------


def test_queue_rereads_plan_between_stages(tmp_path):
    """A stage appended to the JSON while the master runs is picked up at
    the next stage boundary (no follower process needed)."""
    qf = tmp_path / "q.json"
    s2_out = tmp_path / "s2.txt"
    plan2 = {"marker_dir": str(tmp_path / "markers"), "stages": [
        {"name": "s1", "cmd": ["true"], "timeout": 60, "cooldown": 0},
        {"name": "s2", "cmd": _touch_cmd(s2_out), "timeout": 60,
         "cooldown": 0}]}
    # s1's command rewrites the plan, appending s2
    append = [sys.executable, "-c",
              (f"import json; json.dump({plan2!r}, "
               f"open({str(qf)!r}, 'w'))")]
    qf.write_text(json.dumps(
        {"marker_dir": str(tmp_path / "markers"), "stages": [
            {"name": "s1", "cmd": append, "timeout": 60, "cooldown": 0}]}))
    res = run_queue(str(qf))
    assert res == {"s1": "done", "s2": "done"}
    assert s2_out.exists()


def test_queue_depends_on_moots_child_of_failed_parent(tmp_path):
    out = tmp_path / "child.txt"
    boom = [sys.executable, "-c", "raise SystemExit(1)"]
    qf = _q(tmp_path, [
        {"name": "parent", "cmd": boom, "timeout": 60, "retries": 0,
         "cooldown": 0},
        {"name": "child", "cmd": _touch_cmd(out), "timeout": 60,
         "cooldown": 0, "depends_on": ["parent"]},
        {"name": "orphan", "cmd": _touch_cmd(tmp_path / "o.txt"),
         "timeout": 60, "cooldown": 0, "depends_on": ["no_such_stage"]},
    ])
    res = run_queue(qf)
    assert res == {"parent": "failed", "child": "moot", "orphan": "moot"}
    moot = (tmp_path / "markers" / "child.moot").read_text()
    assert "parent=failed" in moot
    assert not out.exists()
    # durable: a fresh invocation leaves the moot stages alone
    assert queue_status(qf) == {"parent": "failed", "child": "moot",
                                "orphan": "moot"}


def test_queue_depends_on_runs_child_after_parent(tmp_path):
    order = tmp_path / "order.txt"
    mk = (lambda tag: [sys.executable, "-c",
                       f"open({str(order)!r}, 'a').write({tag!r})"])
    qf = _q(tmp_path, [
        {"name": "child", "cmd": mk("c"), "timeout": 60, "cooldown": 0,
         "depends_on": ["parent"]},
        {"name": "parent", "cmd": mk("p"), "timeout": 60, "cooldown": 0},
    ])
    res = run_queue(qf)
    assert res == {"child": "done", "parent": "done"}
    assert order.read_text() == "pc"   # parent ran first despite plan order


def test_queue_failed_stage_skipped_on_rerun(tmp_path):
    """A deterministically failing stage must not re-burn its timeout on
    every invocation: skipped by default, re-run under
    retry_failed."""
    cnt = tmp_path / "count.txt"
    boom = [sys.executable, "-c",
            (f"open({str(cnt)!r}, 'a').write('x'); raise SystemExit(1)")]
    qf = _q(tmp_path, [{"name": "bad", "cmd": boom, "timeout": 60,
                        "retries": 0, "cooldown": 0}])
    assert run_queue(qf) == {"bad": "failed"}
    assert cnt.read_text() == "x"
    assert run_queue(qf) == {"bad": "failed"}      # skipped: no new attempt
    assert cnt.read_text() == "x"
    assert run_queue(qf, retry_failed=True) == {"bad": "failed"}
    assert cnt.read_text() == "xx"                 # explicit retry ran it
    assert run_queue(qf, only="bad") == {"bad": "failed"}
    assert cnt.read_text() == "xxx"                # --only also re-runs


def test_queue_done_when_backfills_marker(tmp_path):
    """done_when satisfaction must write the durable .done marker so the
    verdict survives the artifact."""
    dw = tmp_path / "pre.json"
    dw.write_text("{}")
    boom = [sys.executable, "-c", "raise SystemExit(9)"]
    qf = _q(tmp_path, [{"name": "s1", "cmd": boom, "timeout": 60,
                        "cooldown": 0, "done_when": str(dw)}])
    assert run_queue(qf) == {"s1": "done"}
    marker = tmp_path / "markers" / "s1.done"
    assert marker.exists() and "backfilled" in marker.read_text()
    dw.unlink()                        # artifact gone: marker still rules
    assert queue_status(qf) == {"s1": "done"}


def test_queue_relative_paths_resolve_against_queue_root(tmp_path):
    """Stage cmds run from the queue root (here: explicit "cwd" key) and
    relative clean/artifact/marker paths resolve against it, regardless
    of the master's launch CWD."""
    root = tmp_path / "repo"
    (root / "experiments").mkdir(parents=True)
    (root / "runs").mkdir()
    (root / "runs" / "stale.json").write_text("stale")
    qf = root / "experiments" / "q.json"
    cmd = [sys.executable, "-c",
           ("import os; assert not os.path.exists('runs/stale.json'); "
            "open('runs/out.json', 'w').write('x')")]
    qf.write_text(json.dumps({
        "cwd": "..", "marker_dir": "markers", "stages": [
            {"name": "s1", "cmd": cmd, "timeout": 60, "cooldown": 0,
             "clean": ["runs/stale.json"],
             "artifacts": [["runs/out.json", "artifacts/out.json"]]}]}))
    old = os.getcwd()
    os.chdir(tmp_path)                 # launch from OUTSIDE the root
    try:
        assert run_queue(str(qf)) == {"s1": "done"}
    finally:
        os.chdir(old)
    assert (root / "artifacts" / "out.json").read_text() == "x"
    assert (root / "markers" / "s1.done").exists()


def test_queue_root_autodetect_walks_to_repo_root(tmp_path):
    from fthmc_tpu_torch.runner import _queue_root
    root = tmp_path / "proj"
    (root / "experiments").mkdir(parents=True)
    (root / "pyproject.toml").write_text("")
    assert _queue_root(str(root / "experiments" / "q.json"), {}) == str(root)
    # no pyproject/.git anywhere above: falls back to the file's dir
    bare = tmp_path / "bare"
    bare.mkdir()
    assert _queue_root(str(bare / "q.json"), {}) == str(bare)



def test_queue_root_of_this_repo():
    """A plan file under fthmc_tpu_torch/ resolves to the repository's
    root (its pyproject.toml), where stage commands run."""
    from fthmc_tpu_torch.runner import _queue_root
    root = os.path.dirname(os.path.dirname(os.path.abspath(tr.__file__)))
    assert os.path.exists(os.path.join(root, "pyproject.toml"))
    assert _queue_root(os.path.join(root, "fthmc_tpu_torch", "data",
                                    "q.json"), {}) == root


def test_queue_main_is_the_module_entry_point(tmp_path):
    """python -m fthmc_tpu_torch.runner --queue PLAN runs the plan and
    prints the per-stage status; --status reads it back."""
    out = tmp_path / "out.txt"
    qf = _q(tmp_path, [{"name": "s1", "cmd": _touch_cmd(out),
                        "timeout": 60, "cooldown": 0}])
    root = os.path.dirname(os.path.dirname(os.path.abspath(tr.__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    for args, want in ((["--queue", qf], {"s1": "done"}),
                       (["--queue", qf, "--status"], {"s1": "done"})):
        r = subprocess.run([sys.executable, "-m", "fthmc_tpu_torch.runner",
                            *args], capture_output=True, text=True,
                           timeout=120, env=env, cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout[r.stdout.index("{"):]) == want
    assert out.exists()
