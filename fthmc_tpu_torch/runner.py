"""Resilient long runs (block, persist, resume, watchdog) and the
declarative stage queue.

Counterpart of ``fthmc_tpu/runner.py``. A long sampler chain advances in
blocks of at most ``block`` trajectories; after every block its whole state
(fields, the generator's state, the trajectory count and the metric
history) is written to ``state_path``, and a restart with the same path
resumes at the last persisted block, drawing exactly what an uninterrupted
run draws. A SIGALRM watchdog bounds each block's wall time (the first
block ``block_timeout``, for kernel builds; later ones 6x their own
measured wall plus a minute) and treats a hang as a retryable failure.

Two rules differ from the JAX package because of the card:
  - the default ``sync`` records a CUDA event and polls it with a short
    sleep: a blocking ``torch.cuda.synchronize()`` cannot be interrupted by
    the alarm (Python runs signal handlers only between bytecodes), so a
    hung block would hang the run;
  - a CUDA error (``torch.AcceleratorError``, or a RuntimeError whose
    message names CUDA) is re-raised at once: it leaves the context
    unusable, and retrying it forever would be a silent endless loop. Every
    other exception is retried as in the JAX package.

The stage queue runs stages as subprocesses and is host code only:
``python -m fthmc_tpu_torch.runner --queue PLAN.json``.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Callable

import numpy as np
import torch

__all__ = ["run_resilient", "BlockTimeout", "run_queue", "queue_status",
           "load_queue", "stage_status"]

_POLL_S = 1e-3      # the default sync's sleep between event queries


class BlockTimeout(Exception):
    """A block exceeded its wall-time budget."""


def _default_sync(z) -> None:
    """Wait for the work that produced z: poll a CUDA event recorded on the
    current stream, sleeping between queries, so that the watchdog's alarm
    can fire while a block hangs. CPU tensors are ready already."""
    if isinstance(z, torch.Tensor) and z.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(z.device))
        while not ev.query():
            time.sleep(_POLL_S)


def _is_cuda_error(e: BaseException) -> bool:
    """A CUDA error: it poisons the context, so no retry can succeed."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def run_resilient(step_fn: Callable, z0: torch.Tensor, *,
                  generator: torch.Generator, ntraj: int, block: int,
                  state_path: str | None = None,
                  hist_fields: tuple[str, ...] = ("acc", "plaq",
                                                  "exp_mdh", "q"),
                  block_timeout: int = 900, retry_sleep: float = 30.0,
                  max_retries: int | None = None, sync=None,
                  on_block: Callable | None = None):
    """Drive ``step_fn`` to ``ntraj`` trajectories with persistence and a
    watchdog.

    step_fn(generator, z, n) -> (z_new, hist), hist holding (n, B) tensors
    or arrays as attributes or dict entries for each name in
    ``hist_fields`` (``hmc.TrajMetrics`` works as it is). Returns (z, hist
    dict of host numpy (ntraj, B) arrays, info dict with done, wall_s,
    s_per_traj and retries for the trajectories advanced in THIS process).

    state_path=None disables persistence. A resume restores z (on z0's
    device), the count, the history and the generator's state.
    max_retries=None retries forever (a CUDA error is never retried); tests
    pass a small bound so a dead step fails loudly.
    """
    if sync is None:
        sync = _default_sync
    z, hist, done = z0, {k: [] for k in hist_fields}, 0
    if state_path and os.path.exists(state_path):
        with np.load(state_path) as data:
            z = torch.as_tensor(data["z"]).to(z0.device)
            generator.set_state(torch.as_tensor(data["generator"]))
            done = int(data["done"])
            hist = {k: list(data[k]) for k in hist_fields}

    def _alarm(signum, frame):
        raise BlockTimeout("block wall-time watchdog fired")

    old_handler = signal.signal(signal.SIGALRM, _alarm)
    t0 = time.time()
    advanced = 0
    block_wall = None
    retries = 0
    try:
        while done < ntraj:
            n = min(block, ntraj - done)
            budget = (block_timeout if block_wall is None
                      else min(block_timeout, int(6 * block_wall) + 60))
            tb = time.time()
            try:
                signal.alarm(budget)
                z_new, h = step_fn(generator, z, n)
                sync(z_new)
                signal.alarm(0)
            except Exception as e:  # BlockTimeout included
                signal.alarm(0)
                if _is_cuda_error(e):
                    raise
                retries += 1
                if max_retries is not None and retries > max_retries:
                    raise
                kind = ("HUNG (watchdog)" if isinstance(e, BlockTimeout)
                        else f"failed ({str(e)[:80]})")
                print(f"  block at {done} {kind}; retry {retries} in "
                      f"{retry_sleep:.0f} s", flush=True)
                time.sleep(retry_sleep)
                continue
            block_wall = time.time() - tb
            z = z_new
            for k in hist_fields:
                v = getattr(h, k) if hasattr(h, k) else h[k]
                hist[k].extend(_host(v))
            done += n
            advanced += n
            if state_path:
                np.savez(state_path, z=_host(z), done=done,
                         generator=generator.get_state().numpy(),
                         **{k: np.asarray(v) for k, v in hist.items()})
            if on_block is not None:
                on_block(done, h)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old_handler)
    wall = time.time() - t0
    info = {"done": done, "wall_s": wall,
            "s_per_traj": wall / advanced if advanced else float("nan"),
            "retries": retries}
    return z, {k: np.asarray(v) for k, v in hist.items()}, info


# ---------------------------------------------------------------------------
# Declarative stage queue: one master that survives machine recycles and
# plan edits. The experiment plan is data (a JSON file committed with the
# repo) and completion is durable (marker files and copied artifacts), so a
# killed machine resumes with the one command
#
#     python -m fthmc_tpu_torch.runner --queue PLAN.json
#
# skipping every stage whose marker (or declared artifact) exists. The plan
# is re-read at every stage boundary, so edits to it reach a running master;
# `depends_on` lets a failed parent moot its children (a durable .moot
# marker says why); stages with a .failed marker are skipped by default
# (re-run with --retry-failed or --only NAME); stage cmds run from the queue
# root whatever the master's working directory, and relative paths in the
# plan (marker_dir, clean, artifacts, done_when) resolve against it.
#
# Stage schema (JSON object per stage):
#   name         unique id; marker file is <marker_dir>/<name>.done
#   cmd          argv list, run with cwd = the queue root (the first
#                ancestor of the queue file containing pyproject.toml or
#                .git, overridable with a queue-level "cwd" key resolved
#                relative to the queue file); inherits env
#   timeout      outer wall bound, seconds (default 3600) — the child
#                harnesses carry their own SIGALRM block watchdogs; this
#                is the last-resort reaper
#   artifacts    list of [src, dst] copies performed on success (dst dirs
#                are created); the stage FAILS if a src is missing
#   done_when    optional path: if it exists and is non-empty the stage is
#                considered already complete (lets pre-queue manual runs
#                count); run_queue then backfills the .done marker so the
#                verdict survives the artifact
#   clean        list of paths removed before every attempt (partial
#                output of a dead attempt would poison the retry)
#   retries      re-runs after failure/timeout (default 1), retry_sleep
#                seconds between (default 90)
#   cooldown     sleep after success (default 30: let the worker settle
#                between device-heavy stages)
#   depends_on   list of stage names that must be 'done' first: a failed/
#                moot/unknown dependency MOOTS this stage (durable .moot
#                marker, never runs); a pending dependency defers it
#   continue_on_fail  default true: record <name>.failed and move on
#                (later stages usually probe different cells); false
#                aborts the queue.

def _now() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def _queue_root(path: str, q: dict) -> str:
    """Directory stage cmds run from and relative plan paths resolve
    against: an explicit queue-level "cwd" (relative to the queue file),
    else the nearest ancestor of the queue file that looks like a repo
    root (pyproject.toml / .git), else the queue file's directory."""
    qdir = os.path.dirname(os.path.abspath(path))
    if "cwd" in q:
        c = q["cwd"]
        return os.path.normpath(c if os.path.isabs(c)
                                else os.path.join(qdir, c))
    d = qdir
    while True:
        if (os.path.exists(os.path.join(d, "pyproject.toml"))
                or os.path.exists(os.path.join(d, ".git"))):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return qdir
        d = parent


def load_queue(path: str) -> dict:
    import json
    with open(path) as f:
        q = json.load(f)
    names = [s["name"] for s in q["stages"]]
    if len(names) != len(set(names)):
        raise ValueError(f"duplicate stage names in {path}")
    for s in q["stages"]:
        if not isinstance(s.get("cmd"), list):
            raise ValueError(f"stage {s.get('name')}: cmd must be an argv list")
        if not isinstance(s.get("depends_on", []), list):
            raise ValueError(
                f"stage {s.get('name')}: depends_on must be a name list")
    root = _queue_root(path, q)
    q["_root"] = root
    mdir = q.get("marker_dir", "artifacts/queue_markers")
    q["marker_dir"] = mdir if os.path.isabs(mdir) else os.path.join(root, mdir)
    return q


def _rp(q: dict, p: str) -> str:
    """Resolve a plan-relative path against the queue root."""
    return p if os.path.isabs(p) else os.path.join(q["_root"], p)


def stage_status(q: dict, stage: dict) -> str:
    """'done' | 'failed' | 'moot' | 'pending' from durable on-disk state."""
    mdir = q["marker_dir"]
    if os.path.exists(os.path.join(mdir, stage["name"] + ".done")):
        return "done"
    dw = stage.get("done_when")
    if dw:
        dw = _rp(q, dw)
        if os.path.exists(dw) and os.path.getsize(dw) > 0:
            return "done"
    if os.path.exists(os.path.join(mdir, stage["name"] + ".failed")):
        return "failed"
    if os.path.exists(os.path.join(mdir, stage["name"] + ".moot")):
        return "moot"
    return "pending"


def _run_stage_once(q: dict, stage: dict, log_path: str) -> bool:
    import subprocess
    for p in stage.get("clean", []):
        p = _rp(q, p)
        if os.path.exists(p):
            os.remove(p)
    timeout = stage.get("timeout", 3600)
    with open(log_path, "a") as log:
        log.write(f"\n=== [{_now()}] {stage['name']}: "
                  f"{' '.join(stage['cmd'])} (timeout {timeout}s, "
                  f"cwd {q['_root']})\n")
        log.flush()
        try:
            rc = subprocess.run(stage["cmd"], stdout=log, stderr=log,
                                timeout=timeout, cwd=q["_root"]).returncode
        except subprocess.TimeoutExpired:
            log.write(f"=== [{_now()}] TIMEOUT after {timeout}s\n")
            return False
        log.write(f"=== [{_now()}] exit {rc}\n")
    if rc != 0:
        return False
    for src, dst in stage.get("artifacts", []):
        src, dst = _rp(q, src), _rp(q, dst)
        if not os.path.exists(src):
            with open(log_path, "a") as log:
                log.write(f"=== missing artifact {src}\n")
            return False
        try:
            os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
            import shutil
            if os.path.isdir(src):
                # checkpoint directories must survive recycles too
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        except OSError as e:
            # a copy failure is a STAGE failure, never a master death
            with open(log_path, "a") as log:
                log.write(f"=== artifact copy failed {src} -> {dst}: "
                          f"{e}\n")
            return False
    return True


def _write_marker(mdir: str, name: str, kind: str, text: str = "") -> None:
    with open(os.path.join(mdir, name + "." + kind), "w") as f:
        f.write(_now() + ("\n" + text if text else "") + "\n")


def _pick_next(q: dict, only, retry_failed, ran: set):
    """Next actionable stage in plan order, or None. Side effects:
    backfills .done markers for done_when-satisfied stages and writes
    .moot markers for children of failed/moot/unknown dependencies."""
    mdir = q["marker_dir"]
    stages = {s["name"]: s for s in q["stages"]}
    for s in q["stages"]:
        name = s["name"]
        if only and name != only:
            continue
        st = stage_status(q, s)
        if st == "done":
            if not os.path.exists(os.path.join(mdir, name + ".done")):
                _write_marker(mdir, name, "done",
                              "backfilled from done_when "
                              + str(s.get("done_when")))
                print(f"[queue] {name}: done_when satisfied, marker "
                      "backfilled", flush=True)
            continue
        if st in ("failed", "moot"):
            if not (retry_failed or only == name) or name in ran:
                continue
            for kind in ("failed", "moot"):
                mk = os.path.join(mdir, name + "." + kind)
                if os.path.exists(mk):
                    os.remove(mk)      # explicit re-run
        if name in ran:
            continue                   # already attempted this invocation
        deps = s.get("depends_on", [])
        dep_st = [stage_status(q, stages[d]) if d in stages else "unknown"
                  for d in deps]
        bad = [f"{d}={st_}" for d, st_ in zip(deps, dep_st)
               if st_ in ("failed", "moot", "unknown")]
        if bad:
            _write_marker(mdir, name, "moot",
                          "MOOT: dependency " + ", ".join(bad))
            print(f"[queue] {name}: MOOT ({', '.join(bad)})", flush=True)
            continue
        if any(st_ != "done" for st_ in dep_st):
            continue                   # dependency still pending: defer
        return s
    return None


def run_queue(path: str, only: str | None = None,
              retry_sleep_default: float = 90.0,
              retry_failed: bool = False) -> dict:
    """Execute a stage-queue file; returns {name: status}. Safe to re-run:
    completed stages (durable markers / done_when artifacts) are skipped,
    so a recycled machine resumes with the same command. The plan JSON is
    re-read before every stage, so edits to it land on a running master;
    failed stages are skipped unless retry_failed (or --only NAME)."""
    ran: set[str] = set()
    aborted = False
    last_good: dict | None = None
    while not aborted:
        # re-read: plan edits take effect here. A torn/invalid edit must
        # not kill the long-lived master — retry briefly, then fall back
        # to the last good plan.
        q, err = None, None
        for attempt in range(3):
            try:
                q = load_queue(path)
                last_good = q
                break
            except Exception as e:
                err = e
                print(f"[queue] plan re-read failed ({e}); "
                      f"{'retrying' if attempt < 2 else 'using last-good'}",
                      flush=True)
                time.sleep(5)
        if q is None:
            if last_good is None:
                raise err
            q = last_good
        os.makedirs(q["marker_dir"], exist_ok=True)
        stage = _pick_next(q, only, retry_failed, ran)
        if stage is None:
            break
        name = stage["name"]
        ran.add(name)
        log_path = os.path.join(q["marker_dir"], name + ".log")
        attempts = 1 + int(stage.get("retries", 1))
        ok = False
        for attempt in range(attempts):
            print(f"[queue] {name}: attempt {attempt + 1}/{attempts} "
                  f"({_now()})", flush=True)
            ok = _run_stage_once(q, stage, log_path)
            if ok:
                break
            if attempt + 1 < attempts:
                time.sleep(stage.get("retry_sleep", retry_sleep_default))
        _write_marker(q["marker_dir"], name, "done" if ok else "failed")
        print(f"[queue] {name}: {'DONE' if ok else 'FAILED'}", flush=True)
        if ok:
            time.sleep(stage.get("cooldown", 30))
        elif not stage.get("continue_on_fail", True):
            print("[queue] aborting (continue_on_fail=false)", flush=True)
            aborted = True
    q = load_queue(path)
    results = {}
    for s in q["stages"]:
        results[s["name"]] = stage_status(q, s)
        if aborted and s["name"] == name:
            break                      # truncated at the aborting stage
    return results


def queue_status(path: str) -> dict:
    q = load_queue(path)
    return {s["name"]: stage_status(q, s) for s in q["stages"]}


def _queue_main(argv=None):
    import argparse
    import json
    p = argparse.ArgumentParser(
        description="Declarative experiment stage queue (resumable)")
    p.add_argument("--queue", required=True, help="queue JSON file")
    p.add_argument("--status", action="store_true",
                   help="print per-stage status and exit")
    p.add_argument("--only", default=None, help="run a single stage")
    p.add_argument("--retry-failed", action="store_true",
                   help="re-attempt stages with .failed/.moot markers")
    args = p.parse_args(argv)
    if args.status:
        print(json.dumps(queue_status(args.queue), indent=1))
        return
    results = run_queue(args.queue, only=args.only,
                        retry_failed=args.retry_failed)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    _queue_main()
