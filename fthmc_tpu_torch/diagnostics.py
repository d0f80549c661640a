"""Per-trajectory integrator diagnostics and run-validity checks.

Counterpart of ``fthmc_tpu/diagnostics.py``. ``leapfrog_with_diagnostics``
is ``hmc.leapfrog`` with a per-step trace (force norm, action, momentum
overlap) on whatever device the fields lie on; the reports
(``sanity_report``, ``summarize_step_info``) are computed on the host with
numpy from histories of tensors (``hmc.TrajMetrics``) or of arrays.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from fthmc_tpu_torch.hmc import leapfrog
from fthmc_tpu_torch.lattice import wrap
from fthmc_tpu_torch.models.flow import flow_forward, flow_reverse
from fthmc_tpu_torch.ops.conv import full_fp32

__all__ = ["StepInfo", "leapfrog_with_diagnostics", "summarize_step_info",
           "flow_inverse_residual", "reversibility_error", "sanity_report"]


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _hist_get(hist, name):
    v = getattr(hist, name, None)
    if v is None and hasattr(hist, "get"):
        v = hist.get(name)
    if v is None:
        return None
    a = _host(v)
    return a.reshape(a.shape[0], -1)  # (ntraj, B); one chain -> B = 1


def sanity_report(hist, *, plaq_ref: float | None = None,
                  therm_frac: float = 0.25, acc_floor: float = 0.05,
                  drift_nsigma: float = 5.0, ref_nsigma: float = 5.0,
                  mdh_tol: float = 0.25) -> dict:
    """Run-validity failure detection over per-trajectory metric histories.

    ``hist``: a dict or NamedTuple with (ntraj, B) tensors or arrays among
    {acc, plaq, exp_mdh}; missing keys are skipped. Checks, on the slice
    after ``therm_frac`` of the trajectories:
      - non-finite values in any metric;
      - acceptance collapse (mean acc < acc_floor): the chain is frozen at
        its initial condition;
      - plaquette drift: paired per-chain first-half and second-half means,
        flagged beyond drift_nsigma (cross-chain t statistic; >= 2 chains);
      - the plaquette against a known value (e.g. lattice.PLAQ_EXACT)
        beyond ref_nsigma cross-chain errors;
      - |<exp(-dH)> - 1| > mdh_tol.

    Returns {"ok": bool, "flags": [str, ...], "stats": {...}}: a screen
    for harnesses, not a statistical test.
    """
    flags: list[str] = []
    stats: dict = {}

    acc = _hist_get(hist, "acc")
    plaq = _hist_get(hist, "plaq")
    mdh = _hist_get(hist, "exp_mdh")
    for name, a in (("acc", acc), ("plaq", plaq), ("exp_mdh", mdh)):
        if a is not None and not np.all(np.isfinite(a)):
            flags.append(f"nonfinite:{name}")

    def post(a):
        return a[int(a.shape[0] * therm_frac):]

    if acc is not None and np.all(np.isfinite(acc)):
        m = float(post(acc).mean())
        stats["acc"] = m
        if m < acc_floor:
            flags.append(
                f"acceptance-collapse: mean acc {m:.4f} < {acc_floor} - "
                "the chain is frozen at its initial condition")

    if plaq is not None and np.all(np.isfinite(plaq)):
        p = post(plaq)
        n, B = p.shape
        stats["plaq"] = float(p.mean())
        if n >= 8 and B >= 2:
            h = n // 2
            d = p[:h].mean(axis=0) - p[h:2 * h].mean(axis=0)  # per chain
            derr = float(d.std(ddof=1) / np.sqrt(B))
            tstat = abs(float(d.mean())) / max(derr, 1e-12)
            stats["plaq_drift_sigma"] = tstat
            if tstat > drift_nsigma:
                flags.append(
                    f"plaq-drift: halves differ by {tstat:.1f} sigma - "
                    "not equilibrated over the measured window")
        if plaq_ref is not None and B >= 2:
            cm = p.mean(axis=0)
            err = float(cm.std(ddof=1) / np.sqrt(B))
            pull = abs(float(cm.mean()) - plaq_ref) / max(err, 1e-12)
            stats["plaq_ref_pull"] = pull
            if pull > ref_nsigma:
                flags.append(
                    f"plaq-mismatch: {cm.mean():.5f} vs ref {plaq_ref:.5f} "
                    f"({pull:.1f} sigma by cross-chain error; note the "
                    "error ignores autocorrelation - treat as a screen)")

    if mdh is not None and np.all(np.isfinite(mdh)):
        m = float(post(mdh).mean())
        stats["exp_mdh"] = m
        if abs(m - 1.0) > mdh_tol:
            flags.append(f"exp_mdh-off: <exp(-dH)> = {m:.3f} "
                         "(integration-error accounting suspect)")

    return {"ok": not flags, "flags": flags, "stats": stats}


class StepInfo(NamedTuple):
    force_norm: torch.Tensor   # (nstep, B) ||F|| a chain a step
    action: torch.Tensor       # (nstep, B) S(x) a chain a step
    mom_overlap: torch.Tensor  # (nstep, B) <v0, v> / (|v0| |v|)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((a * a).reshape(a.shape[0], -1).sum(dim=-1))


@torch.no_grad()
def leapfrog_with_diagnostics(x: torch.Tensor, v: torch.Tensor, dt: float,
                              nstep: int, force_fn: Callable,
                              action_fn: Callable):
    """``hmc.leapfrog`` that also returns a per-step StepInfo. force_fn
    and action_fn act on batched (B, ...) states; metrics are per chain,
    stacked on the fields' device."""
    v0 = v
    v0n = _norm(v0)
    x = x + 0.5 * dt * v
    info = []
    for _ in range(nstep):
        f = force_fn(x)
        v = v - dt * f
        ov = (v0 * v).reshape(v.shape[0], -1).sum(dim=-1) / (v0n * _norm(v))
        info.append((_norm(f), action_fn(x), ov))
        x = x + dt * v
    x = x - 0.5 * dt * v
    return x, v, StepInfo(*[torch.stack(t) for t in zip(*info)])


def summarize_step_info(info: StepInfo, drop_frac: float = 0.5) -> dict:
    """Action sigma and RMS force over the last (1 - drop_frac) of the
    steps, and the last step's mean momentum overlap."""
    f = _host(info.force_norm).ravel()
    s = _host(info.action).ravel()
    n0 = int(len(f) * drop_frac)
    f, s = f[n0:], s[n0:]
    return {
        "action_sigma": float(np.sqrt(np.mean((s - s.mean()) ** 2))),
        "rms_force": float(np.sqrt(np.mean(f ** 2))),
        "final_mom_overlap": float(_host(info.mom_overlap)[-1].mean()),
    }


@torch.no_grad()
def flow_inverse_residual(params, spec, y: torch.Tensor, tol: float = 1e-6,
                          max_iter: int = 1000) -> float:
    """Quality of the flow's inverse: max |wrap(f(f^-1(y)) - y)|, the torch
    flow both ways on y's device."""
    x, _ = flow_reverse(params, y, spec, tol=tol, max_iter=max_iter)
    with full_fp32():
        y2, _ = flow_forward(params, x, spec, remat=False)
    return float((wrap(y2 - y)).abs().max())


@torch.no_grad()
def reversibility_error(x, v, dt: float, nstep: int, force_fn) -> float:
    """Integrate forward, flip the momentum, integrate back: max |x2 - x|."""
    x1, v1 = leapfrog(x, v, dt, nstep, force_fn)
    x2, _ = leapfrog(x1, -v1, dt, nstep, force_fn)
    return float((x2 - x).abs().max())
