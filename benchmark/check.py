"""The comparison that decides ``correct``: blocks of the program's timed
run, drawn from the seed, each started again by the plain reference from
the program's own state at the block's start and the same generator state.

The reference follows the program from the program's own state. HMC chains
are chaotic: a reference in another precision that carried its own state
through a block parts from the program on a few chains within some
trajectories, through no fault of either. So it replays the first
trajectory of each sampled block, and checks the state that the program
hands to the block against the program's own last readings before it.

Over the sampled blocks' chains, the numbers are
  - ``dh_gap``: the largest |dH program - dH reference| / max(1, |dH
    reference|) of the first trajectory (the integrator and its force, the
    energies, and for FT-HMC the flow's log det). Where |dH| > 1 the accept
    probability exp(-dH) moves by the relative error only;
  - ``dh_gap_median``: the median of the same over the chains;
  - ``start_gap``: the largest gap of the plaquette or the charge measured
    on the state handed to a block against the program's last reported
    reading before it;
  - ``obs_gap``: the largest of ``start_gap`` and the plaquette and charge
    gaps after the first trajectory;
  - ``acc_flips``: accept decisions of the first trajectory that differ
    where the reference's decision lies further than the cell's decision
    margin (times max(1, |dH|)) from its threshold (-dH - log u); a chain
    nearer may go either way.
After the first trajectory a chain is compared only where its decision is
judged, so the last two need the cell's ``check.decision_margin``; a cell
without one compares neither. A non-finite reading counts as infinitely
far. A cell's ``check.limits`` names the numbers it compares.
"""
from __future__ import annotations

import math

import torch

NUMBERS = ("dh_gap", "dh_gap_median", "start_gap", "obs_gap", "acc_flips")
JUDGED = ("obs_gap", "acc_flips")     # the numbers that need a margin


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a.double() - b.double()).abs()
    return torch.nan_to_num(d, nan=math.inf)


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def compare(hists: list, prevs: list, ref: dict,
            margin: float | None) -> dict:
    """The numbers of the sampled blocks: ``hists`` the program's histories
    of them ((n, B) CPU tensors dh, acc, plaq, q), ``prevs`` each block's
    last reported plaquette and charge before it, ``ref`` the reference's
    replay of their first trajectories (the reference's ``replay``, the
    blocks' chains in the same order); ``margin`` the cell's decision
    margin, None where it compares no number that needs one."""
    names = [k for k in NUMBERS if margin is not None or k not in JUDGED]
    if not hists:
        return dict.fromkeys(names, math.inf)
    first = {k: torch.cat([getattr(h, k)[0].double() for h in hists])
             for k in ("dh", "acc", "plaq", "q")}
    prev = {k: torch.cat([p[k].double() for p in prevs])
            for k in ("plaq", "q")}
    dh_r = ref["dh"]
    rel = _gap(first["dh"], dh_r) / dh_r.abs().clamp(min=1.0)
    start = torch.maximum(_gap(prev["plaq"], ref["start_plaq"]),
                          _gap(prev["q"], ref["start_q"]))
    out = {"dh_gap": _max(rel), "dh_gap_median": float(rel.median()),
           "start_gap": _max(start)}
    if margin is None:
        return out
    judged = ref["margin"].abs() > margin * dh_r.abs().clamp(min=1.0)
    flips = (first["acc"] != ref["acc"]) & judged
    after = torch.maximum(_gap(first["plaq"], ref["plaq"]),
                          _gap(first["q"], ref["q"]))[judged & ~flips]
    return dict(out, obs_gap=max(_max(start), _max(after)),
                acc_flips=float(flips.sum()))


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell compares at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
