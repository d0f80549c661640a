"""The comparison fails where the timed path is broken underneath, and where
the reference in a lower precision takes the program's place (the
control), each held to the committed cells' own numbers and limits. The
harness runs with the program's step patched: a step that returns its
state unchanged, half of the chains left out (their readings copied from
the other half), and a reading altered where it is produced; on the CPU at
a tiny size, and on the card at the cells' own sizes. The cells run on one
card, so there is no exchange between cards to leave out."""
import io

import pytest
import torch

from benchmark import calibrate, harness

STEP = {"tiny_hmc": "_hmc_step", "tiny_ft": "_fthmc_step",
        "hmc64_headline": "_hmc_step", "fthmc16_flagship": "_fthmc_step"}


def _unchanged(orig):
    def step(generator, x, q_old, *a, **k):
        out = orig(generator, x, q_old, *a, **k)
        return (x,) + tuple(out[1:])
    return step


def _half(orig):
    def step(generator, x, q_old, *a, **k):
        h = x.shape[0] // 2
        out = orig(generator, x[:h], q_old[:h], *a, **k)
        x_new = torch.cat((out[0], x[h:]))
        m = out[-1]
        m = type(m)(*[torch.cat((t, t)) for t in m])
        rest = [torch.cat((t, t)) for t in out[1:-1]]
        return (x_new, *rest, m)
    return step


def _altered(orig):
    """One chain's topological charge off by one unit: a wrong answer, not
    a rounding (a plaquette off by 1e-3 lies inside the headline's
    ``obs_gap`` limit, 0.01)."""
    def step(*a, **k):
        out = orig(*a, **k)
        m = out[-1]
        q = m.q.clone()
        q[0] += 1.0
        return (*out[:-1], m._replace(q=q))
    return step


FAULTS = [_unchanged, _half, _altered]


def _broken_run(monkeypatch, root, cell, fault, seconds, device):
    from fthmc_tpu_torch import hmc
    name = STEP[cell]
    monkeypatch.setattr(hmc, name, fault(getattr(hmc, name)))
    return harness.run_cell(root, cell, 99, seconds, False, device, 0.0,
                            log=io.StringIO())


@pytest.mark.parametrize("cell", ["tiny_hmc", "tiny_ft"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct(tiny, monkeypatch, cell, fault):
    r = _broken_run(monkeypatch, tiny, cell, fault, 0.2, "cpu")
    assert not r["correct"], r["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fthmc16_flagship", "hmc64_headline"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct_on_the_card(card, monkeypatch, cell,
                                                  fault):
    """At the cell's own size, through the kernels, a 1 s window."""
    r = _broken_run(monkeypatch, harness.ROOT, cell, fault, 1.0, card)
    assert not r["correct"], r["check"]


def test_the_bf16_control_fails_the_plain_cell(tiny):
    cell = harness.Cell(tiny, "tiny_hmc")
    row = calibrate.one_seed(cell, 3, 0.2, "cpu", True)
    assert harness.chk.verdict(row["program"], cell.cell["check"]["limits"])
    assert not harness.chk.verdict(row["control"],
                                   cell.cell["check"]["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["fthmc16_flagship", "hmc64_headline"])
def test_the_control_fails_on_the_card(card, workload):
    """At the cell's own size: TF32 convs for the flow, bf16 for the plain
    step."""
    cell = harness.Cell(harness.ROOT, workload)
    row = calibrate.one_seed(cell, 5, 2.0, card, True)
    assert harness.chk.verdict(row["program"], cell.cell["check"]["limits"])
    assert not harness.chk.verdict(row["control"],
                                   cell.cell["check"]["limits"])
