"""The samplers' phase spans (``fthmc_tpu_torch.utils.profiling.span``) on
the CPU: with no profiler running no ``record_function`` is ever made on
the step's path, and under ``torch.profiler`` each trajectory of plain HMC
(every backend the CPU runs as a plain twin) and of FT-HMC (the kernel
chain's plain twins, a tiny random rncp flow) is one ``fthmc.step`` span
holding its phases, nested and in order. The dynamical FT-HMC step holds
the same phases and, inside them, the fermion spans; its spans and a
``CGLog`` change neither its results nor its reads of the device's state
to the host."""
from collections import Counter

import pytest
import torch

from fthmc_tpu_torch import fermion
from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch import schwinger as ts
from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig
from fthmc_tpu_torch.models.flow import init_flow_params

NTRAJ, BLOCK = 3, 2
PLAIN = ["momenta", "integrate", "accept", "energy", "observe"]
FUSED = ["momenta", "integrate", "accept", "observe"]
FLOWED = ["momenta", "energy", "integrate", "energy", "accept", "observe"]
RUNS = {"xla": PLAIN, "fused": FUSED, "fused_hostrng": FUSED, "ft": FLOWED}
DYN_NSTEP = 2       # Omelyan steps of the dynamical runs: two solves each


def _run(kind, cg_log=None):
    """NTRAJ trajectories in blocks of BLOCK through a chunked driver."""
    g = torch.Generator().manual_seed(3)
    if kind == "dyn":
        spec = FlowSpec(n_layers=2, coupling="rncp", n_mixture=2,
                        hidden_sizes=(4,), s_clip=3.0)
        params = init_flow_params(spec, g, device="cpu")
        z0 = torch.rand((2, 2, 4, 4), generator=g) * 2.0 - 1.0
        cfg = ts.SchwingerConfig(L=4, beta=2.0, mass=0.3, tau=0.2,
                                 nstep=DYN_NSTEP, n_chains=2, ntraj=NTRAJ)
        return ts.run_fthmc_dyn_chunked(
            params, spec, cfg, block=BLOCK, z0=z0, generator=g,
            force_backend="kernel", device="cpu", cg_log=cg_log)
    if kind == "ft":
        spec = FlowSpec(n_layers=2, coupling="rncp", n_mixture=2,
                        hidden_sizes=(4,), s_clip=3.0)
        params = init_flow_params(spec, g, device="cpu")
        z0 = torch.rand((2, 2, 4, 4), generator=g) * 2.0 - 1.0
        return th.run_fthmc_chunked(
            params, spec, LeapfrogConfig(tau=0.2, nstep=2), beta=2.0,
            ntraj=NTRAJ, z0=z0, generator=g, block=BLOCK,
            integrator="omelyan", force_backend="kernel", device="cpu")
    cfg = HMCConfig(beta=2.0, L=4, tau=0.5, nstep=2, ntraj=NTRAJ,
                    n_chains=2, randinit=True, seed=5)
    return th.run_hmc_chunked(cfg, block=BLOCK, generator=g, backend=kind,
                              device="cpu")


@pytest.mark.parametrize("kind", ["xla", "ft", "dyn"])
def test_no_record_function_without_a_profiler(kind, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler on")
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        refuse)
    _, hist = _run(kind)
    assert hist.acc.shape == (NTRAJ, 2)


def _spans(events):
    """(start, end, name) of every ``fthmc.`` span, in start order."""
    return sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in events if e.name().startswith("fthmc.")),
                  key=lambda s: (s[0], -s[1]))


@pytest.mark.parametrize("kind", list(RUNS))
def test_each_trajectory_is_one_step_span_with_its_phases(kind):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _run(kind)
    spans = _spans(prof.profiler.kineto_results.events())
    steps = [s for s in spans if s[2] == "fthmc.step"]
    assert len(steps) == NTRAJ
    inside = 0
    for a, b, _ in steps:
        kids = [s for s in spans if s[2] != "fthmc.step"
                and a <= s[0] and s[1] <= b]
        assert [n for _, _, n in kids] == [f"fthmc.step.{p}"
                                           for p in RUNS[kind]]
        assert all(k0[1] <= k1[0] for k0, k1 in zip(kids, kids[1:]))
        inside += len(kids)
    assert inside == len(spans) - NTRAJ     # no span outside a step


def _inside(spans, outer):
    a, b = outer[0], outer[1]
    return [s for s in spans if s is not outer and a <= s[0] and s[1] <= b]


def test_each_dynamical_trajectory_holds_its_phases_and_fermion_spans():
    """FT-HMC with dynamical fermions: each trajectory one ``fthmc.step``
    with FT-HMC's phases; the heatbath in the first energy, a solve and a
    force for each of the integrator's 2 nstep forces, the Metropolis
    solve in the second energy; no fermion span outside a phase."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _run("dyn")
    spans = _spans(prof.profiler.kineto_results.events())
    steps = [s for s in spans if s[2] == "fthmc.step"]
    assert len(steps) == NTRAJ
    want = {1: ["fthmc.fermion.refresh"],
            2: ["fthmc.fermion.solve", "fthmc.fermion.force"] * 2 * DYN_NSTEP,
            3: ["fthmc.fermion.solve"]}
    for step in steps:
        phases = [s for s in _inside(spans, step)
                  if s[2].startswith("fthmc.step.")]
        assert [n for _, _, n in phases] == [f"fthmc.step.{p}"
                                             for p in FLOWED]
        for i, phase in enumerate(phases):
            assert [n for _, _, n in _inside(spans, phase)] \
                == want.get(i, [])
    fermion_spans = [s for s in spans if s[2].startswith("fthmc.fermion.")]
    assert len(fermion_spans) == NTRAJ * (2 + 4 * DYN_NSTEP)


HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__")


@pytest.mark.parametrize("cg_backend", ["xla", "fused"])
def test_spans_and_cg_counters_add_no_host_read(cg_backend, monkeypatch):
    """The dynamical FT-HMC run three times: as it is, with a ``CGLog``
    counting its solves and iterations, and with the log under a profiler
    (every span open). The same calls that read a tensor to the host and
    the same results bit for bit; both logs hold the same solves and the
    same ``CGLog.reads()``."""
    monkeypatch.setattr(fermion, "_CG_BACKEND", cg_backend)
    reads = Counter()
    for name in HOST_READS:
        def counted(self, *a, _orig=getattr(torch.Tensor, name), _name=name,
                    **k):
            reads[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)

    def once(log=None):
        reads.clear()
        z, hist = _run("dyn", cg_log=log)
        return dict(reads), z, hist

    plain = once()
    log = fermion.CGLog()
    counted = once(log)
    assert log.count() == NTRAJ * (2 * DYN_NSTEP + 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans_log = fermion.CGLog()
        spans = once(spans_log)
    assert spans_log.solves == log.solves
    assert spans_log.reads() == log.reads()
    for other in (counted, spans):
        assert other[0] == plain[0]
        assert torch.equal(other[1], plain[1])
        for a, b in zip(other[2], plain[2]):
            assert torch.equal(a, b)
