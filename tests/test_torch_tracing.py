"""The samplers' phase spans (``fthmc_tpu_torch.utils.profiling.span``) on
the CPU: with no profiler running no ``record_function`` is ever made on
the step's path, and under ``torch.profiler`` each trajectory of plain HMC
(every backend the CPU runs as a plain twin) and of FT-HMC (the kernel
chain's plain twins, a tiny random rncp flow) is one ``fthmc.step`` span
holding its phases, nested and in order."""
import pytest
import torch

from fthmc_tpu_torch import hmc as th
from fthmc_tpu_torch.config import FlowSpec, HMCConfig, LeapfrogConfig
from fthmc_tpu_torch.models.flow import init_flow_params

NTRAJ, BLOCK = 3, 2
PLAIN = ["momenta", "integrate", "accept", "energy", "observe"]
FUSED = ["momenta", "integrate", "accept", "observe"]
FLOWED = ["momenta", "energy", "integrate", "energy", "accept", "observe"]
RUNS = {"xla": PLAIN, "fused": FUSED, "fused_hostrng": FUSED, "ft": FLOWED}


def _run(kind):
    """NTRAJ trajectories in blocks of BLOCK through a chunked driver."""
    g = torch.Generator().manual_seed(3)
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


@pytest.mark.parametrize("kind", ["xla", "ft"])
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
