"""The charge of a traced slice to the program's phase spans
(``benchmark/spans.py``), on synthetic kineto-like events: kernels go to
the innermost ``fthmc.`` span through the correlation id of their runtime
call, idle gaps by their middle; the spans and their device-side mirror
leave ``tracing.reduce_events``' numbers as they were; the two per-layer
numbers read on the card and give None off it or without step spans."""
import pytest
import torch

from benchmark import spans, tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
DRIVER, OTHER = 1, 2
NS = 1e-9


class Ev:
    """The part of ``torch._C._autograd._KinetoEvent`` that is read."""

    def __init__(self, name, start, end, device=CPU, thread=DRIVER, corr=0,
                 annotation=False):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._thread, self._corr = device, thread, corr
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


def _bare():
    """A slice of one block of one trajectory, without the program's
    spans: kernels launched in what will be momenta, integrate, energy
    (a copy), the block edge, and one whose runtime call is missing."""
    return [
        Ev(tracing.SLICE_SPAN, 0, 1000),
        Ev(tracing.BLOCK_SPAN, 0, 1000),
        Ev("aten::cat", 940, 990),
        Ev("cudaLaunchKernel", 120, 125, corr=1),
        Ev("cudaLaunchKernelExC", 210, 215, corr=2),
        Ev("cudaMemcpyAsync", 520, 525, corr=3),
        Ev("cudaLaunchKernel", 950, 955, corr=4),
        Ev("randn_kernel", 150, 250, CUDA, corr=1),
        Ev("leapfrog_band_kernel", 260, 560, CUDA, corr=2),
        Ev("Memcpy DtoH (Device -> Pinned)", 570, 600, CUDA, corr=3),
        Ev("reduce_kernel", 960, 980, CUDA, corr=4),
        Ev("stray_kernel", 990, 995, CUDA, corr=99),
    ]


PHASES = [("fthmc.step", 100, 900), ("fthmc.step.momenta", 110, 200),
          ("fthmc.step.integrate", 200, 500),
          ("fthmc.step.energy", 500, 600), ("fthmc.step.accept", 600, 700),
          ("fthmc.step.observe", 700, 850)]


def _traced():
    """The same slice with the program's spans and their device mirror."""
    return (_bare() + [Ev(n, a, b) for n, a, b in PHASES]
            + [Ev("fthmc.step", 150, 980, CUDA, annotation=True),
               Ev("fthmc.step.integrate", 260, 560, CUDA, annotation=True),
               # a span of another thread is not the driving thread's
               Ev("fthmc.step.accept", 0, 1000, thread=OTHER)])


def test_device_time_and_idle_are_charged_to_the_innermost_span():
    ch = spans.charge(_traced())
    dev = {k: round(v["device_s"] / NS) for k, v in ch.items()
           if v["device_s"]}
    assert dev == {"fthmc.step.momenta": 100, "fthmc.step.integrate": 300,
                   "fthmc.step.energy": 30, "-": 20, "?": 5}
    # gaps [0,150], [980,990] and [995,1000] outside, [250,260] in
    # integrate, [560,570] in energy, [600,960] (middle 780) in observe
    idle = {k: round(v["idle_s"] / NS) for k, v in ch.items()
            if v["idle_s"]}
    assert idle == {"-": 165, "fthmc.step.integrate": 10,
                    "fthmc.step.energy": 10, "fthmc.step.observe": 360}
    assert {k: v["calls"] for k, v in ch.items() if v["calls"]} == {
        n: 1 for n, _, _ in PHASES}
    assert round(ch["fthmc.step"]["host_s"] / NS) == 800
    assert round(ch["-"]["host_s"] / NS) == 200
    assert ch["fthmc.step.energy"]["kernels"] == {}     # a copy, no kernel
    assert list(ch["fthmc.step.integrate"]["kernels"]) == [
        "leapfrog_band_kernel"]


def test_spans_and_their_mirror_leave_the_slice_reduction_as_it_was():
    bare, traced = (tracing.reduce_events(ev) for ev in (_bare(), _traced()))
    for key in ("window_s", "busy_s", "kernels", "kernel_launches",
                "device_ops"):
        assert traced[key] == bare[key], key
    assert (sum(s for _, s in traced["idle_gaps"])
            == pytest.approx(sum(s for _, s in bare["idle_gaps"])))
    assert not any(n.startswith("fthmc.") for n, _ in traced["device_ops"])
    # one stream: the charge misses no device time
    ch = spans.charge(_traced())
    assert (sum(v["device_s"] for v in ch.values())
            == pytest.approx(traced["busy_s"]))


def _ctx(events, on_card=True):
    return {"on_card": on_card,
            "slice": {"spans": spans.charge(events), "traj": 1,
                      "blocks": 1}}


@pytest.mark.parametrize("read, value_ms", [
    (spans.block_edge_idle_ms, 165e-6),
    (spans.step_extra_device_ms, (100 + 30 + 20 + 5) * 1e-6)])
def test_readers_read_on_the_card_and_nothing_elsewhere(read, value_ms):
    assert read(_ctx(_traced())) == pytest.approx(value_ms)
    assert read(_ctx(_traced(), on_card=False)) is None
    # a program that opens no step span
    assert read(_ctx(_bare())) is None
