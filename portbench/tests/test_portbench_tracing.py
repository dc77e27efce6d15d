"""The trace reduction on a made-up event list: busy time as the union of
device ops in the window, a span's time from its device-side mirror, idle
gaps split by the host ops they overlap, the rest labelled by the host op
around the launch that ends them, and the runtime's calls summed."""

from types import SimpleNamespace

import pytest
import torch

from portbench import tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, corr=0):
        self._v = (name, dev, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_busy_spans_and_gaps():
    events = [
        Ev(tracing.WINDOW, CPU, 0, 1000),
        Ev(tracing.WINDOW, CUDA, 100, 800),            # mirror: no work
        Ev("aten::embedding", CPU, 10, 20),
        Ev("cudaLaunchKernel", CPU, 15, 2, corr=1),
        Ev("attention.mha", CPU, 40, 30),
        Ev("cudaLaunchKernel", CPU, 50, 2, corr=2),
        Ev("attention.mha", CUDA, 300, 200),           # mirror of the span
        Ev("embed_kernel", CUDA, 100, 150, corr=1),
        Ev("flash_tc", CUDA, 300, 200, corr=2),
        Ev("late_kernel", CUDA, 950, 100),             # clipped at 1000
    ]
    t = tracing.reduce(prof(events), {"attention.mha"})
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx((150 + 200 + 50) / 1e9)
    assert t.span_s == {"attention.mha": pytest.approx(200 / 1e9)}
    assert set(t.device_ops) == {"embed_kernel", "flash_tc", "late_kernel"}
    # [0, 100) holds 20 ns of aten::embedding and 30 of the span on the
    # host, and 50 outside any host op before the launch of embed_kernel,
    # inside aten::embedding; [250, 300) ends at flash_tc, launched inside
    # the span; [500, 950) at a kernel whose launch is not in the trace.
    assert t.gaps == {
        "aten::embedding": pytest.approx(20 / 1e9),
        "attention.mha": pytest.approx(30 / 1e9),
        "no host op, before aten::embedding": pytest.approx(50 / 1e9),
        "no host op, before attention.mha": pytest.approx(50 / 1e9),
        "no host op found": pytest.approx(450 / 1e9)}
    assert t.unattributed == 1
    assert t.host_calls == {"cudaLaunchKernel": pytest.approx(4 / 1e9)}
    out = tracing.breakdown(t, top=2)
    assert [name for name, _ in out["device_ops"]] == ["flash_tc",
                                                      "embed_kernel"]


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        tracing.reduce(prof([Ev("k", CUDA, 0, 1)]), set())
