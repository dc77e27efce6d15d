"""The traced run: spans the benchmark wraps around the program's calls
from outside, the profiler over the traced window, and the reduction of
its events to the numbers the per-layer readers take.

A span is a ``record_function`` range around a module attribute of the
program (``SPANS`` of a metric's reader names it), installed only in a
traced run.  Its wrapper also keeps the shapes of each call's tensor
arguments.

The reduction reads the profiler's raw events, not its op tree: busy time
is the union of device operations inside the window, a span's device
time is what runs inside the range's mirror on the device's timeline, and
an idle gap's time is split by what the host was doing in it: the
outermost host ops it overlaps, by name, and the rest, where the host ran
no op (Python between ops, a pause), by the outermost op around the
launch (by its runtime call's correlation) of the device op that ends the
gap.  The runtime's calls (launches, allocations, copies, waits) are
summed by name over the window too.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "portbench.window"
_RUNTIME = ("cuda", "cu", "nccl")


@dataclass
class Spans:
    """Installed spans: {name: [arg shapes of each call while recording]}."""

    names: tuple = ()
    calls: dict = field(default_factory=lambda: defaultdict(list))
    recording: bool = False


def _wrap(name: str, fn, spans: Spans):
    from torch.profiler import record_function

    def run(*args, **kw):
        if spans.recording:
            spans.calls[name].append(tuple(
                (tuple(a.shape), a.element_size()) for a in args
                if isinstance(a, torch.Tensor)))
        with record_function(name):
            return fn(*args, **kw)

    return run


@contextlib.contextmanager
def installed(specs: dict):
    """Install ``specs`` ({span name: (module, attribute)}) while the
    context lasts; yields the :class:`Spans` that record the calls."""
    spans = Spans(names=tuple(specs))
    undo = []
    try:
        for name, (module, attr) in specs.items():
            mod = importlib.import_module(module)
            original = getattr(mod, attr)
            setattr(mod, attr, _wrap(name, original, spans))
            undo.append((mod, attr, original))
        yield spans
    finally:
        for mod, attr, original in reversed(undo):
            setattr(mod, attr, original)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: dict          # kernel name -> seconds
    span_s: dict              # span name -> device seconds launched inside
    gaps: dict                # host label -> idle seconds
    unattributed: int         # gaps whose ending launch was not found
    host_calls: dict = field(default_factory=dict)  # runtime call -> s


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _containing(starts, ends, names, t):
    """Name of the interval (sorted by start, not overlapping) holding t."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= ends[i]:
        return names[i]
    return None


def _overlap(a: int, b: int, starts, ends) -> int:
    """ns of [a, b] inside the merged intervals (starts, ends)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0
    while i < len(starts) and starts[i] < b:
        total += max(0, min(b, ends[i]) - max(a, starts[i]))
        i += 1
    return total


def reduce(prof, span_names) -> Trace:
    """Reduce a finished profile whose window is the ``WINDOW`` range.

    The profiler mirrors each ``record_function`` range onto the device's
    timeline, from its first device op to its last; a device op belongs
    to a span when it lies inside that mirror (one stream: the ops of a
    range run between its first and its last).  The mirrors themselves
    are no device work."""
    cuda = torch.autograd.DeviceType.CUDA
    marks = set(span_names) | {WINDOW}
    host, dev, mirrors = [], [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            host.append(e)
        elif e.name() in marks:
            mirrors[e.name()].append((e.start_ns(),
                                      e.start_ns() + e.duration_ns()))
        else:
            dev.append(e)
    win = [e for e in host if e.name() == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' ranges")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    spans = {}
    for name in span_names:
        merged = _merge(mirrors.get(name, []))
        spans[name] = ([a for a, _ in merged], [b for _, b in merged])

    launches = {}     # correlation id -> runtime launch on the host
    tops = []         # host ops that no other host op contains
    host_calls = defaultdict(float)
    for e in sorted(host, key=lambda e: (e.start_ns(), -e.duration_ns())):
        name = e.name()
        if name.startswith(_RUNTIME):
            launches[e.correlation_id()] = e
            a, b = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(),
                                                w1)
            if b > a:
                host_calls[name] += (b - a) / 1e9
        elif name != WINDOW and (not tops or e.start_ns() >= tops[-1][1]):
            tops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    top_starts = [t[0] for t in tops]
    top_ends = [t[1] for t in tops]
    top_names = [t[2] for t in tops]

    intervals, by_name = [], defaultdict(float)
    span_s = {name: 0.0 for name in span_names}
    first = []        # (device start, the device op)
    for e in dev:
        a = max(e.start_ns(), w0)
        b = min(e.start_ns() + e.duration_ns(), w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[e.name()] += (b - a) / 1e9
        first.append((e.start_ns(), e))
        for name, (starts, ends) in spans.items():
            span_s[name] += _overlap(a, b, starts, ends) / 1e9
    busy = _merge(intervals)
    busy_s = sum(b - a for a, b in busy) / 1e9

    first.sort(key=lambda x: x[0])
    starts = [t for t, _ in first]
    gaps = defaultdict(float)
    unattributed = 0
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        inside = 0
        j = max(bisect.bisect_right(top_starts, g0) - 1, 0)
        while j < len(tops) and top_starts[j] < g1:
            part = min(g1, top_ends[j]) - max(g0, top_starts[j])
            if part > 0:
                gaps[top_names[j]] += part / 1e9
                inside += part
            j += 1
        rest = (g1 - g0 - inside) / 1e9
        if rest <= 0:
            continue
        i = bisect.bisect_left(starts, g1)
        if i >= len(first):
            gaps["after the last device op"] += rest
            continue
        launch = launches.get(first[i][1].correlation_id())
        label = launch and _containing(top_starts, top_ends, top_names,
                                       launch.start_ns())
        if label:
            gaps[f"no host op, before {label}"] += rest
        else:
            unattributed += 1
            gaps["no host op found"] += rest
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_s,
                 device_ops=dict(by_name), span_s=span_s, gaps=dict(gaps),
                 unattributed=unattributed, host_calls=dict(host_calls))


def largest(d: dict, top: int = 10) -> list:
    """The ``top`` largest entries of {name: seconds} as [name, seconds]."""
    return [[k[:160], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most time
    and the idle gaps by what the host was doing, each at most ``top``
    entries of [name, seconds]."""
    return {"device_ops": largest(trace.device_ops, top),
            "idle_gaps": largest(trace.gaps, top)}
