"""What every loop of ``kinds/`` shares: the run's record, the stand-ins'
hook, the traced window and its reduction, the reference's precision, and
freeing the program's state before the reference runs.

A loop (``kinds/<kind>.py``, found by the traffic mix's ``kind``) builds
the program's entry from the benchmark's inputs, warms every shape the
mix uses (set-up), runs the window, reads the memory peak, frees the
program's state, and then lets the configuration's plain reference
(``Run.ref``) judge what the window produced.  A traced run's window is
the mix's ``trace_seconds`` at the most, all of it under the profiler.
"""

from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field

import torch

from portbench import tracing


@dataclass
class Run:
    """What a run hands the metric readers."""

    kind: str
    model: dict
    traffic: dict
    seed: int
    device: torch.device
    t0: float                       # process start, host clock
    ref: object = None              # the configuration's reference module
    work: str = ""                  # what the items are: the loop sets it
    trace: bool = False
    setup_s: float = 0.0
    window_s: float = 0.0
    items: list = field(default_factory=list)   # requests or steps
    traced: tracing.Trace | None = None
    span_calls: dict = field(default_factory=dict)
    peaks: dict | None = None
    memory_peak_bytes: int = 0
    numbers: dict = field(default_factory=dict)
    phases: dict = field(default_factory=dict)   # seconds, process start on
    notes: dict = field(default_factory=dict)    # printed, never compared

    def mark(self, phase: str) -> None:
        self.phases[phase] = time.perf_counter() - self.t0

    def seconds(self) -> float:
        """The window's length: the traffic's ``trace_seconds`` at the
        most in a traced run."""
        if self.trace:
            return min(self.window_s, self.traffic["trace_seconds"])
        return self.window_s


@dataclass
class Hooks:
    """A stand-in the tests and the calibration put under the window:
    ``wrap`` takes the program's entry and returns the one the window
    calls."""

    wrap: object = None

    def __call__(self, entry):
        return entry if self.wrap is None else self.wrap(entry)


def hooks(kind, stand_in: str, run: Run) -> Hooks:
    """The :class:`Hooks` of ``stand_in`` (``program``, ``control`` or a
    fault of the loop module ``kind``'s ``FAULTS``) for ``run``."""
    if stand_in == "program":
        return Hooks()
    if stand_in == "control":
        if not hasattr(kind, "control"):
            raise ValueError(f"{kind.__name__}: its control needs no "
                             "window: see control_numbers")
        return Hooks(kind.control(run))
    return Hooks(kind.FAULTS[stand_in])


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def model_config(model: dict):
    """The program's ``ModelConfig`` of a configuration file's fields."""
    from repro_torch.configs.base import ModelConfig

    fields = {k: v for k, v in model.items()
              if k in ModelConfig.__dataclass_fields__}
    return ModelConfig(**fields)


@contextlib.contextmanager
def window(run: Run, specs: dict):
    """Spans and the profiler around the window of a traced run; a plain
    window otherwise.  Yields (spans or None, profiler or None)."""
    if not run.trace:
        yield None, None
        return
    with tracing.installed(specs) as spans:
        yield spans, tracing.profiler()


@contextlib.contextmanager
def traced(prof, spans, dev):
    """The profiler on and the window range open while the context lasts."""
    if prof is None:
        yield
        return
    from torch.profiler import record_function

    with prof:
        spans.recording = True
        with record_function(tracing.WINDOW):
            yield
        sync(dev)
        spans.recording = False


def finish_trace(run: Run, prof, spans) -> None:
    if prof is None:
        return
    run.traced = tracing.reduce(prof, set(spans.names))
    run.span_calls = dict(spans.calls)


@contextlib.contextmanager
def exact_f32():
    """Float32 products in float32 (no TF32) while the reference runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


class GcClock:
    """Python's garbage collections while the context lasts: how many, and
    their host seconds (a pause the closed loop's host cannot hide)."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
