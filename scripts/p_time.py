"""Time P (the processor-sharing projection kernel) on a CUDA card.

    python3 scripts/p_time.py                     # this checkout
    python3 scripts/p_time.py --trees A B B A     # checkouts, in turns

Each tree is a checkout of this repository (its ``src/`` holds the port);
each run is a process of its own that builds that tree's kernels at first
use and times, with that tree's own code:

* ``project_cuda`` on B = 1 rows at widths 16, 256 and 1024, drawn as
  ``chip_smoke.py``'s ``project_timing`` draws them (``default_rng(7)``),
  10 calls captured in a CUDA graph and replayed (ms per call);
* ``vcluster_torch.project_finish_times`` (numpy in and out) at 1024,
  2048 and 5120 jobs: host wall per call and the launches it makes (the
  tree's route: segments compacted on the host, or one launch);
* the projections of the stress cell (``chip_smoke.py``'s, 5000 jobs on
  1000 machines, hfsp) over its first ``--events`` events, every kernel
  call recorded and then replayed in one CUDA graph: the device time of
  all of them, and per launch.

The same simulation runs in every tree, so the stress cell's total device
time compares across trees even where one tree makes more launches.
Prints one JSON line per run (``kernel_time.main``), then the card's name
and power limit.  Compare trees only within one invocation: two
invocations may land on two cards.
"""

from __future__ import annotations

import importlib.util
import sys
import time

import kernel_time

EVENTS = 4000


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (numpy and torch
    only at import; its functions import the child's ``repro_torch``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", kernel_time.ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import projection as pj
    from repro_torch.core import vcluster_torch as vt

    cs = smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    out = {"ms_by_width": {}, "wrapped": {}}
    for w in (16, 256, 1024):
        args = cs.project_tensors(cs.project_rows(rng, 1, w), dev)
        out["ms_by_width"][w] = kernel_time.graph_ms(
            lambda: [pj.project_cuda(*args) for _ in range(10)]) / 10

    rng = np.random.default_rng(seed)
    for n in (1024, 2048, 5120):
        rem, caps, ws, _, slots, now, _ = cs.project_rows(rng, 1, n)
        one = (rem[0], caps[0], ws[0], float(slots[0]), float(now[0]))
        vt.project_finish_times(*one, device="cuda")
        before = pj.launches
        t0 = time.perf_counter()
        for _ in range(5):
            vt.project_finish_times(*one, device="cuda")
        out["wrapped"][n] = {
            "wall_us": (time.perf_counter() - t0) / 5 * 1e6,
            "launches": (pj.launches - before) / 5}

    captured = []
    project = pj.project

    def record(*args, **kw):
        captured.append((args, kw))
        return project(*args, **kw)

    cs.STRESS_EVENTS = EVENTS
    pj.project = record
    try:
        cs.stress_cell("torch")
    finally:
        pj.project = project
    total = kernel_time.graph_ms(
        lambda: [pj.project_cuda(*a, **kw) for a, kw in captured], replays=3)
    out["stress"] = {"events": EVENTS, "launches": len(captured),
                     "widest": max(a[0].shape[1] for a, _ in captured),
                     "total_ms": total, "ms_per_launch": total / len(captured)}
    return out


if __name__ == "__main__":
    sys.exit(kernel_time.main(__doc__, __file__, run))
