"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Runs from the root of a checkout (it puts ``src/`` on the path itself)
and imports nothing of JAX or of the JAX package ``repro``.  Phases, each
printing one JSON line; any failure raises and the script exits non-zero:

1. environment: the card, its power limit, torch/CUDA versions, and the
   build of every CUDA source of the port (``nvcc`` at first use);
2. the water-fill kernel against its plain PyTorch version on the card,
   bitwise, at widths 8 ... 5120 (more than one lane per thread above
   1024) and on degenerate rows, with a rerun and the launch counter;
3. the main path: the 4 seeds x 4 policies x 4 error alphas = 64-cell
   matrix on the full paper FB workload (100 jobs, 100 machines, 400 map
   and 200 reduce slots) through ``run_cells_accel(device="cuda")``,
   cold and warm, then once more with the plain water-fill, which must
   give the same summaries; every job completes and hfsp and srpt beat
   fifo on mean sojourn at alpha 0 on every seed;
4. wide rows: 4 hfsp cells of 1000 ``fb_scaled`` jobs on 100 machines
   (width 1024) through the same entry point, kernel and plain version;
5. per-kernel timing on inputs captured from the main path, beside the
   bound of the work, and a short profile of the hfsp step;
6. the ``{"kernels": [...]}`` line, the card's name and power limit, and
   the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks: HBM3 bandwidth, and f64 outside the tensor
#: cores (the water-fill is f64 element-wise work).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 34e12
#: f64 operations per lane per round of the water-fill as the plain
#: version writes it: the weight sum's add, the share's multiply and
#: divide, headroom and headroom-minus-eps subtractions, the capped
#: compare, the grant sum's add and the allocation's add.
WF_OPS_PER_LANE_ROUND = 8

POLICIES = ("fifo", "hfsp", "srpt", "las")
SEEDS = (0, 1, 2, 3)
ALPHAS = (0.0, 0.1, 0.3, 0.5)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, replays: int = 10) -> float:
    """Mean device time of the launches ``fn()`` issues, captured once in
    a CUDA graph and replayed: no host time between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int64)


def drop_wall(results: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in results]


# ---------------------------------------------------------------------------
def phase_environment():
    from repro_torch.accel import _build

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    for src in sorted(_build.CSRC.glob("*.cu")):
        _build.load(src.stem)
    build_s = time.perf_counter() - t0
    ptxas = [
        line.strip()
        for info in _build.BUILD_INFO.values()
        for line in info["log"].splitlines()
        if "spill" in line or "Used" in line
    ]
    emit("environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         build_s=round(build_s, 3),
         builds={k: round(v["seconds"], 3)
                 for k, v in _build.BUILD_INFO.items()},
         ptxas=ptxas)
    return card


def wf_rows(rng, b, w):
    caps = rng.integers(0, 50, (b, w)).astype(np.float64)
    caps[rng.random((b, w)) < 0.2] = 0.0
    ws = rng.uniform(0.5, 2.0, (b, w))
    live = rng.random((b, w)) < 0.7
    slots = rng.uniform(0.0, caps.sum(1) * 1.2 + 1.0)
    return caps, ws, slots, live


def to_dev(caps, ws, slots, live, dev):
    return (torch.as_tensor(caps, dtype=torch.float64, device=dev),
            torch.as_tensor(ws, dtype=torch.float64, device=dev),
            torch.as_tensor(slots, dtype=torch.float64, device=dev),
            torch.as_tensor(live, dtype=torch.bool, device=dev))


def wf_bound(calls) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, ops) over a list of water-fill input
    tuples: each input read once and the output written once, and the
    rounds these inputs need (counted by the plain version)."""
    from repro_torch.accel import waterfill as wf

    nbytes = ops = 0
    for caps, ws, slots, live in calls:
        b, w = caps.shape
        nbytes += b * w * (8 + 8 + 1 + 8) + b * 8
        _, rounds = wf._fill_rounds(*wf._padded(caps, ws, slots, live)[:4])
        ops += int(rounds.sum()) * wf._bucket(w) * WF_OPS_PER_LANE_ROUND
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F64_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def phase_kernel_vs_plain():
    from repro_torch.accel import waterfill as wf

    dev = torch.device("cuda")
    rng = np.random.default_rng(2013)
    cases = [(f"random-W{w}", wf_rows(rng, 64, w))
             for w in (8, 32, 128, 1024, 3072, 5120)]
    # The degenerate rows of tests/test_accel.py: no live entries, no
    # free slots, slots exceeding total caps.
    for name, slots, live in (("no-live", 10.0, np.zeros(8, bool)),
                              ("no-slots", 0.0, np.ones(8, bool)),
                              ("excess-slots", 1e6, np.ones(8, bool))):
        cases.append((name, (np.arange(8.0)[None], np.ones((1, 8)),
                             np.array([slots]), live[None])))
    for name, rows in cases:
        args = to_dev(*rows, dev)
        before = wf.launches
        got = wf.water_fill_cuda(*args)
        again = wf.water_fill_cuda(*args)
        want = wf.water_fill_reference(*args)
        torch.cuda.synchronize()
        if wf.launches != before + 2:
            raise AssertionError(f"{name}: launch counter did not advance")
        if not torch.equal(bits(got), bits(want)):
            err = (got - want).abs().max().item()
            raise AssertionError(f"{name}: kernel != plain version ({err})")
        if not torch.equal(bits(got), bits(again)):
            raise AssertionError(f"{name}: kernel rerun not bitwise equal")
        ms = graph_ms(lambda: [wf.water_fill_cuda(*args) for _ in range(20)]) / 20
        call_ms = cuda_ms(lambda: wf.water_fill_cuda(*args), 50)
        plain_ms = cuda_ms(lambda: wf.water_fill_reference(*args), 5)
        bound_ms, bound_by, _, _ = wf_bound([args])
        emit("kernel_vs_plain", case=name, shape=list(args[0].shape),
             bitwise_equal=True, max_abs_err=0.0, ms=ms, call_ms=call_ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def main_matrix():
    from repro_torch.scenarios.presets import paper_fb_base
    from repro_torch.scenarios.spec import SweepSpec

    sweep = SweepSpec(
        name="accel-bench",
        base=paper_fb_base(seed=0),  # full scale: 100 jobs, 100 machines
        grids=(SweepSpec.grid(**{
            "workload.seed": SEEDS,
            "scheduler.policy": POLICIES,
            "scheduler.error_alpha": ALPHAS,
        }),),
    )
    return [s for _, s in sweep.expand()]


def check_matrix(specs, results, n_jobs):
    by = {}
    for spec, res in zip(specs, results):
        if res["compute"] != "accel" or res["jobs_completed"] != n_jobs \
                or res["jobs_lost"] != 0:
            raise AssertionError(f"incomplete cell {spec.to_dict()}: {res}")
        if not np.isfinite(res["mean_sojourn_s"]) or res["mean_sojourn_s"] <= 0:
            raise AssertionError(f"bad sojourn {res}")
        by[(spec.workload.seed, spec.scheduler.policy,
            spec.scheduler.error_alpha)] = res
    return by


def phase_main_path():
    from repro_torch.accel import run_cells_accel, synthesize_cell
    from repro_torch.accel import waterfill as wf

    specs = main_matrix()
    assert len(specs) == 64
    t0 = time.perf_counter()
    for s in specs:
        synthesize_cell(s)
    synth_s = time.perf_counter() - t0

    wf.launches = 0
    t0 = time.perf_counter()
    cold = run_cells_accel(specs, device="cuda")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = wf.launches

    t0 = time.perf_counter()
    warm = run_cells_accel(specs, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    plain = run_cells_accel(specs, device="cuda", impl="torch")

    if launches <= 0:
        raise AssertionError("main path launched no water-fill kernel")
    if drop_wall(cold) != drop_wall(warm):
        raise AssertionError("warm rerun differs from cold run")
    if drop_wall(cold) != drop_wall(plain):
        raise AssertionError("plain water-fill run differs from kernel run")
    by = check_matrix(specs, cold, 100)
    ordering = {}
    for seed in SEEDS:
        fifo = by[(seed, "fifo", 0.0)]["mean_sojourn_s"]
        for pol in ("hfsp", "srpt"):
            if not by[(seed, pol, 0.0)]["mean_sojourn_s"] < fifo:
                raise AssertionError(f"seed {seed}: {pol} not below fifo")
        ordering[seed] = {p: by[(seed, p, 0.0)]["mean_sojourn_s"]
                          for p in POLICIES}
    # The device path alone: each compute class's packed batch through
    # run_packed, synthesis excluded.
    from repro_torch.accel import cell_step

    stepping = {}
    for klass, impl in (("plain", "none"), ("hfsp", None)):
        packed = cell_step.pack_cells([
            synthesize_cell(s) for s in specs
            if (s.scheduler.policy == "hfsp") == (klass == "hfsp")])
        params = cell_step.params_from_numpy(packed, "cuda")
        t0 = time.perf_counter()
        final = cell_step.run_packed(params, impl=impl)
        stepping[klass] = {
            "cells": int(packed["arrival"].shape[0]),
            "width": int(packed["arrival"].shape[1]),
            "steps_run": int(final["steps"].max() + 511) // 512 * 512,
            "wall_s": time.perf_counter() - t0,
        }
    hfsp_steps = sum(by[(s, "hfsp", a)]["accel_steps"]
                     for s in SEEDS for a in ALPHAS)
    max_hfsp_steps = max(by[(s, "hfsp", a)]["accel_steps"]
                         for s in SEEDS for a in ALPHAS)
    emit("main_path", cells=len(specs), jobs_per_cell=100,
         cold_s=cold_s, warm_s=warm_s,
         cold_cells_per_s=len(specs) / cold_s,
         warm_cells_per_s=len(specs) / warm_s,
         synthesize_s=synth_s, run_packed=stepping,
         waterfill_launches=launches,
         max_hfsp_steps=max_hfsp_steps, hfsp_cell_steps=hfsp_steps,
         steps={f"{s}/{p}": by[(s, p, 0.0)]["accel_steps"]
                for s in SEEDS for p in POLICIES},
         mean_sojourn_alpha0=ordering,
         plain_equal=True)
    return launches


def phase_wide_rows():
    from repro_torch.accel import run_cells_accel
    from repro_torch.accel import waterfill as wf
    from repro_torch.scenarios.presets import paper_fb_base

    specs = [
        paper_fb_base(seed=seed).override(**{
            "workload.kind": "fb_scaled", "workload.num_jobs": 1000,
            "cluster.num_machines": 100,
        })
        for seed in range(4)
    ]
    wf.launches = 0
    t0 = time.perf_counter()
    res = run_cells_accel(specs, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wf.launches
    plain = run_cells_accel(specs, device="cuda", impl="torch")
    if launches <= 0:
        raise AssertionError("wide path launched no water-fill kernel")
    if drop_wall(res) != drop_wall(plain):
        raise AssertionError("wide rows: plain water-fill run differs")
    check_matrix(specs, res, 1000)
    emit("wide_rows", cells=len(specs), jobs_per_cell=1000, width=1024,
         wall_s=wall, waterfill_launches=launches,
         steps=[r["accel_steps"] for r in res],
         mean_sojourn_s=[r["mean_sojourn_s"] for r in res],
         plain_equal=True)


def captured_calls(n_steps: int):
    """Water-fill inputs of the main path's hfsp batch (16 cells, width
    128), captured over its first ``n_steps`` steps."""
    from repro_torch.accel import cell_step, synthesize_cell
    from repro_torch.accel import waterfill as wf

    specs = [s for s in main_matrix() if s.scheduler.policy == "hfsp"]
    params = cell_step.params_from_numpy(
        cell_step.pack_cells([synthesize_cell(s) for s in specs]), "cuda")
    state = cell_step._to_tensors(
        cell_step.init_state({k: v.cpu().numpy() for k, v in params.items()}),
        params["arrival"].device)
    calls = []

    def record(caps, ws, slots, live):
        calls.append((caps, ws, slots, live))
        return wf.water_fill_cuda(caps, ws, slots, live)

    with torch.no_grad():
        for _ in range(n_steps):
            state = cell_step._cell_step(params, state, record)
    torch.cuda.synchronize()
    return params, state, calls


def phase_kernel_timing(main_launches: int):
    from repro_torch.accel import cell_step
    from repro_torch.accel import waterfill as wf

    params, state, calls = captured_calls(256)
    got = [wf.water_fill_cuda(*c) for c in calls]
    want = [wf.water_fill_reference(*c) for c in calls]
    torch.cuda.synchronize()
    max_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want)):
        raise AssertionError(f"main-path inputs: kernel != plain ({max_err})")

    def run_all(fn):
        return lambda: [fn(*c) for c in calls]

    # ms: the kernel's device time, its launches replayed from a CUDA
    # graph; call_ms: one wrapper call as the main path makes it (host
    # checks and launch included); plain_ms: the plain version's call.
    ms = graph_ms(run_all(wf.water_fill_cuda)) / len(calls)
    call_ms = cuda_ms(run_all(wf.water_fill_cuda), 5) / len(calls)
    plain_ms = cuda_ms(run_all(wf.water_fill_reference), 2) / len(calls)
    bound_total, bound_by, nbytes, ops = wf_bound(calls)
    bound_ms = bound_total / len(calls)

    # Short profile of the hfsp step: device time by kernel and the
    # device's busy share of the wall.
    from torch.profiler import ProfilerActivity, profile

    n_prof = 32
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(n_prof):
                state = cell_step._cell_step(params, state, wf.water_fill_cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    total_dev_us = sum(ev.self_device_time_total for ev in kernels)
    wf_events = [ev for ev in kernels if "waterfill" in ev.key]
    wf_us = sum(ev.self_device_time_total for ev in wf_events)
    wf_count = sum(ev.count for ev in wf_events)
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:5]
    measured = total_dev_us > 0
    emit("profile_hfsp_step", steps=n_prof, batch=list(params["arrival"].shape),
         wall_ms_per_step=wall / n_prof * 1e3,
         device_ms_per_step=(total_dev_us / n_prof / 1e3) if measured
         else "not measured",
         device_busy_share=(total_dev_us / 1e6 / wall) if measured
         else "not measured",
         kernel_launches_per_step=sum(ev.count for ev in kernels) / n_prof,
         waterfill_share_of_device=(wf_us / total_dev_us) if measured
         else "not measured",
         waterfill_device_us_per_launch=(wf_us / wf_count) if wf_count
         else "not measured",
         top_kernels_us=[[ev.key[:70], ev.count, ev.self_device_time_total]
                         for ev in top])

    return {
        "name": "waterfill",
        "route": "cuda",
        "source": "src/repro_torch/accel/csrc/waterfill.cu",
        "replaces": "src/repro/accel/waterfill_pallas.py:77",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "call_ms": call_ms,
        "shape": list(calls[0][0].shape),
        "timed_calls": len(calls),
        "bytes_per_call": nbytes / len(calls),
        "ops_per_call": ops / len(calls),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "checks the port on a CUDA GPU", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = phase_environment()
    phase_kernel_vs_plain()
    main_launches = phase_main_path()
    phase_wide_rows()
    kernel = phase_kernel_timing(main_launches)
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
