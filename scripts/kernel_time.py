"""The timing loop shared by ``k3_time.py`` and ``k4_time.py``, the
``--trees`` runner those two, ``k1_time.py`` and ``p_time.py`` share, and
the CUDA-graph helpers of ``k1_time.py`` and ``p_time.py``.

Each of those scripts supplies one kernel's inputs and its call; this
module times it and runs it once per checkout, in turns.  It is imported,
not run: ``python3 scripts/k3_time.py --trees A B B A``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(kernel, plain, bf16: tuple, f32: tuple, prefix: str) -> dict:
    """Time ``kernel`` (the card's route, returning (out, state)) on the
    bf16 and the f32 inputs: CUDA events over 20 calls after a warm-up,
    the bf16 output's largest error against ``plain``, and each kernel's
    device time per launch in a profile of 5 calls, keyed by the first
    match of ``prefix\\w+`` in its name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def ms(args, reps=20):
        kernel(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kernel(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    got, _ = kernel(*bf16)
    want, _ = plain(*bf16)
    out = {"max_abs_err_bf16": (got.float() - want.float()).abs().max().item(),
           "ms_bf16": ms(bf16), "ms_f32_inputs": ms(f32)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kernel(*bf16)
        torch.cuda.synchronize()
    out["profiled_ms_per_launch"] = {
        (re.search(prefix + r"\w+", ev.key) or re.search(r".{0,40}", ev.key))[0]:
        ev.self_device_time_total / 1e3 / ev.count
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count}
    return out


def graph_ms(fn, replays: int = 10) -> float:
    """Mean device time of the launches ``fn()`` issues, captured once in
    a CUDA graph and replayed: no host time between launches."""
    import torch

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


def graph_kernels(fn) -> int:
    """The kernels ``fn()`` launches: the kernel nodes of a CUDA graph it
    is captured in, as the CUDA driver API reports them (no profiler)."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    torch.cuda.synchronize()
    return kernels


def main(doc: str, script: str, run) -> int:
    """Parse ``--trees``/``--seed``; run ``script`` once per tree as a
    child process that puts the tree's ``src/`` first on its path and
    prints ``run(seed)`` as JSON; print one JSON line per tree, then the
    card's name and power limit."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--trees", nargs="*", default=[str(ROOT)],
                        help="checkouts to time, one process each, in order")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        sys.path.insert(0, str(Path(args.child) / "src"))
        print(json.dumps(run(args.seed)), flush=True)
        return 0
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, script, "--child", str(Path(tree).resolve()),
             "--seed", str(args.seed)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **result}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    return 0
