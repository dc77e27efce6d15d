"""Time K1 (the water-fill) on a CUDA card per hfsp step of the accel path.

    python3 scripts/k1_time.py                     # this checkout
    python3 scripts/k1_time.py --trees A B B A     # checkouts, in turns

Each tree is a checkout of this repository (its ``src/`` holds the port);
each run is a process of its own that builds that tree's kernels at first
use and, with that tree's own cell step, captures the water-fill inputs
of the first 256 steps of two hfsp batches: the paper-64 matrix's 16 hfsp
cells (16 x 128, as ``chip_smoke.py``'s main path packs them) and four
``fb_scaled`` cells of 1000 jobs on 100 machines (4 x 1024).  It then
times K1 per step, the step's launches captured once in a CUDA graph and
replayed: where the tree's cell step calls ``water_fill_cuda`` once per
virtual cluster, those two launches; where it makes one pair launch
(``launch_pair``), that launch.  Beside each capture it prints the rounds
its inputs need (the tree's plain version counts them: per step the
slowest row of both phases, summed over the steps, and every row's rounds
summed), so that any difference in inputs between trees shows, and the
host time per step of the calls as the cell step makes them, and the
kernels one whole step launches (the kernel nodes of a CUDA graph of the
step).  Then the floor any launch pays: a one-element ``add_``, replayed
the same way.
Prints one JSON line per run (``kernel_time.main``), then the card's name
and power limit.  Compare trees only within one invocation: two
invocations may land on two cards.
"""

from __future__ import annotations

import sys
import time

import kernel_time

STEPS = 256


def batches():
    """The two hfsp batches, as ``chip_smoke.py``'s main path and wide rows
    build them."""
    from repro_torch.scenarios.presets import paper_fb_base
    from repro_torch.scenarios.spec import SweepSpec

    sweep = SweepSpec(
        name="accel-bench", base=paper_fb_base(seed=0),
        grids=(SweepSpec.grid(**{
            "workload.seed": (0, 1, 2, 3),
            "scheduler.policy": ("fifo", "hfsp", "srpt", "las"),
            "scheduler.error_alpha": (0.0, 0.1, 0.3, 0.5),
        }),),
    )
    paper = [s for _, s in sweep.expand() if s.scheduler.policy == "hfsp"]
    wide = [paper_fb_base(seed=seed).override(**{
        "workload.kind": "fb_scaled", "workload.num_jobs": 1000,
        "cluster.num_machines": 100}) for seed in range(4)]
    return {"paper-64 hfsp batch": paper, "fb-1000-wide": wide}


def capture(specs):
    """(launch, calls, per_step, kernels_per_step): the tree's K1 wrapper
    as its cell step calls it, the calls of the first STEPS steps, and the
    kernels one step launches."""
    import torch

    from repro_torch.accel import cell_step, synthesize_cell
    from repro_torch.accel import waterfill as wf

    params = cell_step.params_from_numpy(
        cell_step.pack_cells([synthesize_cell(s) for s in specs]), "cuda")
    state = cell_step._to_tensors(
        cell_step.init_state({k: v.cpu().numpy() for k, v in params.items()}),
        params["arrival"].device)
    if hasattr(wf, "launch_pair"):
        wf.check_batch(params["weight"], params["map_slots"],
                       params["red_slots"])
        launch = wf.launch_pair
    else:  # a tree whose cell step calls the kernel once per phase
        launch = wf.water_fill_cuda
    calls = []

    def record(*args):
        calls.append(args)
        return launch(*args)

    with torch.no_grad():
        for _ in range(STEPS):
            state = cell_step._cell_step(params, state, record)
        kernels = kernel_time.graph_kernels(
            lambda: cell_step._cell_step(params, state, launch))
    torch.cuda.synchronize()
    return launch, calls, len(calls) // STEPS, kernels


def rounds(calls, per_step):
    """(sum over steps of the slowest row's rounds, sum over all rows)."""
    import torch

    from repro_torch.accel import waterfill as wf

    slowest = every = 0
    for i in range(0, len(calls), per_step):
        step = calls[i:i + per_step]  # (caps, ws, slots, live) each
        if len(step[0]) == 7:  # a pair: both phases on stacked rows
            cm, cr, ws, sm, sr, lm, lr = step[0]
            step = [(torch.cat([cm, cr]), torch.cat([ws, ws]),
                     torch.cat([sm, sr]), torch.cat([lm, lr]))]
        r = torch.cat([wf._fill_rounds(*c)[1] for c in step])
        slowest += int(r.max())
        every += int(r.sum())
    return slowest, every


def run(seed: int) -> dict:
    import torch

    del seed  # the inputs come from the specs' own workload seeds
    out = {}
    for name, specs in batches().items():
        launch, calls, per_step, kernels = capture(specs)

        def all_calls():
            for c in calls:
                launch(*c)

        ms = kernel_time.graph_ms(all_calls) / STEPS
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_calls()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        slowest, every = rounds(calls, per_step)
        out[name] = {
            "route": launch.__name__, "launches_per_step": per_step,
            "kernels_per_step": kernels,
            "shape": list(calls[0][0].shape), "ms_per_step": ms,
            "ms_per_launch": ms / per_step,
            "host_us_per_step": min(host) / STEPS * 1e6,
            "rounds_slowest_row_sum": slowest, "rounds_all_rows_sum": every,
        }
    one = torch.zeros(1, device="cuda")
    out["launch_floor_ms"] = kernel_time.graph_ms(
        lambda: [one.add_(1.0) for _ in range(256)]) / 256
    return out


if __name__ == "__main__":
    sys.exit(kernel_time.main(__doc__, __file__, run))
