"""Scenario engine CLI (the port of ``python -m repro.scenarios``).

  python -m repro_torch.scenarios list
  python -m repro_torch.scenarios show paper-fb [--quick]
  python -m repro_torch.scenarios run  paper-fb [--quick] [--workers N]
                                 [--store results.jsonl] [--json out.json]
                                 [--max-cells N] [--device cuda|cpu]
  python -m repro_torch.scenarios export-trace fb --seed 0 --num-jobs 100 \
                                 --machines 100 --out trace.jsonl
  python -m repro_torch.scenarios replay trace.jsonl --policy hfsp [--machines 100]
                                 [--device cuda|cpu]
  python -m repro_torch.scenarios worker paper-fb --store shared.sqlite \
                                 [--quick] [--ttl 30] [--worker-id ID] \
                                 [--compute accel] [--accel-batch N]
                                 [--device cuda|cpu]
  python -m repro_torch.scenarios sweep-status paper-fb --store shared.sqlite \
                                 [--quick] [--json-out]

``run`` executes a named preset sweep (optionally at reduced --quick
scale), streaming per-cell progress, and prints the cross-cell matrix
summary.  With ``--store`` the sweep is resumable: re-running skips every
finished cell recorded in the store (a ``.sqlite``/``.db`` path selects
the sqlite backend — see repro_torch.scenarios.store).

``worker`` joins a *distributed* sweep: any number of worker processes,
on any machines sharing the store, claim cells under TTL'd leases and
converge the matrix exactly-once (docs/scenarios.md "Distributed
sweeps"); a store either package began, the other can finish.
``sweep-status`` is the read-only coordinator view: per-cell
done/leased/pending/quarantined state, per-worker liveness, and the
store's claim/reissue/duplicate counters.

``--device`` (``run``, ``worker``, ``replay``) is where the cells' kernels
run: ``cuda`` (the default) or ``cpu``.  Without a card, ``--device cuda``
exits 1 with the reason and runs nothing.  A failure of the card or of a
kernel ends ``run`` and ``worker`` non-zero; it is never stored as a
quarantined cell.  ``REPRO_VC_BACKEND`` (``numpy``, ``torch``, ``auto``)
picks the virtual clusters' backend of every cell whose spec leaves it
unset (``repro_torch.core.vcluster``).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch import DeviceError, resolve_device
from repro_torch.scenarios.presets import get_preset, list_presets, quick_sweep
from repro_torch.scenarios.report import matrix_report
from repro_torch.scenarios.runner import run_scenario
from repro_torch.scenarios.spec import (
    ClusterAxis,
    ScenarioSpec,
    SchedulerAxis,
    WorkloadAxis,
)
from repro_torch.scenarios.sweep import run_sweep
from repro_torch.scenarios.trace import export_trace


def _cmd_list(_args) -> int:
    for name in list_presets():
        sweep = get_preset(name)
        print(f"{name:24s} {len(sweep.expand()):3d} cells")
    return 0


def _cmd_show(args) -> int:
    sweep = get_preset(args.preset)
    if args.quick:
        sweep = quick_sweep(sweep)
    for cid, spec in sweep.expand():
        print(f"{cid}: {json.dumps(spec.to_dict(), sort_keys=True)}")
    return 0


def _cmd_run(args) -> int:
    sweep = get_preset(args.preset)
    if args.quick:
        sweep = quick_sweep(sweep)
    total = len(sweep.expand())
    print(f"== sweep {sweep.name}: {total} cells ==")

    def progress(cid: str, result: dict) -> None:
        if result.get("quarantined"):
            print(
                f"  {cid}: QUARANTINED after {result['attempts']} attempts "
                f"({result['error']})",
                flush=True,
            )
            return
        line = (
            f"  {cid}: mean_sojourn {result['mean_sojourn_s']:.1f}s  "
            f"makespan {result['makespan_s']:.0f}s  "
            f"wall {result['wall_s']:.2f}s"
        )
        if result.get("faults"):
            f = result["faults"]
            line += (
                f"  goodput {f['goodput']:.3f}  "
                f"retries {f['retries']}  spec_wins {f['speculative_wins']}"
            )
        print(line, flush=True)

    results = run_sweep(
        sweep,
        store=args.store,
        workers=args.workers,
        max_cells=args.max_cells,
        progress=progress,
        device=args.device,
    )
    matrix = matrix_report(results, expected=[cid for cid, _ in sweep.expand()])
    # Quarantined cells (self-healing sweep's poison records) carry no
    # metrics: matrix_report lists and excludes them; missing cells (a
    # --max-cells cut or an interrupted/partial distributed run) are
    # named so a degraded matrix states exactly what was dropped.
    means = matrix["mean_sojourn_s"]
    print(f"== matrix ({len(means)}/{total} cells) ==")
    for cid in sorted(means, key=lambda c: means[c]):
        print(f"  {cid}: mean_sojourn {means[cid]:.1f}s")
    for cid in matrix["quarantined"]:
        print(f"  {cid}: QUARANTINED ({results[cid]['error']})")
    for cid in matrix["missing"]:
        print(f"  {cid}: MISSING (not computed this run)")
    # Classify by the expanded spec, not the cell-id string: a grid that
    # does not sweep scheduler.policy produces ids without a policy key.
    policy_of = {cid: spec.scheduler.policy for cid, spec in sweep.expand()}
    hfsp_cells = [c for c in means if policy_of.get(c) == "hfsp"]
    other_cells = [c for c in means if policy_of.get(c) != "hfsp"]
    if hfsp_cells and other_cells:
        best_hfsp = min(means[c] for c in hfsp_cells)
        best_other = min(means[c] for c in other_cells)
        print(
            f"hfsp strictly lowest mean sojourn: {best_hfsp < best_other} "
            f"(hfsp {best_hfsp:.1f}s vs best-other {best_other:.1f}s)"
        )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {"sweep": sweep.name, "matrix": matrix, "cells": results},
                f, indent=2, sort_keys=True,
            )
        print(f"wrote {args.json}")
    return 0


def _cmd_worker(args) -> int:
    from repro_torch.scenarios.worker import run_worker

    sweep = get_preset(args.preset)
    if args.quick:
        sweep = quick_sweep(sweep)

    def progress(cid: str, result: dict) -> None:
        if result.get("quarantined"):
            print(f"  {cid}: QUARANTINED ({result['error']})", flush=True)
        else:
            print(
                f"  {cid}: mean_sojourn {result['mean_sojourn_s']:.1f}s  "
                f"wall {result['wall_s']:.2f}s",
                flush=True,
            )

    summary = run_worker(
        sweep,
        args.store,
        worker_id=args.worker_id,
        ttl=args.ttl,
        renew_every=args.renew_every,
        timeout=args.timeout,
        max_retries=args.max_retries,
        retry_backoff=args.retry_backoff,
        poll=args.poll,
        max_cells=args.max_cells,
        deadline=args.deadline,
        progress=progress,
        compute=args.compute,
        accel_batch=args.accel_batch,
        device=args.device,
    )
    print(json.dumps(summary, indent=2, sort_keys=True))
    return 1 if summary["stalled"] else 0


def _cmd_sweep_status(args) -> int:
    from repro_torch.scenarios.coordinator import format_status, sweep_status

    sweep = get_preset(args.preset)
    if args.quick:
        sweep = quick_sweep(sweep)
    status = sweep_status(sweep, args.store, dead_after=args.dead_after)
    if args.json_out:
        print(json.dumps(status, indent=2, sort_keys=True))
    else:
        print(format_status(status))
    return 0


def _cmd_export_trace(args) -> int:
    spec = ScenarioSpec(
        name=f"{args.kind}-trace",
        workload=WorkloadAxis(
            kind=args.kind, seed=args.seed, num_jobs=args.num_jobs
        ),
        cluster=ClusterAxis(num_machines=args.machines),
    )
    from repro_torch.scenarios.runner import build_workload

    jobs, class_of = build_workload(spec)
    meta = {
        "generator": args.kind,
        "seed": args.seed,
        "num_jobs": args.num_jobs,
        "num_machines": args.machines,
    }
    export_trace(args.out, jobs, class_of, meta)
    n_tasks = sum(len(j.map_tasks) + len(j.reduce_tasks) for j in jobs)
    print(f"wrote {args.out}: {len(jobs)} jobs, {n_tasks} tasks")
    return 0


def _cmd_replay(args) -> int:
    spec = ScenarioSpec(
        name=f"replay-{args.policy}",
        workload=WorkloadAxis(kind="trace", trace_path=args.trace),
        cluster=ClusterAxis(num_machines=args.machines),
        scheduler=SchedulerAxis(policy=args.policy),
    )
    result = run_scenario(spec, device=args.device)
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0


def _device_flag(p) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the cells' kernels run (default cuda; "
                        "without a card, cuda exits 1)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.scenarios",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list registered presets")

    p = sub.add_parser("show", help="print a preset's expanded cells")
    p.add_argument("preset")
    p.add_argument("--quick", action="store_true")

    p = sub.add_parser("run", help="run a preset sweep")
    p.add_argument("preset")
    p.add_argument("--quick", action="store_true",
                   help="reduced-scale smoke variant")
    p.add_argument("--workers", type=int, default=0,
                   help="worker processes (0/1 = inline)")
    p.add_argument("--store", default=None, metavar="PATH",
                   help="resumable JSONL result store")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="write the matrix + per-cell reports as JSON")
    p.add_argument("--max-cells", type=int, default=None,
                   help="compute at most N new cells (testing/resume demos)")
    _device_flag(p)

    p = sub.add_parser(
        "worker",
        help="join a distributed sweep: claim cells under leases from a "
             "shared store until the matrix converges",
    )
    p.add_argument("preset")
    p.add_argument("--store", required=True, metavar="PATH",
                   help="shared result store (JSONL, or .sqlite/.db for "
                        "the sqlite backend)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--worker-id", default=None,
                   help="unique worker name (default hostname-pid)")
    p.add_argument("--ttl", type=float, default=30.0,
                   help="lease TTL seconds; a dead worker's cells are "
                        "reclaimable this long after its last renewal")
    p.add_argument("--renew-every", type=float, default=None,
                   help="lease renewal interval (default ttl/3)")
    p.add_argument("--poll", type=float, default=0.5,
                   help="idle wait when all pending cells are leased")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="per-attempt wall-clock budget (seconds)")
    p.add_argument("--max-retries", type=int, default=2)
    p.add_argument("--retry-backoff", type=float, default=0.5)
    p.add_argument("--max-cells", type=int, default=None,
                   help="compute at most N cells then exit")
    p.add_argument("--deadline", type=float, default=None,
                   help="total wall-clock bound; exit stalled (rc 1) on "
                        "expiry instead of waiting on foreign leases")
    p.add_argument("--compute", choices=("python", "accel"),
                   default="python",
                   help="cell executor: per-cell spawned Python attempts "
                        "(default), or the batched accel path with "
                        "per-cell Python fallback on unsupported spec "
                        "axes (docs/accel.md)")
    p.add_argument("--accel-batch", type=int, default=32,
                   help="max accel-eligible cells claimed into one "
                        "device batch")
    _device_flag(p)

    p = sub.add_parser(
        "sweep-status",
        help="read-only coordinator view of a distributed sweep's store",
    )
    p.add_argument("preset")
    p.add_argument("--store", required=True, metavar="PATH")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--json-out", action="store_true",
                   help="machine-readable JSON instead of the text view")
    p.add_argument("--dead-after", type=float, default=60.0,
                   help="heartbeat age (seconds) past which a worker is "
                        "reported dead")

    p = sub.add_parser("export-trace", help="synthesize + export a trace")
    p.add_argument("kind", choices=("fb", "fb_scaled", "ml"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-jobs", type=int, default=100)
    p.add_argument("--machines", type=int, default=100)
    p.add_argument("--out", required=True)

    p = sub.add_parser("replay", help="replay a JSONL trace")
    p.add_argument("trace")
    # Any registered discipline replays.  No argparse `choices`: policy
    # names validate lazily against the discipline registry at build
    # time (repro_torch.scenarios.runner.build_scheduler), whose KeyError
    # lists what IS registered — snapshotting the registry here would
    # reject disciplines registered after import.
    from repro_torch.core import disciplines

    p.add_argument(
        "--policy", default="hfsp",
        help=f"scheduling discipline (registered: "
             f"{', '.join(disciplines.names())}, or any name registered "
             f"from user code)",
    )
    p.add_argument("--machines", type=int, default=100)
    _device_flag(p)

    args = ap.parse_args(argv)
    try:
        if getattr(args, "device", None) is not None:
            resolve_device(args.device)
    except DeviceError as e:
        print(f"repro_torch.scenarios: {e}", file=sys.stderr)
        return 1
    return {
        "list": _cmd_list,
        "show": _cmd_show,
        "run": _cmd_run,
        "worker": _cmd_worker,
        "sweep-status": _cmd_sweep_status,
        "export-trace": _cmd_export_trace,
        "replay": _cmd_replay,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
