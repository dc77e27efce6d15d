"""Report layer: reduce simulation outcomes to machine-readable JSON.

One report per scenario cell (:func:`scenario_report`) plus cross-cell
reductions (:func:`matrix_report`, :func:`per_job_delta_summary`) for the
policy-comparison matrices of Sect. 4.  All values are plain
JSON-serializable types — ``benchmarks/run.py`` embeds them into
``BENCH_sched.json`` and ``scripts/bench_gate.py`` tracks the recorded
per-scenario mean sojourns across PRs (policy-level regressions, not just
wall-clock).
"""

from __future__ import annotations

from repro_torch.core.simulator import SimResult
from repro_torch.core.metrics import (
    SojournSummary,
    ecdf_quantiles,
    jain_index,
    per_class_sojourns,
    per_job_delta,
    slowdowns,
    tail_quantiles,
)
from repro_torch.scenarios.spec import ScenarioSpec


def completion_fingerprint(res: SimResult) -> int:
    """Order-insensitive hash of the full completion schedule — two runs
    with equal fingerprints produced bit-identical completions."""
    return hash(tuple(sorted(res.completion.items())))


def _summary_dict(s: SojournSummary) -> dict:
    return {
        "mean_s": s.mean, "median_s": s.median, "p95_s": s.p95, "count": s.count,
    }


def scenario_report(
    spec: ScenarioSpec,
    res: SimResult,
    jobs,
    class_of: dict[int, str],
    scheduler,
    wall_s: float,
) -> dict:
    """The canonical per-cell result record."""
    soj = res.sojourn
    size_of = {j.job_id: j.size for j in jobs}
    slow = slowdowns(res, size_of)
    per_class = {
        cls: {
            **_summary_dict(SojournSummary.of(vals)),
            "ecdf": ecdf_quantiles(vals),
        }
        for cls, vals in sorted(per_class_sojourns(res, class_of).items())
    }
    st = scheduler.stats
    # Preemption-hysteresis / what-if diagnostics (engine-family
    # schedulers expose whatif_diagnostics(); fifo/fair have none): how
    # often the discipline's preemption policy priced a batched what-if
    # projection (rank_stability), how often it vetoed, PSBS late-job
    # re-injections — the per-cell observability the ROADMAP's
    # "scenario-level what-if reports" item asked for.
    diag = getattr(scheduler, "whatif_diagnostics", None)
    whatif = diag() if callable(diag) else None
    # Fault-layer block (None for fault-free cells): injector counters
    # plus goodput = useful / (useful + lost) where useful is the total
    # size of completed jobs and lost is the work thrown away on
    # failures, crashes, and losing speculative copies.
    faults = None
    if res.faults is not None:
        useful = sum(size_of[j] for j in res.completion if j in size_of)
        lost = res.faults.get("work_lost_s", 0.0)
        faults = dict(res.faults)
        faults["goodput"] = (
            useful / (useful + lost) if useful + lost > 0 else 1.0
        )
    return {
        "spec": spec.to_dict(),
        "wall_s": round(wall_s, 3),
        "makespan_s": res.makespan,
        "jobs_completed": len(res.completion),
        "jobs_lost": len(jobs) - len(res.completion),
        "mean_sojourn_s": res.mean_sojourn(),
        "sojourn": {
            **_summary_dict(SojournSummary.of(list(soj.values()))),
            "ecdf": ecdf_quantiles(list(soj.values())),
        },
        "per_class": per_class,
        "slowdown": {
            **_summary_dict(SojournSummary.of(list(slow.values()))),
            "ecdf": ecdf_quantiles(list(slow.values())),
        },
        # Extreme tails + Jain's fairness index (ROADMAP "fairness and
        # tails"): p99/p999 of the sojourn and per-job-slowdown
        # distributions, and the fairness index over slowdowns (1.0 =
        # every job slowed equally; 1/n = one job absorbed all the
        # queueing).  These double as the live service's telemetry
        # counters (src/repro/service/telemetry.py).
        "tails": {
            "sojourn": tail_quantiles(list(soj.values())),
            "slowdown": tail_quantiles(list(slow.values())),
        },
        "fairness": {
            "jain_sojourn": jain_index(list(soj.values())),
            "jain_slowdown": jain_index(list(slow.values())),
        },
        "locality_fraction": res.locality_fraction,
        "completion_fingerprint": completion_fingerprint(res),
        # Scheduler-overhead counters: the epsilon-window axis trades
        # pass count (overhead) against sojourn quality; sweeps read the
        # tradeoff per cell from here.
        "events": res.events,
        "scheduler_passes": res.passes,
        "passes_per_event": round(res.passes / res.events, 4) if res.events else 0.0,
        "whatif": whatif,
        "faults": faults,
        "stats": {
            "suspensions": st.suspensions,
            "resumes": st.resumes,
            "kills": st.kills,
            "waits": st.waits,
            "delay_sched_waits": st.delay_sched_waits,
            "training_tasks": st.training_tasks,
            "hysteresis_fallbacks": st.hysteresis_fallbacks,
        },
    }


def per_job_delta_summary(a: SimResult, b: SimResult) -> dict:
    """Cross-policy per-job sojourn deltas (a - b; positive = b better),
    the Fig. 4 dominance summary in JSON form."""
    delta = per_job_delta(a, b)
    if not delta:
        return {"jobs": 0}
    vals = sorted(delta.values())
    return {
        "jobs": len(vals),
        "b_better_or_equal": sum(1 for v in vals if v >= -1.0),
        "max_gain_s": vals[-1],
        "max_loss_s": -vals[0],
        "ecdf": ecdf_quantiles(vals),
    }


def matrix_report(cells: dict[str, dict], expected=None) -> dict:
    """Cross-cell reduction over one sweep's finished cells.

    ``cells`` maps cell_id -> scenario_report dict.  Returns a compact
    comparison: per-cell mean sojourn plus pairwise mean ratios — the
    "HFSP strictly lowest" acceptance check reads this.

    Quarantined cells (the self-healing sweep runner's poison-cell
    records, ``{"quarantined": True, ...}``) carry no metrics: they are
    listed under ``"quarantined"`` and excluded from the comparison.

    ``expected`` (optional iterable of cell ids — typically the sweep's
    full expansion) makes degradation explicit: cells expected but
    absent from ``cells`` (dead workers, interrupted run, ``max_cells``
    cut) are listed under ``"missing"``, so a partial matrix states
    exactly what was dropped instead of silently comparing fewer cells.
    """
    missing = (
        sorted(set(expected) - set(cells)) if expected is not None else []
    )
    quarantined = sorted(c for c, r in cells.items() if r.get("quarantined"))
    cells = {c: r for c, r in cells.items() if not r.get("quarantined")}
    means = {cid: c["mean_sojourn_s"] for cid, c in cells.items()}
    ranked = sorted(means, key=lambda c: means[c])
    ratios = {}
    if ranked:
        best = ranked[0]
        for cid in ranked[1:]:
            if means[best] > 0:
                ratios[f"{cid}/{best}"] = means[cid] / means[best]
    return {
        "cells": len(cells),
        "quarantined": quarantined,
        "missing": missing,
        "mean_sojourn_s": means,
        "best": ranked[0] if ranked else None,
        "mean_ratio_vs_best": ratios,
    }
