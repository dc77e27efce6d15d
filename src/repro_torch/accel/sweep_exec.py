"""Batched sweep executor: ScenarioSpec batches on the device.

Port of ``repro.accel.sweep_exec``: synthesize each eligible spec's
workload host-side into a flat padded event window (the same
``build_workload`` path the reference uses, so the trace is identical),
stack cells into one ``(B, J)`` batch, and run the whole matrix through
:func:`repro_torch.accel.cell_step.run_packed`.

:func:`accel_eligible` is the single authority on which specs the fluid
cell represents.  :func:`run_sweep_accel` runs every other cell through
the discrete-event simulator, one cell at a time
(:func:`repro_torch.scenarios.runner.run_scenario`, on the same device),
as the reference does.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.accel.cell_step import (
    POLICY_CODES,
    pack_cells,
    params_from_numpy,
    run_packed,
    summarize,
)
from repro_torch.core.simulator import auto_event_epsilon
from repro_torch.scenarios.spec import ScenarioSpec, SweepSpec

#: Workload kinds the fluid cell can represent (generator-backed, equal
#: per-phase task durations at task_jitter=0).
_ACCEL_KINDS = ("fb", "fb_scaled")


def accel_eligible(spec: ScenarioSpec) -> tuple[bool, str]:
    """(eligible, reason-if-not)."""
    if spec.workload.kind not in _ACCEL_KINDS:
        return False, f"workload kind {spec.workload.kind!r}"
    if spec.workload.task_jitter != 0.0:
        return False, "task_jitter != 0 (unequal per-phase durations)"
    if spec.scheduler.policy not in POLICY_CODES:
        return False, f"policy {spec.scheduler.policy!r}"
    if spec.scheduler.preemption != "eager":
        return False, f"preemption {spec.scheduler.preemption!r}"
    if spec.cluster.dma_bandwidth != 0.0:
        return False, "dma_bandwidth != 0 (preemption cost model)"
    if spec.faults.enabled:
        return False, "fault injection enabled"
    return True, ""


def _resolve_eps(spec: ScenarioSpec, arrivals: list[float]) -> float:
    eps = spec.event_epsilon
    if eps == "auto":
        return auto_event_epsilon(arrivals, spec.heartbeat)
    return float(eps)


def synthesize_cell(spec: ScenarioSpec) -> dict:
    """Materialize one eligible spec into flat cell params (numpy),
    bitwise equal to the reference's ``synthesize_cell``.

    Raises ``ValueError`` if the materialized workload violates the fluid
    contract (unequal per-phase durations, non-uniform weights)."""
    from repro_torch.scenarios.runner import build_cluster, build_workload

    jobs, _ = build_workload(spec)
    cluster = build_cluster(spec)
    j = len(jobs)

    def phase_arrays(tasks_of):
        n = np.zeros(j)
        d = np.ones(j)
        for i, job in enumerate(jobs):
            tasks = tasks_of(job)
            n[i] = len(tasks)
            if tasks:
                durs = {t.duration for t in tasks}
                if len(durs) > 1:
                    raise ValueError(
                        "unequal per-phase task durations; accel cell "
                        "requires task_jitter=0 generator workloads"
                    )
                d[i] = max(tasks[0].duration, 1e-9)
        return n, d

    m_n, m_d = phase_arrays(lambda job: job.map_tasks)
    r_n, r_d = phase_arrays(lambda job: job.reduce_tasks)
    weight = np.array([job.weight for job in jobs], np.float64)
    if j and not np.all(weight == weight[0]):
        raise ValueError("non-uniform job weights; accel fifo/srpt/las "
                         "keys ignore weight")
    if any(job.reduce_slowstart != 1.0 for job in jobs):
        raise ValueError("reduce_slowstart != 1.0")
    arrival = np.array([job.arrival_time for job in jobs], np.float64)

    alpha = spec.scheduler.error_alpha
    if alpha != 0.0:
        # Fig. 6 error model: one numpy draw per phase estimate, in
        # job-id order, from default_rng(error_seed) — the reference's
        # draws exactly (never torch's RNG).
        rng = np.random.default_rng(spec.scheduler.error_seed)
        factors = rng.uniform(1.0 - alpha, 1.0 + alpha, size=(j, 2))
        est_m = np.maximum(m_n * m_d * factors[:, 0], 1e-9)
        est_r = np.maximum(r_n * r_d * factors[:, 1], 1e-9)
    else:
        est_m = m_n * m_d
        est_r = r_n * r_d

    policy = spec.scheduler.policy
    return {
        "arrival": arrival,
        "m_work": m_n * m_d,
        "m_dur": m_d,
        "m_tasks": m_n,
        "r_work": r_n * r_d,
        "r_dur": r_d,
        "r_tasks": r_n,
        "est_m": est_m,
        "est_r": est_r,
        "weight": weight,
        "present": np.ones(j, np.float64),
        "policy": np.int32(POLICY_CODES[policy]),
        "map_slots": np.float64(
            cluster.num_machines * cluster.map_slots_per_machine
        ),
        "red_slots": np.float64(
            cluster.num_machines * cluster.reduce_slots_per_machine
        ),
        # fifo's order is static (arrival): the only dt events are
        # arrivals and completions.  The size/age-evolving policies
        # re-rank once per executor heartbeat.
        "dt_cap": np.float64(
            np.inf if policy == "fifo" else spec.heartbeat
        ),
        "eps": np.float64(_resolve_eps(spec, [jb.arrival_time for jb in jobs])),
    }


def run_cells_accel(
    specs: list[ScenarioSpec],
    *,
    impl: str | None = None,
    t_chunk: int = 512,
    max_chunks: int = 256,
    on_chunk=None,
    device="cuda",
    cells: list[dict] | None = None,
) -> list[dict]:
    """Run eligible specs as one batch per compute class on ``device``;
    returns scenario-report-compatible summary dicts in spec order.

    ``impl`` picks the hfsp water-fill (``"cuda"``, ``"torch"``; default
    by device, see :mod:`repro_torch.accel.cell_step`).  ``cells`` are
    the specs' :func:`synthesize_cell` results where the caller already
    made them (in spec order); otherwise they are made here.  ``wall_s``
    is the batch wall divided evenly across cells — the cells ran
    concurrently, so per-cell wall is an accounting convention."""
    dev = resolve_device(device)
    if not specs:
        return []

    # Group cells by compute class: non-hfsp cells never read the
    # virtual layer, so their batch skips the water-fill entirely.
    def _klass(spec: ScenarioSpec) -> str:
        return "hfsp" if spec.scheduler.policy == "hfsp" else "plain"

    out: list[dict | None] = [None] * len(specs)
    for klass in ("plain", "hfsp"):
        idx = [i for i, s in enumerate(specs) if _klass(s) == klass]
        if not idx:
            continue
        t0 = time.perf_counter()
        batch = [synthesize_cell(specs[i]) if cells is None else cells[i]
                 for i in idx]
        packed = pack_cells(batch)
        final = run_packed(
            params_from_numpy(packed, dev),
            t_chunk=t_chunk,
            max_chunks=max_chunks,
            impl=impl if klass == "hfsp" else "none",
            on_chunk=on_chunk,
        )
        wall = time.perf_counter() - t0
        for i, cell, summ in zip(idx, batch, summarize(packed, final)):
            out[i] = {
                "spec": specs[i].to_dict(),
                "wall_s": round(wall / len(idx), 3),
                "compute": "accel",
                "event_epsilon_resolved": float(cell["eps"]),
                **summ,
            }
    return out


def run_sweep_accel(
    sweep: SweepSpec,
    *,
    impl: str | None = None,
    t_chunk: int = 512,
    max_chunks: int = 256,
    progress=None,
    device="cuda",
) -> dict[str, dict]:
    """Expand a sweep and run it on ``device``: eligible cells in batches,
    the rest through the simulator per cell (``run_scenario``, whose
    virtual cluster runs its kernels on the same device)."""
    from repro_torch.scenarios.runner import run_scenario

    resolve_device(device)
    cells = sweep.expand()
    eligible: list[tuple[str, ScenarioSpec]] = []
    synthesized: list[dict] = []
    results: dict[str, dict] = {}
    for cid, spec in cells:
        ok, _reason = accel_eligible(spec)
        if ok:
            try:
                synthesized.append(synthesize_cell(spec))
            except ValueError:
                ok = False
        if ok:
            eligible.append((cid, spec))
        else:
            results[cid] = run_scenario(spec, device=device)
            if progress:
                progress(cid, results[cid])
    if eligible:
        batch = run_cells_accel(
            [s for _, s in eligible],
            impl=impl,
            t_chunk=t_chunk,
            max_chunks=max_chunks,
            device=device,
            cells=synthesized,
        )
        for (cid, _), res in zip(eligible, batch):
            results[cid] = res
            if progress:
                progress(cid, res)
    return results
