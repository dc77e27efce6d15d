"""Materialize one scenario cell's workload and cluster.

The workload half of ``repro.scenarios.runner``: ``build_workload`` and
``build_cluster`` for the generator kinds the accel path runs (``fb`` and
``fb_scaled``).  Running a cell through the discrete-event simulator
(``run_scenario``) arrives with the simulator slice of the port.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.types import ClusterSpec, JobSpec
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.workload import WorkloadSpec, fb_dataset, fb_scaled_dataset

#: Workload kinds this slice does not materialize yet, and the ROADMAP
#: item (Queue 1) that brings each.
_LATER_KINDS = {
    "ml": "ROADMAP.md Queue 1 item 6 (ML-job substrate)",
    "trace": "ROADMAP.md Queue 1 item 3 (discrete-event path: trace replay)",
}


def build_workload(spec: ScenarioSpec) -> tuple[list[JobSpec], dict[int, str]]:
    """Jobs + class_of for the spec's workload axis."""
    w = spec.workload
    num_hosts = w.num_hosts or spec.cluster.num_machines
    if w.kind == "fb":
        wspec = WorkloadSpec(
            num_machines=num_hosts, task_jitter=w.task_jitter
        )
        jobs, class_of = fb_dataset(
            seed=w.seed, num_jobs=w.num_jobs, spec=wspec
        )
    elif w.kind == "fb_scaled":
        wspec = WorkloadSpec(task_jitter=w.task_jitter)
        jobs, class_of = fb_scaled_dataset(
            seed=w.seed,
            num_jobs=w.num_jobs,
            num_machines=num_hosts,
            spec=wspec,
        )
    elif w.kind in _LATER_KINDS:
        raise NotImplementedError(
            f"workload kind {w.kind!r} is not ported yet; it comes with "
            f"{_LATER_KINDS[w.kind]}"
        )
    else:  # pragma: no cover - WorkloadAxis validates
        raise ValueError(f"unknown workload kind {w.kind!r}")
    if w.map_only:
        jobs = [dataclasses.replace(j, reduce_tasks=()) for j in jobs]
    return jobs, class_of


def build_cluster(spec: ScenarioSpec) -> ClusterSpec:
    c = spec.cluster
    return ClusterSpec(
        num_machines=c.num_machines,
        map_slots_per_machine=c.map_slots,
        reduce_slots_per_machine=c.reduce_slots,
        dma_bandwidth=c.dma_bandwidth,
    )
