"""Materialize and run one scenario cell.

A copy of ``repro.scenarios.runner``.  ``run_scenario(spec)`` is the
single choke point between the declarative layer and the simulator: it
synthesizes (or replays) the workload, builds the cluster and scheduler
from the spec's axes, runs the discrete-event simulation, and returns a
machine-readable report dict (see :mod:`repro_torch.scenarios.report`).

The port adds one argument, ``device``: where the torch virtual cluster's
kernels run.  It is not a spec field, so cell ids and spec hashes stay the
reference's.  ``run_scenario`` and ``simulate`` resolve it first, so a
CUDA request without CUDA raises whatever the spec's backend.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch import resolve_device
from repro_torch.core import (
    ClusterSpec,
    FaultModel,
    SimConfig,
    SimResult,
    Simulator,
    disciplines,
)
from repro_torch.core.types import JobSpec
from repro_torch.scenarios.report import scenario_report
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.workload import (
    WorkloadSpec,
    fb_dataset,
    fb_scaled_dataset,
    job_class,
    ml_dataset,
)

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
    elif w.kind == "ml":
        jobs, class_of = ml_dataset(seed=w.seed, num_jobs=w.num_jobs)
    elif w.kind == "trace":
        from repro_torch.scenarios.trace import load_trace

        jobs, class_of, _ = load_trace(w.trace_path)
        if not class_of:
            class_of = {
                j.job_id: job_class(len(j.map_tasks)) for j in jobs
            }
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


def build_scheduler(spec: ScenarioSpec, cluster: ClusterSpec, *,
                    device: str = "cuda"):
    """Resolve the spec's policy name against the discipline registry
    (:mod:`repro_torch.core.disciplines`) and build the scheduler; an
    unknown name raises ``KeyError`` listing the registered disciplines.
    ``device`` reaches ``HFSPConfig.vc_device``."""
    s = spec.scheduler
    return disciplines.build_scheduler(
        s.policy,
        cluster,
        preemption=s.preemption,
        sample_set_size=s.sample_set_size,
        delta=s.delta,
        error_alpha=s.error_alpha,
        error_seed=s.error_seed,
        vc_backend=s.vc_backend,
        vc_device=device,
        psbs_late_factor=s.psbs_late_factor,
        psbs_max_spread=s.psbs_max_spread,
    )


def _materialize_and_run(
    spec: ScenarioSpec, device: str,
) -> tuple[SimResult, dict[int, str], object, list[JobSpec]]:
    """The one cell-materialization sequence (every consumer goes
    through here so a scenario's meaning cannot fork)."""
    resolve_device(device)
    cluster = build_cluster(spec)
    jobs, class_of = build_workload(spec)
    sch = build_scheduler(spec, cluster, device=device)
    # FaultAxis mirrors FaultModel field-for-field; only an enabled axis
    # reaches the simulator (a disabled one must leave the executor
    # bit-identical to a pre-fault build).
    fm = (
        FaultModel(**dataclasses.asdict(spec.faults))
        if spec.faults.enabled
        else None
    )
    res = Simulator(
        cluster,
        sch,
        jobs,
        config=SimConfig(
            heartbeat=spec.heartbeat,
            event_epsilon=spec.event_epsilon,
            faults=fm,
        ),
    ).run()
    return res, class_of, sch, jobs


def simulate(
    spec: ScenarioSpec, *, device: str = "cuda"
) -> tuple[SimResult, dict[int, str], object]:
    """Run the cell; returns (SimResult, class_of, scheduler)."""
    res, class_of, sch, _ = _materialize_and_run(spec, device)
    return res, class_of, sch


def run_scenario(spec: ScenarioSpec, *, device: str = "cuda") -> dict:
    """Run one cell and reduce it to the machine-readable report dict."""
    t0 = time.time()
    res, class_of, sch, jobs = _materialize_and_run(spec, device)
    wall = time.time() - t0
    return scenario_report(spec, res, jobs, class_of, sch, wall)
