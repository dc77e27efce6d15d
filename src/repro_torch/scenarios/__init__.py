"""Scenario engine: declarative experiment matrix, trace replay, sweeps.

The port of ``repro.scenarios``, with the reference's exports; every
entry point that runs a cell takes ``device`` (``"cuda"`` unless asked
for ``"cpu"``).  The subsystem that owns "an experiment" (see
docs/scenarios.md):

* :mod:`repro_torch.scenarios.spec`    — ScenarioSpec / SweepSpec (the axes);
* :mod:`repro_torch.scenarios.presets` — named sweeps (the paper's matrix);
* :mod:`repro_torch.scenarios.trace`   — versioned JSONL trace export/replay;
* :mod:`repro_torch.scenarios.runner`  — one cell -> simulator -> report;
* :mod:`repro_torch.scenarios.sweep`   — parallel, resumable grid execution;
* :mod:`repro_torch.scenarios.store`   — pluggable shared-store backends
  (fsync'd JSONL reference, sqlite for concurrent writers);
* :mod:`repro_torch.scenarios.lease`   — TTL'd cell-claim protocol;
* :mod:`repro_torch.scenarios.worker`  — distributed lease-claiming worker;
* :mod:`repro_torch.scenarios.coordinator` — ``sweep-status`` progress view;
* :mod:`repro_torch.scenarios.report`  — machine-readable JSON reductions.

CLI: ``python -m repro_torch.scenarios run paper-fb --quick``;
distributed: ``python -m repro_torch.scenarios worker paper-fb --store
shared.sqlite``.
"""

from repro_torch.scenarios.presets import (
    get_preset,
    list_presets,
    paper_fb_base,
    quick_sweep,
    register_preset,
)
from repro_torch.scenarios.report import matrix_report, scenario_report
from repro_torch.scenarios.runner import run_scenario, simulate
from repro_torch.scenarios.spec import (
    ClusterAxis,
    FaultAxis,
    ScenarioSpec,
    SchedulerAxis,
    SweepSpec,
    WorkloadAxis,
)
from repro_torch.scenarios.coordinator import sweep_status
from repro_torch.scenarios.store import ResultStore, SqliteResultStore, open_store
from repro_torch.scenarios.sweep import run_sweep
from repro_torch.scenarios.trace import export_trace, load_trace
from repro_torch.scenarios.worker import run_worker

__all__ = [
    "ClusterAxis",
    "FaultAxis",
    "ResultStore",
    "SqliteResultStore",
    "ScenarioSpec",
    "SchedulerAxis",
    "SweepSpec",
    "WorkloadAxis",
    "export_trace",
    "get_preset",
    "list_presets",
    "load_trace",
    "matrix_report",
    "open_store",
    "paper_fb_base",
    "quick_sweep",
    "register_preset",
    "run_scenario",
    "run_sweep",
    "run_worker",
    "scenario_report",
    "simulate",
    "sweep_status",
]
