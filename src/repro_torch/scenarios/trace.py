"""Versioned JSONL trace schema: export, import, and replay adapters.

A *trace* is a fully-materialized workload — every job with its exact
arrival time and per-task durations/placement — serialized one job per
line so external traces (or previously-synthesized golden workloads) run
through the same :class:`~repro_torch.core.simulator.Simulator` as a
first-class scenario (``WorkloadAxis(kind="trace", trace_path=...)``).

Format (JSON Lines):

* line 1 — header::

      {"kind": "repro-trace", "version": 1, "meta": {...}}

  ``meta`` is free-form provenance (generator name/seed, suggested
  cluster shape, job classes).
* lines 2.. — one job each::

      {"job_id": 0, "arrival_time": 1.5, "name": "fb-small-0",
       "weight": 1.0, "reduce_slowstart": 1.0,
       "map":    [[duration, [input_hosts...], state_bytes], ...],
       "reduce": [[duration, [],               state_bytes], ...]}

Round-trip fidelity is *bit-exact*: floats are emitted via ``json`` (which
uses ``repr`` — the shortest string that parses back to the identical
IEEE-754 double), so export -> import -> replay reproduces the original
schedule to the last bit (pinned by tests/test_scenarios.py).
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.core.types import JobSpec, Phase, TaskSpec

TRACE_KIND = "repro-trace"
TRACE_VERSION = 1


def export_trace(
    path: str | Path,
    jobs: list[JobSpec],
    class_of: dict[int, str] | None = None,
    meta: dict | None = None,
) -> Path:
    """Write ``jobs`` as a versioned JSONL trace; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = {
        "kind": TRACE_KIND,
        "version": TRACE_VERSION,
        "meta": dict(meta or {}),
    }
    if class_of is not None:
        # JSON object keys are strings; parse back to int on load.
        header["class_of"] = {str(j): c for j, c in class_of.items()}
    with path.open("w") as f:
        f.write(json.dumps(header, sort_keys=True) + "\n")
        for job in sorted(jobs, key=lambda j: (j.arrival_time, j.job_id)):
            f.write(json.dumps(_job_record(job), sort_keys=True) + "\n")
    return path


def load_trace(
    path: str | Path,
) -> tuple[list[JobSpec], dict[int, str], dict]:
    """Read a JSONL trace; returns (jobs, class_of, meta)."""
    path = Path(path)
    with path.open() as f:
        first = f.readline()
        if not first.strip():
            raise ValueError(f"{path}: empty trace file")
        header = json.loads(first)
        if header.get("kind") != TRACE_KIND:
            raise ValueError(
                f"{path}: not a {TRACE_KIND} file (kind={header.get('kind')!r})"
            )
        if header.get("version") != TRACE_VERSION:
            raise ValueError(
                f"{path}: trace version {header.get('version')!r} != "
                f"supported {TRACE_VERSION}"
            )
        jobs = []
        for ln in f:
            if not ln.strip():
                continue
            d = json.loads(ln)
            if "event" in d:
                # Live-session journal entry (repro_torch.service.journal):
                # advance barriers, scripted faults, epsilon retunes.
                # Skipping them makes a journal double as a plain trace
                # (the recorded workload replays as a scenario cell).
                continue
            jobs.append(_job_from_record(d))
    class_of = {int(j): c for j, c in header.get("class_of", {}).items()}
    return jobs, class_of, header.get("meta", {})


# ---------------------------------------------------------------------------
# (de)serialization of one job
# ---------------------------------------------------------------------------
def _task_record(t: TaskSpec) -> list:
    return [t.duration, list(t.input_hosts), t.state_bytes]


def _job_record(job: JobSpec) -> dict:
    return {
        "job_id": job.job_id,
        "arrival_time": job.arrival_time,
        "name": job.name,
        "weight": job.weight,
        "reduce_slowstart": job.reduce_slowstart,
        "map": [_task_record(t) for t in job.map_tasks],
        "reduce": [_task_record(t) for t in job.reduce_tasks],
    }


def _tasks_from_records(
    job_id: int, phase: Phase, records: list
) -> tuple[TaskSpec, ...]:
    return tuple(
        TaskSpec(
            job_id=job_id,
            phase=phase,
            index=i,
            duration=float(dur),
            input_hosts=tuple(int(h) for h in hosts),
            state_bytes=int(state_bytes),
        )
        for i, (dur, hosts, state_bytes) in enumerate(records)
    )


def _job_from_record(d: dict) -> JobSpec:
    jid = int(d["job_id"])
    return JobSpec(
        job_id=jid,
        arrival_time=float(d["arrival_time"]),
        map_tasks=_tasks_from_records(jid, Phase.MAP, d.get("map", [])),
        reduce_tasks=_tasks_from_records(jid, Phase.REDUCE, d.get("reduce", [])),
        weight=float(d.get("weight", 1.0)),
        name=d.get("name", ""),
        reduce_slowstart=float(d.get("reduce_slowstart", 1.0)),
    )


# Public aliases for the live-service journal (repro_torch.service.journal),
# which writes job lines in this exact schema so a recorded session is
# itself a loadable trace.  Unknown keys (the journal's "user"/"tag"
# annotations) are ignored by job_from_record by construction.
job_record = _job_record
job_from_record = _job_from_record
