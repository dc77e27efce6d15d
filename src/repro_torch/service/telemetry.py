"""Live telemetry: the scenario_report vocabulary as running counters.

One snapshot is a JSON dict in the same terms the offline reports use
— mean/tail sojourn, per-job slowdown distribution, Jain's fairness
index, goodput — plus service-only signals: admission counters, queue
depth, decision latency quantiles (wall seconds the engine spent
inside work-doing advances), current epsilon and worker liveness.
Clients pull one snapshot with ``{"op": "status"}`` or stream them
with ``{"op": "telemetry", ...}``.
"""

from __future__ import annotations

from repro_torch.core.metrics import (
    ecdf_quantiles,
    jain_index,
    slowdowns,
    tail_quantiles,
)


class Telemetry:
    """Counter registry; the master owns one and feeds it events."""

    def __init__(self, engine):
        self.engine = engine
        self.counters = {
            "submitted": 0,   # accepted into engine (admit or drained queue)
            "queued": 0,      # backpressured at offer time
            "rejected": 0,    # rate/queue-full rejections
            "deduped": 0,     # idempotent resubmits answered from the tag map
            "worker_crashes": 0,
            "worker_rejoins": 0,
        }
        #: job_id -> size (sum of task durations) for slowdown/goodput.
        self.size_of: dict[int, float] = {}

    def note_job(self, spec) -> None:
        self.counters["submitted"] += 1
        self.size_of[spec.job_id] = spec.size

    def snapshot(self, *, workers: dict | None = None) -> dict:
        sim = self.engine.sim
        res = sim.result
        soj = list(res.sojourn.values())
        slow = list(slowdowns(res, self.size_of).values())
        lat_ms = [s * 1e3 for s in self.engine.decision_latency_s]
        useful = sum(
            self.size_of[j] for j in res.completion if j in self.size_of
        )
        lost = (sim._injector.stats_dict() if sim._injector else {}).get(
            "work_lost_s", 0.0
        )
        return {
            "v_now": self.engine.virtual_now(),
            "jobs": {
                **self.counters,
                "completed": len(res.completion),
                "live": self.engine.live_jobs(),
            },
            "sojourn": {
                "mean_s": res.mean_sojourn(),
                **ecdf_quantiles(soj),
                **tail_quantiles(soj),
            },
            "slowdown": {
                **ecdf_quantiles(slow),
                **tail_quantiles(slow),
            },
            "fairness": {
                "jain_sojourn": jain_index(soj),
                "jain_slowdown": jain_index(slow),
            },
            "goodput": useful / (useful + lost) if useful + lost > 0 else 1.0,
            "decision_latency_ms": {
                "count": len(lat_ms),
                **ecdf_quantiles(lat_ms),
                **tail_quantiles(lat_ms),
            },
            "event_epsilon": sim.event_epsilon,
            "events": sim.events_processed,
            "passes": sim.passes,
            "workers": workers or {},
        }
