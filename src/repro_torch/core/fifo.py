"""The default Hadoop scheduler: FIFO with optional priorities (Sect. 2.2).

"Task assignment is accomplished by scanning through all jobs that are
waiting to be scheduled, in order of priority and job submission time."
No preemption; delay scheduling is NOT part of the stock FIFO scheduler
(it greedily prefers local tasks among the chosen job's pending tasks but
never waits).

Performance: the queue order ``(-weight, arrival_time, job_id)`` is
maintained as a per-phase sorted index updated on arrival (and on the
REDUCE slow-start unlock) instead of re-sorting every live job on every
pass.  FIFO itself never preempts, so in practice a job leaves the
pending set once and dead queue entries are dropped lazily (amortized
compaction); the public ``on_task_killed`` hook — which re-adds pending
demand — re-enqueues if the entry was already compacted away.  A pass
costs O(slots assigned + dead entries scanned), not
O(live jobs x log(live jobs)).
"""

from __future__ import annotations

import bisect

from repro_torch.core.disciplines import ArrivalRank
from repro_torch.core.scheduler import (
    Action,
    ClusterView,
    Scheduler,
    SchedulerConfig,
)
from repro_torch.core.types import ClusterSpec, JobSpec, JobState, Phase

#: The discipline rank this scheduler assembles (registry entry "fifo"):
#: the queue below is a sorted index over exactly this key.
job_sort_key_fifo = ArrivalRank.key_of


class FIFOScheduler(Scheduler):
    name = "fifo"
    rank_policy = ArrivalRank

    def __init__(self, cluster: ClusterSpec, config: SchedulerConfig | None = None):
        cfg = config or SchedulerConfig()
        # Stock FIFO greedily picks local tasks but never delays a slot.
        cfg.locality_max_skips = 0
        super().__init__(cluster, cfg)
        # Per-phase FIFO queue: (sort_key, job_id) tuples kept sorted by
        # bisect on insert.  Entries whose job has left the pending set
        # are skipped during iteration and compacted once they outnumber
        # the live pending entries.  FIFO itself never emits Kill, but
        # the public on_task_killed hook re-adds pending demand — the
        # override below re-enqueues if compaction already dropped the
        # entry (`_queued` tracks which jobs still have one; an entry
        # still in the list simply revives when the job re-enters the
        # pending set).
        self._queue: dict[str, list[tuple[tuple, int]]] = {
            Phase.MAP.value: [], Phase.REDUCE.value: [],
        }
        self._queued: dict[str, set[int]] = {
            Phase.MAP.value: set(), Phase.REDUCE.value: set(),
        }

    def _enqueue(self, js: JobState, phase: Phase) -> None:
        bisect.insort(
            self._queue[phase.value], (job_sort_key_fifo(js), js.spec.job_id)
        )
        self._queued[phase.value].add(js.spec.job_id)

    def on_task_killed(self, att) -> None:
        super().on_task_killed(att)  # re-adds the job's pending demand
        self._requeue(att)

    def on_task_readmitted(self, att) -> None:
        # Fault layer: a FAILED task re-entered PENDING after its
        # re-admission backoff — same re-enqueue contract as KILL.
        super().on_task_readmitted(att)
        self._requeue(att)

    def _requeue(self, att) -> None:
        pv = att.spec.phase.value
        jid = att.spec.job_id
        if jid not in self._queued[pv]:
            js = self.jobs.get(jid)
            if js is not None:
                self._enqueue(js, att.spec.phase)

    def on_job_arrival(self, spec: JobSpec, now: float) -> JobState:
        js = super().on_job_arrival(spec, now)
        if js.n_pending(Phase.MAP):
            self._enqueue(js, Phase.MAP)
        return js

    def _on_reduce_unlocked(self, js: JobState) -> None:
        if js.n_pending(Phase.REDUCE):
            self._enqueue(js, Phase.REDUCE)

    def schedule(self, view: ClusterView, now: float) -> list[Action]:
        self._begin_pass()
        actions: list[Action] = []
        for phase in (Phase.MAP, Phase.REDUCE):
            if self.config.paranoid_indexes:
                self._paranoid_check(view, phase)
                self._check_queue(phase)
            free = view.free_slots(phase)
            if not free:
                continue
            if not self.config.demand_indexed:
                # Legacy walk: re-sort every phase-live job each pass,
                # from a fresh live-table scan (index-free reference).
                for js in sorted(
                    self.live_jobs_scan(phase).values(), key=job_sort_key_fifo
                ):
                    if not free:
                        break
                    acts, free = self._assign_pending(
                        js, phase, free, len(free), now
                    )
                    actions.extend(acts)
                continue
            pv = phase.value
            q = self._queue[pv]
            pend = self._jobs_pending[pv]
            dead = 0
            for entry in q:
                jid = entry[1]
                if jid not in pend:
                    dead += 1  # left the pending set; permanently dead
                    continue
                if not free:
                    break
                acts, free = self._assign_pending(
                    self.jobs[jid], phase, free, len(free), now
                )
                actions.extend(acts)
            # Compact once the *scanned* dead prefix is worth it — dead
            # entries cluster at the head (FIFO order ~ completion
            # order), and the loop above may break long before the tail,
            # so the trigger must not require a full scan.  The constant
            # threshold amortizes: ~64 extra skips per pass at most
            # between compactions.
            if dead > 64 or (dead and dead * 2 > len(q)):
                self._queue[pv] = [e for e in q if e[1] in pend]
                self._queued[pv] = {e[1] for e in self._queue[pv]}
        return actions

    def _check_queue(self, phase: Phase) -> None:
        """Paranoid cross-check: the queue's live entries must cover the
        pending set, in exactly the order a full re-sort would produce."""
        pend = self._jobs_pending[phase.value]
        live = [e[1] for e in self._queue[phase.value] if e[1] in pend]
        ref = [
            js.spec.job_id
            for js in sorted(
                (self.jobs[j] for j in pend), key=job_sort_key_fifo
            )
        ]
        assert live == ref, f"fifo queue mismatch ({phase}): {live} != {ref}"
