"""Scheduler framework.

A scheduler is *pure decision logic*: it is driven by events
(`on_job_arrival`, `on_task_complete`, ...) and, when asked, emits a list of
:class:`Action` that an executor applies to the physical cluster.  The same
scheduler object runs unmodified under

* :mod:`repro_torch.core.simulator` — the discrete-event simulator (the paper's
  Mumak analogue), and
* the gang-scheduling runtime (the paper's Amazon-cluster analogue,
  :mod:`repro_torch.runtime.gang`), which runs real training jobs.

The executor exposes the physical state through the read-only
:class:`ClusterView` protocol; schedulers keep their own per-job bookkeeping
in :class:`~repro_torch.core.types.JobState`.

Every helper here is written to be cheap per scheduling pass: O(free slots
+ live jobs + emitted actions), never O(total tasks) — schedulers run on
every simulator event.

Incremental run-state engine
----------------------------
The base scheduler maintains live indexes of the cluster's RUNNING tasks —
``_slot_of`` (task key -> slot), ``_run_by_job`` ((job, phase) -> attempts)
and ``_run_by_machine`` ((machine, phase) -> attempts) — updated in O(1)
per event instead of being rebuilt from ``view.occupied_slots`` on every
scheduling pass.  Executors MUST report every applied action through the
``on_task_started`` / ``on_task_resumed`` / ``on_task_suspended`` /
``on_task_killed`` hooks (completions already flow through
``on_task_complete``).  Both bundled executors do.  The hooks are a hard
requirement for correctness: the cheap per-pass fallback
(`_maybe_resync_indexes`) only catches drift that changes the running-task
COUNT, so an executor that skips the hooks but happens to keep counts
balanced (e.g. applying a Suspend + Resume pair) runs on stale indexes
undetected.  Validate new executors with
``SchedulerConfig.paranoid_indexes``, which cross-checks content and order
every pass.

Index invariants (checked every pass under
``SchedulerConfig.paranoid_indexes``):

* the indexes contain exactly the RUNNING tasks, keyed consistently with
  the executor's occupied-slot map;
* within one (machine, phase) or (job, phase) bucket, insertion order
  equals the executor's slot-occupancy insertion order — preemption
  victim selection is order-sensitive, so this keeps incremental and
  rebuild-from-scratch schedules bit-identical;
* indexes never change during a pass (the executor applies actions only
  after ``schedule()`` returns), so a pass sees a consistent snapshot.

Demand-indexed scheduling core
------------------------------
On top of the run-state indexes, the base scheduler maintains per-phase
*demand* indexes keyed by what a scheduling pass can actually act on:

* ``_jobs_pending``   — jobs with at least one PENDING task (can take a
  free slot, or preempt on unmet demand);
* ``_jobs_suspended`` — jobs with at least one SUSPENDED task (can
  resume in place);
* ``_jobs_running``   — jobs with at least one RUNNING task (preemption
  victims; also part of the run-state engine above);
* ``_n_live_phase``   — O(1) count of phase-live jobs (the denominator
  of fair-share quotas).

All four are updated in O(1) through the same executor hooks plus the
arrival/completion events, so a pass iterates only jobs with actionable
demand instead of every live job (see ``docs/scheduler_internals.md`` for
the invariants and the update protocol).  REDUCE membership is gated on
the slow-start unlock: a job's REDUCE demand is registered exactly once,
by ``_register_reduce`` (at arrival when already unlocked, else at the
MAP completion that crosses ``reduce_slowstart``).

The demand indexes obey the same contract as the run-state indexes: the
executor MUST call the hooks, membership never changes during a pass,
and ``SchedulerConfig.paranoid_indexes`` rebuilds reference sets from
the live-job table every pass and asserts equality.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Iterable, Protocol

from repro_torch.core.types import (
    ClusterSpec,
    JobSpec,
    JobState,
    Phase,
    SchedulerStats,
    SlotKey,
    TaskAttempt,
    TaskState,
)


# ---------------------------------------------------------------------------
# Executor-side view & actions
# ---------------------------------------------------------------------------
class ClusterView(Protocol):
    """Read-only physical cluster state, implemented by each executor."""

    spec: ClusterSpec

    def free_slots(self, phase: Phase) -> list[SlotKey]: ...
    def slot_occupant(self, slot: SlotKey) -> TaskAttempt | None: ...
    def occupied_slots(self, phase: Phase) -> dict[SlotKey, TaskAttempt]: ...
    def machine_suspended_count(self, machine: int) -> int: ...
    def machine_suspended_bytes(self, machine: int) -> int: ...
    def total_suspended_bytes(self) -> int: ...


@dataclass
class Action:
    pass


@dataclass
class Start(Action):
    attempt: TaskAttempt
    slot: SlotKey
    local: bool = True


@dataclass
class Resume(Action):
    attempt: TaskAttempt
    slot: SlotKey


@dataclass
class Suspend(Action):
    attempt: TaskAttempt


@dataclass
class Kill(Action):
    attempt: TaskAttempt


# ---------------------------------------------------------------------------
# Base scheduler
# ---------------------------------------------------------------------------
@dataclass
class SchedulerConfig:
    # Delay scheduling (Sect. 3.1 "Data locality"): how many scheduling
    # opportunities a job may skip waiting for a data-local MAP slot.
    locality_max_skips: int = 3
    locality_enabled: bool = True
    # Debug mode: rebuild the run-state indexes from the view on every pass
    # and assert they match the incrementally-maintained ones.  Slow; used
    # by the equivalence tests.
    paranoid_indexes: bool = False
    # Perf/debug switch: when False, scheduling passes fall back to the
    # legacy full walk over every phase-live job (no actionable-demand
    # pre-filter, no position cutoff).  Schedules are bit-identical either
    # way — the demand-index equivalence tests and the sched-overhead
    # benchmark's sparse-demand cell compare the two paths.
    demand_indexed: bool = True


class Scheduler(abc.ABC):
    """Common machinery: job registry, locality-aware slot matching."""

    name = "base"

    def __init__(self, cluster: ClusterSpec, config: SchedulerConfig | None = None):
        self.cluster = cluster
        self.config = config or SchedulerConfig()
        self.jobs: dict[int, JobState] = {}
        self.stats = SchedulerStats()
        self._skip_counts: dict[int, int] = {}
        self._skip_marked: dict[int, int] = {}  # job -> pass seq of last skip
        self._pass_seq = 0
        # Live-job index (jobs with completion_time None), kept incrementally.
        self._live: dict[int, JobState] = {}
        # Tasks already given an action in the *current* pass (the executor
        # has not applied the actions yet, so JobState still shows them as
        # PENDING/SUSPENDED — helpers must not hand them out twice).
        self._claimed: set[tuple] = set()
        # Per-(job, phase) count of claims that targeted PENDING tasks,
        # kept alongside _claimed so _unclaimed_pending is O(1) instead of
        # O(#claimed) per queried job.
        self._claimed_pending: dict[tuple[int, str], int] = {}
        # Per-phase count of claims that targeted RUNNING tasks (preemption
        # victims) — lets the preemptable-pool check stay O(1) per call.
        self._claimed_running: dict[str, int] = {}
        # -- incremental run-state engine (see module docstring) ------------
        # Live views of RUNNING tasks, updated in O(1) by the executor
        # hooks below; read by preemption logic instead of rebuilding from
        # view.occupied_slots() every pass.
        self._slot_of: dict[tuple, SlotKey] = {}
        self._run_by_job: dict[tuple[int, str], dict[tuple, TaskAttempt]] = {}
        self._run_by_machine: dict[tuple[int, str], dict[tuple, TaskAttempt]] = {}
        self._n_running_idx: dict[str, int] = {
            Phase.MAP.value: 0, Phase.REDUCE.value: 0,
        }
        # Jobs with at least one RUNNING task, per phase — lets preemption
        # victim collection iterate O(running jobs) instead of O(live jobs).
        self._jobs_running: dict[str, set[int]] = {
            Phase.MAP.value: set(), Phase.REDUCE.value: set(),
        }
        # -- demand indexes (see module docstring) --------------------------
        # Jobs with >=1 PENDING / >=1 SUSPENDED task per phase, as
        # insertion-ordered dict-sets (deterministic iteration).  REDUCE
        # membership is gated on the slow-start unlock (_register_reduce).
        self._jobs_pending: dict[str, dict[int, None]] = {
            Phase.MAP.value: {}, Phase.REDUCE.value: {},
        }
        self._jobs_suspended: dict[str, dict[int, None]] = {
            Phase.MAP.value: {}, Phase.REDUCE.value: {},
        }
        # O(1) per-phase live-job count (== len(live_jobs(phase))).
        self._n_live_phase: dict[str, int] = {
            Phase.MAP.value: 0, Phase.REDUCE.value: 0,
        }
        # Jobs whose REDUCE phase has been registered with the demand
        # indexes (slow-start crossed) — registration happens exactly once.
        self._reduce_open: set[int] = set()
        # -- attained-service counters (Discipline API) ---------------------
        # Per-(job, phase) *useful* attained service: progress that still
        # counts toward completion, materialized at executor events
        # (complete / suspend / resume / kill).  Running tasks' progress
        # accrues continuously in simulation time but is only folded in
        # when an event materializes it, so the counters are
        # event-constant — the contract that lets rank policies (SRPT
        # remaining, LAS attained; repro_torch.core.disciplines) cache their
        # job order between events.  KILL discards the task's counted
        # progress (the work must be redone).
        self._attained: dict[tuple[int, str], float] = {}
        # Per-task absolute progress already folded into _attained.
        self._svc_counted: dict[tuple, float] = {}
        # Monotone version of the run/demand state: bumped on every
        # index mutation (task started / resumed / suspended / killed /
        # completed, arrivals, REDUCE unlocks, job completion).  Between
        # two passes with equal epochs, the indexes — and therefore any
        # pure function of them — are provably unchanged; the engine's
        # cross-pass actor/feasibility caches key on it (together with
        # the rank epoch; see repro_torch.core.hfsp).
        self._run_epoch = 0

    def _begin_pass(self) -> None:
        self._claimed.clear()
        self._claimed_pending.clear()
        self._claimed_running.clear()
        self._pass_seq += 1

    def _claim(self, att: TaskAttempt) -> None:
        """Mark a task as acted on this pass.  All claims must go through
        here so the per-(job, phase) pending-claim and per-phase
        running-claim counters stay exact."""
        key = att.spec.key
        self._claimed.add(key)
        if att.state is TaskState.PENDING:
            jk = (key[0], key[1])
            self._claimed_pending[jk] = self._claimed_pending.get(jk, 0) + 1
        elif att.state is TaskState.RUNNING:
            self._claimed_running[key[1]] = (
                self._claimed_running.get(key[1], 0) + 1
            )

    # -- events (executor -> scheduler) -------------------------------------
    def on_job_arrival(self, spec: JobSpec, now: float) -> JobState:
        self._run_epoch += 1
        js = JobState(spec=spec)
        self.jobs[spec.job_id] = js
        self._live[spec.job_id] = js
        mv = Phase.MAP.value
        if js.n_unfinished(Phase.MAP):
            self._n_live_phase[mv] += 1
            if js.n_pending(Phase.MAP):
                self._jobs_pending[mv][spec.job_id] = None
        if js.reduce_unlocked():
            self._register_reduce(js)
        return js

    def _register_reduce(self, js: JobState) -> None:
        """Open the job's REDUCE phase for the demand indexes (called once,
        when the slow-start fraction is crossed)."""
        jid = js.spec.job_id
        if jid in self._reduce_open:
            return
        self._run_epoch += 1
        self._reduce_open.add(jid)
        rv = Phase.REDUCE.value
        if js.n_unfinished(Phase.REDUCE):
            self._n_live_phase[rv] += 1
            if js.n_pending(Phase.REDUCE):
                self._jobs_pending[rv][jid] = None
        self._on_reduce_unlocked(js)

    def _on_reduce_unlocked(self, js: JobState) -> None:
        """Subclass hook: the job's REDUCE phase just became schedulable
        (FIFO inserts into its arrival-ordered queue here)."""

    def on_task_complete(self, job_id: int, key: tuple, now: float) -> None:
        self._index_remove(key)
        js = self.jobs.get(job_id)
        if js is None:
            return
        pv = key[1]
        phase = Phase(pv)
        # Attained service: fold in the task's final segment (its full
        # duration minus whatever earlier suspends already counted).
        delta = js.tasks[key].spec.duration - self._svc_counted.pop(key, 0.0)
        jk = (job_id, pv)
        self._attained[jk] = self._attained.get(jk, 0.0) + delta
        if js.n_unfinished(phase) == 0:
            # Phase drained: drop the job from this phase's demand indexes.
            self._n_live_phase[pv] -= 1
            self._jobs_pending[pv].pop(job_id, None)
            self._jobs_suspended[pv].pop(job_id, None)
        if phase is Phase.MAP and js.reduce_unlocked():
            self._register_reduce(js)

    def on_task_progress(
        self, job_id: int, key: tuple, fraction: float, elapsed: float, now: float
    ) -> None:
        pass

    def on_job_complete(self, job_id: int, now: float) -> None:
        self._run_epoch += 1
        self._live.pop(job_id, None)
        # Prune the (empty-by-now) per-job run buckets and demand entries.
        for pv in (Phase.MAP.value, Phase.REDUCE.value):
            self._run_by_job.pop((job_id, pv), None)
            self._jobs_pending[pv].pop(job_id, None)
            self._jobs_suspended[pv].pop(job_id, None)
            self._attained.pop((job_id, pv), None)
        self._reduce_open.discard(job_id)

    def on_tick(self, now: float) -> None:
        """Periodic heartbeat (executors call this every few sim-seconds)."""

    def on_wall_tick(self, wall_now: float, now: float) -> None:
        """Wall-clock tick seam for the live service (repro_torch.service).

        The live master's pacer calls this once per real-time heartbeat
        with both clocks: ``wall_now`` is wall seconds, ``now`` is the
        mapped simulation time the engine has been advanced to.  Offline
        executors never call it.  Default: no-op — disciplines that want
        wall-time-based behaviour (telemetry snapshots, watchdog
        self-checks) override it; everything that affects *scheduling*
        must key off simulation time so the replay twin stays
        deterministic."""

    # -- run-state engine hooks (executor -> scheduler) ----------------------
    # Executors call these right after physically applying each action so
    # the indexes mirror the cluster without per-pass rebuilds.  Each hook
    # also folds the O(1) demand-index update for the state transition it
    # reports (PENDING->RUNNING, SUSPENDED->RUNNING, RUNNING->SUSPENDED,
    # RUNNING->PENDING).
    def on_task_started(self, att: TaskAttempt, slot: SlotKey) -> None:
        self._index_add(att, slot)
        js = self.jobs.get(att.spec.job_id)
        if js is not None and not js.n_pending(att.spec.phase):
            self._jobs_pending[att.spec.phase.value].pop(att.spec.job_id, None)

    def on_task_resumed(self, att: TaskAttempt, slot: SlotKey) -> None:
        self._index_add(att, slot)
        # RESUME may have rolled progress back (DMA swap-in cost): re-sync
        # the counted progress so attained service reflects the rollback.
        self._svc_mark(att)
        js = self.jobs.get(att.spec.job_id)
        if js is not None and not js.n_suspended(att.spec.phase):
            self._jobs_suspended[att.spec.phase.value].pop(
                att.spec.job_id, None
            )

    def on_task_suspended(self, att: TaskAttempt) -> None:
        self._index_remove(att.spec.key)
        self._svc_mark(att)  # progress was just materialized by the executor
        self._jobs_suspended[att.spec.phase.value][att.spec.job_id] = None

    def on_task_killed(self, att: TaskAttempt) -> None:
        self._index_remove(att.spec.key)
        self._svc_mark(att)  # progress reset to 0: discards counted service
        # KILL re-queues the task: the job has pending demand again.
        self._jobs_pending[att.spec.phase.value][att.spec.job_id] = None

    # -- fault hooks (executor -> scheduler; see repro_torch.core.faults) ----------
    def on_task_failed(self, att: TaskAttempt) -> None:
        """The task just transitioned to FAILED (injected failure or
        machine crash).  Its progress has been reset to 0 by the executor;
        it re-enters PENDING later via ``on_task_readmitted``.  A FAILED
        task is *not* actionable demand, so the job may drop out of every
        demand index for the phase while staying phase-live."""
        self._index_remove(att.spec.key)
        self._svc_mark(att)  # progress reset to 0: discards counted service
        js = self.jobs.get(att.spec.job_id)
        if js is not None and not js.n_suspended(att.spec.phase):
            # Covers FAILED-from-SUSPENDED (machine crash while swapped out).
            self._jobs_suspended[att.spec.phase.value].pop(
                att.spec.job_id, None
            )

    def on_task_readmitted(self, att: TaskAttempt) -> None:
        """The task's re-admission backoff expired (FAILED -> PENDING)."""
        self._run_epoch += 1
        self._jobs_pending[att.spec.phase.value][att.spec.job_id] = None

    def on_machine_crashed(self, machine: int) -> None:
        """A machine went down; its tasks fail separately through
        ``on_task_failed``.  Free-slot availability changed."""
        self._run_epoch += 1

    def on_machine_recovered(self, machine: int) -> None:
        self._run_epoch += 1

    def on_sample_lost(self, att: TaskAttempt) -> None:
        """Fault layer: a completed task's size-sample observation was
        dropped before reaching the estimator.  Fired immediately before
        ``on_task_complete`` for the same task; only estimate-driven
        schedulers react (see HFSPScheduler)."""

    def _svc_mark(self, att: TaskAttempt) -> None:
        """Fold the task's materialized ``progress`` into the attained-
        service counter (O(1); exact because executors materialize
        progress before calling the hooks)."""
        key = att.spec.key
        prev = self._svc_counted.get(key, 0.0)
        if att.progress != prev:
            jk = (att.spec.job_id, att.spec.phase.value)
            self._attained[jk] = (
                self._attained.get(jk, 0.0) + att.progress - prev
            )
            self._svc_counted[key] = att.progress

    def attained_service(self, job_id: int, phase: Phase) -> float:
        """Useful attained service of a job's phase (seconds of task
        progress that still count toward completion), as of the last
        executor event.  O(1); the rank-key input for the SRPT and LAS
        disciplines (:mod:`repro_torch.core.disciplines`)."""
        return self._attained.get((job_id, phase.value), 0.0)

    def _index_add(self, att: TaskAttempt, slot: SlotKey) -> None:
        self._run_epoch += 1
        key = att.spec.key
        pv = slot.phase.value
        self._slot_of[key] = slot
        jk = (att.spec.job_id, pv)
        bucket = self._run_by_job.get(jk)
        if bucket is None:
            bucket = self._run_by_job[jk] = {}
        if not bucket:
            self._jobs_running[pv].add(att.spec.job_id)
        bucket[key] = att
        mk = (slot.machine, pv)
        bucket = self._run_by_machine.get(mk)
        if bucket is None:
            bucket = self._run_by_machine[mk] = {}
        bucket[key] = att
        self._n_running_idx[pv] += 1

    def _index_remove(self, key: tuple) -> None:
        self._run_epoch += 1
        slot = self._slot_of.pop(key, None)
        if slot is None:
            return
        pv = slot.phase.value
        bucket = self._run_by_job[(key[0], pv)]
        bucket.pop(key, None)
        if not bucket:
            self._jobs_running[pv].discard(key[0])
        self._run_by_machine[(slot.machine, pv)].pop(key, None)
        self._n_running_idx[pv] -= 1

    def _maybe_resync_indexes(self, view: ClusterView, phase: Phase) -> None:
        """Fallback for executors that do not call the run-state hooks:
        when the indexed running count disagrees with the view, rebuild
        this phase's indexes from scratch (the legacy per-pass path)."""
        occ = view.occupied_slots(phase)
        if self._n_running_idx[phase.value] == len(occ):
            return
        pv = phase.value
        for key in [k for k, s in self._slot_of.items() if s.phase is phase]:
            del self._slot_of[key]
        for mk in [k for k in self._run_by_machine if k[1] == pv]:
            del self._run_by_machine[mk]
        for jk in [k for k in self._run_by_job if k[1] == pv]:
            del self._run_by_job[jk]
        self._n_running_idx[pv] = 0
        self._jobs_running[pv].clear()
        for slot, att in occ.items():
            self._index_add(att, slot)
        self._rebuild_demand_indexes(phase)

    def _demand_reference(
        self, phase: Phase
    ) -> tuple[dict[int, None], dict[int, None], int]:
        """(pending, suspended, phase-live count) recomputed from the
        live-job table — the single definition of phase-liveness, shared
        by the resync fallback and the paranoid cross-check."""
        pend: dict[int, None] = {}
        susp: dict[int, None] = {}
        n_live = 0
        for jid, js in self._live.items():
            if phase is Phase.REDUCE and not js.reduce_unlocked():
                continue
            if not js.n_unfinished(phase):
                continue
            n_live += 1
            if js.n_pending(phase):
                pend[jid] = None
            if js.n_suspended(phase):
                susp[jid] = None
        return pend, susp, n_live

    def _rebuild_demand_indexes(self, phase: Phase) -> None:
        """Recompute this phase's demand indexes from the live-job table
        (the resync fallback for hook-less executors)."""
        pv = phase.value
        pend, susp, n_live = self._demand_reference(phase)
        self._jobs_pending[pv] = pend
        self._jobs_suspended[pv] = susp
        self._n_live_phase[pv] = n_live

    def _paranoid_check(self, view: ClusterView, phase: Phase) -> None:
        """Rebuild reference indexes from the view and assert the
        incremental ones match — content AND per-bucket order (preemption
        victim selection is order-sensitive)."""
        pv = phase.value
        ref_slot_of: dict[tuple, SlotKey] = {}
        ref_by_machine: dict[int, list[tuple]] = {}
        ref_by_job: dict[int, list[tuple]] = {}
        for slot, att in view.occupied_slots(phase).items():
            ref_slot_of[att.spec.key] = slot
            ref_by_machine.setdefault(slot.machine, []).append(att.spec.key)
            ref_by_job.setdefault(att.spec.job_id, []).append(att.spec.key)
        got_slot_of = {k: s for k, s in self._slot_of.items() if s.phase is phase}
        assert got_slot_of == ref_slot_of, (
            f"slot_of mismatch ({phase}): {got_slot_of} != {ref_slot_of}"
        )
        got_by_machine = {
            mk[0]: list(bucket)
            for mk, bucket in self._run_by_machine.items()
            if mk[1] == pv and bucket
        }
        assert got_by_machine == ref_by_machine, (
            f"run_by_machine mismatch ({phase})"
        )
        got_by_job = {
            jk[0]: list(bucket)
            for jk, bucket in self._run_by_job.items()
            if jk[1] == pv and bucket
        }
        assert got_by_job == ref_by_job, f"run_by_job mismatch ({phase})"
        assert self._n_running_idx[pv] == len(ref_slot_of)
        assert self._jobs_running[pv] == set(ref_by_job), (
            f"jobs_running mismatch ({phase})"
        )
        # Demand indexes: membership must equal a rebuild from the live
        # table (order inside the dict-sets is not semantically relevant —
        # every consumer re-sorts — so membership equality is the contract).
        pend_d, susp_d, ref_live = self._demand_reference(phase)
        ref_pend, ref_susp = set(pend_d), set(susp_d)
        assert set(self._jobs_pending[pv]) == ref_pend, (
            f"jobs_pending mismatch ({phase}): "
            f"{set(self._jobs_pending[pv])} != {ref_pend}"
        )
        assert set(self._jobs_suspended[pv]) == ref_susp, (
            f"jobs_suspended mismatch ({phase}): "
            f"{set(self._jobs_suspended[pv])} != {ref_susp}"
        )
        assert self._n_live_phase[pv] == ref_live, (
            f"n_live_phase mismatch ({phase}): "
            f"{self._n_live_phase[pv]} != {ref_live}"
        )

    # -- decisions -----------------------------------------------------------
    @abc.abstractmethod
    def schedule(self, view: ClusterView, now: float) -> list[Action]:
        """Return the actions to apply given current physical state."""

    # -- shared helpers --------------------------------------------------------
    def live_jobs(self, phase: Phase) -> list[JobState]:
        """Phase-live jobs (>=1 unfinished task, REDUCE gated on unlock).

        Served from the demand indexes: the membership union
        pending | suspended | running *is* the phase-live set (every
        unfinished task is in exactly one of those three states), so this
        is O(phase-live) instead of O(all live jobs)."""
        return list(self.demand_union(phase).values())

    def demand_union(self, phase: Phase) -> dict[int, JobState]:
        """{job_id: JobState} of jobs with any demand in ``phase`` —
        pending, suspended, or running tasks.  Deterministic (index
        insertion order; callers needing a specific order re-sort with a
        total key).  This is the one iteration path all three policies
        share; its size is ``n_live_phase(phase)``."""
        jobs = self.jobs
        out: dict[int, JobState] = {}
        for jid in self._jobs_pending[phase.value]:
            out[jid] = jobs[jid]
        for jid in self._jobs_suspended[phase.value]:
            if jid not in out:
                out[jid] = jobs[jid]
        for jid in self._jobs_running[phase.value]:
            if jid not in out:
                out[jid] = jobs[jid]
        return out

    def n_live_phase(self, phase: Phase) -> int:
        """O(1) count of phase-live jobs (== len(live_jobs(phase)))."""
        return self._n_live_phase[phase.value]

    def live_jobs_scan(self, phase: Phase) -> dict[int, JobState]:
        """Phase-live jobs recomputed straight from the live-job table —
        O(all live jobs), no demand indexes involved.  The
        ``demand_indexed=False`` legacy passes derive phase-liveness,
        fair-share denominators, and the training-module probes from this
        scan, keeping them a reference that is free of the demand
        and training indexes: a membership bug there diverges the two
        modes and is caught by the equivalence suite (an index-backed
        legacy walk would reproduce the corruption bit for bit).  The
        run-state indexes (slot_of / run_by_job / jobs_running and
        the training _active registry) remain shared by both modes —
        those are cross-checked by ``paranoid_indexes`` instead."""
        out: dict[int, JobState] = {}
        for jid, js in self._live.items():
            if phase is Phase.REDUCE and not js.reduce_unlocked():
                continue
            if js.n_unfinished(phase):
                out[jid] = js
        return out

    def _demand(self, js: JobState, phase: Phase) -> int:
        """Slots the job could use *right now* in this phase."""
        return js.n_pending(phase) + js.n_suspended(phase) + js.n_running(phase)

    def _unclaimed_pending(self, js: JobState, phase: Phase) -> int:
        """Pending tasks not yet claimed this pass.  O(1): `_claim` counts
        claims of PENDING tasks per (job, phase) as they happen (task
        states cannot change mid-pass, so the counter is exact)."""
        if not self._claimed_pending:
            return js.n_pending(phase)
        return js.n_pending(phase) - self._claimed_pending.get(
            (js.spec.job_id, phase.value), 0
        )

    # .. locality-aware assignment of pending tasks to free slots ...........
    def _assign_pending(
        self,
        js: JobState,
        phase: Phase,
        free: list[SlotKey],
        budget: int,
        now: float,
        only_keys: Iterable[tuple] | None = None,
    ) -> tuple[list[Action], list[SlotKey]]:
        """Assign up to ``budget`` pending tasks of ``js`` to ``free`` slots.

        MAP tasks use delay scheduling: prefer slots on machines that hold
        the task's input; a job may skip ``locality_max_skips`` scheduling
        opportunities before accepting a non-local slot.  Returns the
        actions plus the still-free slots.  ``only_keys`` restricts the
        candidate tasks (used by the HFSP Training module to dispatch just
        the sample set).
        """
        actions: list[Action] = []
        if budget <= 0 or not free:
            return actions, free
        jid = js.spec.job_id
        restrict: set[tuple] | None = set(only_keys) if only_keys is not None else None

        def eligible(att: TaskAttempt) -> bool:
            k = att.spec.key
            if att.state is not TaskState.PENDING or k in self._claimed:
                return False
            return restrict is None or k in restrict

        if phase is Phase.MAP and self.config.locality_enabled:
            rest_slots: list[SlotKey] = []
            for slot in free:
                if budget <= 0:
                    rest_slots.append(slot)
                    continue
                att = next(
                    (a for a in js.local_pending(slot.machine) if eligible(a)),
                    None,
                )
                if att is not None:
                    self._claim(att)
                    actions.append(Start(att, slot, local=True))
                    js.locality_hits += 1
                    budget -= 1
                    self._skip_counts[jid] = 0
                else:
                    rest_slots.append(slot)
            free = rest_slots
            if budget > 0 and free:
                # Bounded scan: at most ``budget`` tasks can be assigned
                # from either group, so stop once both are full — O(budget)
                # per pass instead of O(pending) for wide jobs.
                no_host: list[TaskAttempt] = []
                remaining: list[TaskAttempt] = []
                for a in js.iter_pending(phase):
                    if not eligible(a):
                        continue
                    if a.spec.input_hosts:
                        if len(remaining) < budget:
                            remaining.append(a)
                    elif len(no_host) < budget:
                        no_host.append(a)
                    if len(remaining) >= budget and len(no_host) >= budget:
                        break
                # Tasks with no locality information cannot benefit from
                # waiting — assign them immediately (ML step quanta, or
                # jobs whose replicas are all dead).
                free = list(free)
                for att in no_host:
                    if budget <= 0 or not free:
                        break
                    slot = free.pop(0)
                    self._claim(att)
                    actions.append(Start(att, slot, local=True))
                    budget -= 1
                if remaining and budget > 0 and free:
                    skips = self._skip_counts.get(jid, 0)
                    if skips < self.config.locality_max_skips:
                        # Delay: skip this opportunity hoping for a local
                        # slot.  Counted at most once per scheduling pass
                        # (the Training module and the job scheduler may
                        # both consider the same job in one pass).
                        if self._skip_marked.get(jid) != self._pass_seq:
                            self._skip_counts[jid] = skips + 1
                            self._skip_marked[jid] = self._pass_seq
                            self.stats.delay_sched_waits += 1
                    else:
                        while remaining and budget > 0 and free:
                            att = remaining.pop(0)
                            slot = free.pop(0)
                            self._claim(att)
                            actions.append(Start(att, slot, local=False))
                            js.locality_misses += 1
                            budget -= 1
                        self._skip_counts[jid] = 0
        else:
            # REDUCE tasks (or locality disabled): any slot will do.
            free = list(free)
            for att in js.iter_pending(phase):
                if budget <= 0 or not free:
                    break
                if not eligible(att):
                    continue
                slot = free.pop(0)
                self._claim(att)
                actions.append(Start(att, slot, local=True))
                budget -= 1
        return actions, free

    def _resume_suspended(
        self,
        js: JobState,
        phase: Phase,
        free: list[SlotKey],
        budget: int,
    ) -> tuple[list[Action], list[SlotKey]]:
        """Resume suspended tasks on their *own* machines (Sect. 3.3 —
        suspended state is materialized locally and must resume in place)."""
        actions: list[Action] = []
        if budget <= 0:
            return actions, free
        free_by_machine: dict[int, list[SlotKey]] = {}
        for s in free:
            free_by_machine.setdefault(s.machine, []).append(s)
        for att in js.suspended(phase):
            if budget <= 0:
                break
            if att.spec.key in self._claimed:
                continue
            slots = free_by_machine.get(att.machine if att.machine is not None else -1)
            if slots:
                slot = slots.pop(0)
                self._claim(att)
                actions.append(Resume(att, slot))
                budget -= 1
        used = {a.slot for a in actions if isinstance(a, Resume)}
        return actions, [s for s in free if s not in used]


def job_sort_key_fifo(js: JobState) -> tuple:
    return (-js.spec.weight, js.spec.arrival_time, js.spec.job_id)


class LazySet:
    """Set-like view materialized on first membership test.

    Used for pass-scoped sets that are expensive to build but rarely
    consulted (e.g. the preemption-protected sample keys: only preemption
    walks read them, and most passes never preempt).  The factory runs at
    most once; until then the set costs nothing."""

    __slots__ = ("_factory", "_set")

    def __init__(self, factory):
        self._factory = factory
        self._set: set | None = None

    def materialize(self) -> set:
        if self._set is None:
            self._set = self._factory()
        return self._set

    def __contains__(self, key) -> bool:
        return key in self.materialize()

    def __len__(self) -> int:
        return len(self.materialize())
