"""Discrete-event cluster simulator — the paper's Mumak analogue (Sect. 4.1).

Executes any :class:`~repro_torch.core.scheduler.Scheduler` against a simulated
cluster with per-machine MAP/REDUCE slots, data locality, preemption
primitives (SUSPEND / RESUME / KILL) and an optional DMA cost model for the
TPU adaptation (suspend state must cross HBM<->host DRAM; in the paper the
analogous cost is OS swap I/O, which Sect. 5 argues is bounded).

Semantics:

* a RUNNING task progresses at unit rate; progress is frozen on SUSPEND;
* RESUME charges ``ClusterSpec.suspend_cost(state_bytes)`` by *rolling back*
  progress (the swapped-in context must be re-materialized before useful
  work continues — the paper's "Resume operation may introduce further
  delays");
* KILL discards all progress and re-queues the task (Sect. 3.3);
* REDUCE sample tasks report progress to the scheduler after ``delta``
  seconds of execution (supports the sigma = Delta/p estimator, Sect. 3.2.1);
* the scheduler is consulted on every event and on a periodic heartbeat.

The simulator is deterministic given the job list.

Epsilon-window event coalescing
-------------------------------
By default (``event_epsilon=0``) a scheduling pass runs after every event,
with only exact-timestamp ARRIVAL/COMPLETE batches sharing one pass.  With
``event_epsilon=eps > 0`` the loop instead pops *every* heap event within
``eps`` of the window head (the first event after the previous pass),
applies each event's state mutation at its own timestamp, and runs ONE
scheduling pass at the window-end timestamp — the event-batching design of
"A Simulator for Data-Intensive Job Scheduling" (arXiv 1306.6023), which
cuts pass counts by an order of magnitude on bursty traces.

Determinism contract (see docs/scheduler_internals.md):

* events inside a window apply in stable ``(time, kind, seq)`` heap order
  — the same total order the eps=0 loop uses, so a window is just the
  eps=0 mutation sequence with intermediate passes elided;
* each mutation sees ``now`` = its own event time (completion times,
  progress fractions, and virtual-cluster aging are unchanged); only the
  *pass* moves, to the window's last event time;
* eps=0 is bit-identical to the legacy loop (enforced by the conformance
  suite), and any eps is reproducible across runs and processes — the
  window boundaries are a pure function of the event stream and the
  ``run(until=...)`` barriers;
* ``until`` is a simulation-time barrier: a window never spans it — the
  pending pass is flushed before ``run`` returns, so callers always
  observe fully-scheduled state at ``until`` (decisions due by the
  barrier are not deferred past it).  ``run(until=T)`` + ``run()`` may
  therefore place passes differently than one unsliced ``run()`` — by
  design, like any other choice of barrier.  ``max_events`` slicing, by
  contrast, is placement-neutral: an open window persists across the
  budget exception and resumes identically.
"""

from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field

from repro_torch.core.faults import FaultInjector, FaultModel
from repro_torch.core.scheduler import Action, Kill, Resume, Scheduler, Start, Suspend
from repro_torch.core.types import (
    ClusterSpec,
    JobSpec,
    JobState,
    Phase,
    SlotKey,
    TaskAttempt,
    TaskState,
)

_ARRIVAL, _COMPLETE, _PROGRESS, _TICK, _FAULT = 0, 1, 2, 3, 4


def auto_event_epsilon(
    arrivals: list[float], heartbeat: float = 3.0
) -> float:
    """Pick a coalescing window width from observed arrival burstiness.

    Burstiness is measured as the coefficient of variation (CV) of the
    inter-arrival gaps.  CV <= 1 (Poisson or smoother): return 0 — the
    stream has no bursts, so a window would only delay decisions without
    cutting pass counts.  CV > 1: return the *median* gap — in a bursty
    stream the median sits inside the bursts (most gaps are tiny), so a
    median-wide window merges each burst into one scheduling pass while
    the inter-burst gaps, far above the median, still get their own.
    Capped at one ``heartbeat`` so no decision is ever deferred longer
    than the executor's own tick, and 0 for fewer than 3 arrivals (one
    gap is not a distribution).

    Pure and deterministic: scenario cells resolve
    ``event_epsilon="auto"`` through this at build time, and the live
    service's epsilon controller re-evaluates it over the observed
    arrival history (journaling each retune so the twin replay uses the
    recorded value, never a recomputation).
    """
    ts = sorted(arrivals)
    if len(ts) < 3:
        return 0.0
    gaps = [b - a for a, b in zip(ts, ts[1:])]
    mean = sum(gaps) / len(gaps)
    if mean <= 0.0:
        # Every arrival simultaneous: any window merges them; one
        # heartbeat is the largest we ever allow.
        return float(heartbeat)
    var = sum((g - mean) ** 2 for g in gaps) / len(gaps)
    cv = (var ** 0.5) / mean
    if cv <= 1.0:
        return 0.0
    med = sorted(gaps)[len(gaps) // 2]
    return float(min(med, heartbeat))


@dataclass
class SimConfig:
    """Executor knobs, bundled so scenario specs and benchmarks can pass
    one object (`Simulator(..., config=SimConfig(...))`)."""

    heartbeat: float = 3.0
    track_timeline: bool = False
    #: Delta after which a running REDUCE sample task reports progress;
    #: None defers to the scheduler's TrainingModule delta.
    progress_delta: float | None = None
    #: Epsilon-window event coalescing (seconds): 0 = a pass per event
    #: (legacy, bit-identical); eps > 0 = one pass per event window (see
    #: module docstring for the determinism contract); the string
    #: ``"auto"`` = derive the width from the workload's arrival
    #: burstiness at construction time (:func:`auto_event_epsilon`).
    event_epsilon: float | str = 0.0
    #: Deterministic fault injection (repro_torch.core.faults / docs/faults.md);
    #: None or an all-zero-rate model leaves the fault layer entirely off
    #: — zero-fault runs are bit-identical to pre-fault builds.
    faults: FaultModel | None = None


class EventLimitReached(RuntimeError):
    """run(max_events=N) processed N events without draining the heap.

    Subclasses RuntimeError for backward compatibility with callers that
    use max_events as a livelock guard; callers that use it as a
    deliberate slicing budget (the scheduler-overhead benchmarks) catch
    this type specifically so a genuine error can't masquerade as an
    exhausted budget."""


@dataclass
class SimResult:
    """Everything the benchmarks need."""

    arrival: dict[int, float] = field(default_factory=dict)
    completion: dict[int, float] = field(default_factory=dict)
    first_dispatch: dict[int, float] = field(default_factory=dict)
    locality_hits: int = 0
    locality_misses: int = 0
    stats: object | None = None
    # (time, job_id, phase, running-slot-count) samples for Fig. 7 graphs.
    timeline: list[tuple[float, int, str, int]] = field(default_factory=list)
    makespan: float = 0.0
    # Scheduler passes run / events processed — the epsilon-window
    # sojourn-vs-overhead tradeoff reads per pass counts per cell.
    passes: int = 0
    events: int = 0
    # Fault-layer counters + trace length (FaultInjector.stats_dict);
    # None when the fault layer is disabled.
    faults: dict | None = None

    @property
    def sojourn(self) -> dict[int, float]:
        return {
            j: self.completion[j] - self.arrival[j]
            for j in self.completion
            if j in self.arrival
        }

    def mean_sojourn(self) -> float:
        s = self.sojourn
        return sum(s.values()) / len(s) if s else 0.0

    @property
    def locality_fraction(self) -> float:
        tot = self.locality_hits + self.locality_misses
        return self.locality_hits / tot if tot else 1.0


class Simulator:
    """ClusterView implementation + event loop."""

    def __init__(
        self,
        cluster: ClusterSpec,
        scheduler: Scheduler,
        jobs: list[JobSpec],
        heartbeat: float | None = None,
        track_timeline: bool | None = None,
        progress_delta: float | None = None,
        event_epsilon: float | None = None,
        faults: FaultModel | None = None,
        config: SimConfig | None = None,
    ):
        # The knob kwargs default to None sentinels and resolve through
        # SimConfig, so the defaults live in exactly one place.  A config
        # bundle replaces the individual knobs — mixing both would
        # silently drop one side, so explicit kwargs alongside a config
        # are rejected.  (progress_delta=None is itself the "defer to the
        # scheduler's TrainingModule delta" value, so passing it
        # explicitly is indistinguishable from omitting it — harmless.)
        explicit = {
            name: val
            for name, val in (
                ("heartbeat", heartbeat),
                ("track_timeline", track_timeline),
                ("progress_delta", progress_delta),
                ("event_epsilon", event_epsilon),
                ("faults", faults),
            )
            if val is not None
        }
        if config is not None:
            if explicit:
                raise ValueError(
                    "pass executor knobs either via config=SimConfig(...) "
                    f"or as keyword arguments, not both: {sorted(explicit)}"
                )
        else:
            config = SimConfig(**explicit)
        self.spec = cluster
        self.scheduler = scheduler
        self.heartbeat = config.heartbeat
        self.track_timeline = config.track_timeline
        progress_delta = config.progress_delta
        event_epsilon = config.event_epsilon
        if isinstance(event_epsilon, str):
            if event_epsilon != "auto":
                raise ValueError(
                    f"event_epsilon must be a number or 'auto', got "
                    f"{event_epsilon!r}"
                )
            event_epsilon = auto_event_epsilon(
                [j.arrival_time for j in jobs], config.heartbeat
            )
        if event_epsilon < 0:
            raise ValueError(f"event_epsilon must be >= 0, got {event_epsilon}")
        self.event_epsilon = float(event_epsilon)
        # End timestamp of the open coalescing window (None = no window
        # open); persists across incremental run() calls so a window split
        # by an event-budget slice closes identically.
        self._window_end: float | None = None
        # Delta after which a running REDUCE sample task reports progress;
        # defaults to the scheduler's TrainingModule delta if present.
        if progress_delta is None:
            progress_delta = getattr(
                getattr(scheduler, "training", None), "delta", 60.0
            )
        self.progress_delta = progress_delta

        self._jobs = sorted(jobs, key=lambda j: (j.arrival_time, j.job_id))
        self._heap: list[tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self._now = 0.0
        # Physical slot state.  Free slots are insertion-ordered dicts:
        # same iteration/removal order as a list, but O(1) release/claim
        # (the scheduler pass consults free_slots on every event).
        self._free: dict[Phase, dict[SlotKey, None]] = {
            Phase.MAP: {}, Phase.REDUCE: {},
        }
        for m in range(cluster.num_machines):
            for i in range(cluster.map_slots_per_machine):
                self._free[Phase.MAP][SlotKey(m, Phase.MAP, i)] = None
            for i in range(cluster.reduce_slots_per_machine):
                self._free[Phase.REDUCE][SlotKey(m, Phase.REDUCE, i)] = None
        self._occupied: dict[SlotKey, TaskAttempt] = {}
        self._occupied_by_phase: dict[Phase, dict[SlotKey, TaskAttempt]] = {
            Phase.MAP: {}, Phase.REDUCE: {},
        }
        self._slot_by_task: dict[tuple, SlotKey] = {}
        # Epochs invalidate stale COMPLETE/PROGRESS events after preemption.
        self._epoch: dict[tuple, int] = {}
        self._susp_bytes: dict[int, int] = {}
        self._susp_count: dict[int, int] = {}
        self._susp_total = 0
        self._tick_pending = False
        self.result = SimResult()
        # Total events processed / scheduling passes run across all
        # (possibly incremental) run() calls — consumed by the
        # scheduler-overhead benchmarks and the epsilon-sweep reports.
        self.events_processed = 0
        self.passes = 0
        # -- fault layer (repro_torch.core.faults; active only when enabled) --
        fm = config.faults
        self.faults = fm if (fm is not None and fm.enabled) else None
        self._injector = (
            FaultInjector(self.faults, cluster.num_machines)
            if self.faults is not None
            else None
        )
        # Machines currently out of the pool ("crash" | "blacklist").
        # Slots on a down machine stay inside self._free — free_slots()
        # filters the VIEW, so the Resume path's `slot in self._free`
        # assert (intra-pass suspend/resume handover) is untouched.
        self._machine_down: dict[int, str] = {}
        # Speculative shadow executions: task key -> (slot, started_at,
        # generation).  A shadow claims a physical slot but is invisible
        # to the scheduler (never in _occupied or JobState).
        self._spec_running: dict[tuple, tuple[SlotKey, float, int]] = {}
        self._spec_seq = itertools.count()
        # Outstanding arrivals — machine fault events are moot once the
        # workload is drained (no arrivals left, no live jobs), which
        # keeps crash/recover regeneration from inflating the makespan.
        self._arrivals_left = len(self._jobs)
        # -- live-service seam (repro_torch.service; None = offline replay) --
        # Observer callbacks, called AFTER the engine applied the state
        # change (they must not mutate engine state, so the listener-less
        # twin replay stays bit-identical): action_listener(action, now)
        # after every applied scheduling action, completion_listener(
        # job_id, now) on every job completion.
        self.action_listener = None
        self.completion_listener = None

    # ------------------------------------------------------------------
    # ClusterView protocol
    # ------------------------------------------------------------------
    def free_slots(self, phase: Phase) -> list[SlotKey]:
        if self._machine_down:
            down = self._machine_down
            return [s for s in self._free[phase] if s.machine not in down]
        return list(self._free[phase])

    def slot_occupant(self, slot: SlotKey) -> TaskAttempt | None:
        return self._occupied.get(slot)

    def occupied_slots(self, phase: Phase) -> dict[SlotKey, TaskAttempt]:
        # Returned dict is live state — schedulers must treat it read-only.
        return self._occupied_by_phase[phase]

    def machine_suspended_count(self, machine: int) -> int:
        return self._susp_count.get(machine, 0)

    def machine_suspended_bytes(self, machine: int) -> int:
        return self._susp_bytes.get(machine, 0)

    def total_suspended_bytes(self) -> int:
        return self._susp_total

    # ------------------------------------------------------------------
    # Event helpers
    # ------------------------------------------------------------------
    def _push(self, t: float, kind: int, payload: object) -> None:
        heapq.heappush(self._heap, (t, kind, next(self._seq), payload))

    def _bump(self, key: tuple) -> int:
        self._epoch[key] = self._epoch.get(key, 0) + 1
        return self._epoch[key]

    def _job_state(self, job_id: int) -> JobState:
        return self.scheduler.jobs[job_id]

    # ------------------------------------------------------------------
    # Action application
    # ------------------------------------------------------------------
    def _apply(self, action: Action) -> None:
        now = self._now
        if isinstance(action, Start):
            att, slot = action.attempt, action.slot
            assert att.state is TaskState.PENDING, (att.spec.key, att.state)
            assert slot in self._free[slot.phase], slot
            del self._free[slot.phase][slot]
            js = self._job_state(att.spec.job_id)
            js.transition(att, TaskState.RUNNING)
            att.machine = slot.machine
            att.started_at = now
            att.attempts += 1
            self._occupied[slot] = att
            self._occupied_by_phase[slot.phase][slot] = att
            self._slot_by_task[att.spec.key] = slot
            if js.first_dispatch_time is None:
                js.first_dispatch_time = now
                self.result.first_dispatch[att.spec.job_id] = now
            ep = self._bump(att.spec.key)
            if self._injector is not None:
                self._arm_fate(att, ep, now)
            rem = att.remaining
            if att.rate != 1.0:
                rem = rem / att.rate  # straggling attempt: dilated wall time
            self._push(now + rem, _COMPLETE, (att, ep))
            if (
                att.spec.phase is Phase.REDUCE
                and att.remaining > self.progress_delta
            ):
                self._push(now + self.progress_delta, _PROGRESS, (att, ep))
            self.scheduler.on_task_started(att, slot)
        elif isinstance(action, Resume):
            att, slot = action.attempt, action.slot
            assert att.state is TaskState.SUSPENDED, (att.spec.key, att.state)
            assert att.machine == slot.machine, "resume must be local (Sect 3.3)"
            assert slot in self._free[slot.phase], slot
            del self._free[slot.phase][slot]
            # Swap-in cost: roll back progress by the DMA latency.
            cost = self.spec.suspend_cost(att.spec.state_bytes)
            att.progress = max(0.0, att.progress - cost)
            self._job_state(att.spec.job_id).transition(att, TaskState.RUNNING)
            att.started_at = now
            att.attempts += 1
            self._occupied[slot] = att
            self._occupied_by_phase[slot.phase][slot] = att
            self._slot_by_task[att.spec.key] = slot
            self._susp_bytes[slot.machine] = self._susp_bytes.get(
                slot.machine, 0
            ) - att.spec.state_bytes
            self._susp_count[slot.machine] = (
                self._susp_count.get(slot.machine, 0) - 1
            )
            self._susp_total -= att.spec.state_bytes
            ep = self._bump(att.spec.key)
            if self._injector is not None:
                self._arm_fate(att, ep, now)
            rem = att.remaining
            if att.rate != 1.0:
                rem = rem / att.rate
            self._push(now + rem, _COMPLETE, (att, ep))
            self.scheduler.on_task_resumed(att, slot)
        elif isinstance(action, Suspend):
            att = action.attempt
            assert att.state is TaskState.RUNNING, (att.spec.key, att.state)
            slot = self._slot_by_task.pop(att.spec.key)
            del self._occupied[slot]
            del self._occupied_by_phase[slot.phase][slot]
            self._free[slot.phase][slot] = None
            elapsed = now - att.started_at
            if att.rate != 1.0:
                elapsed *= att.rate  # straggling attempt accrued work slower
            att.progress = min(att.spec.duration, att.progress + elapsed)
            self._job_state(att.spec.job_id).transition(att, TaskState.SUSPENDED)
            att.suspended_at = now
            self._bump(att.spec.key)
            m = att.machine if att.machine is not None else -1
            self._susp_bytes[m] = self._susp_bytes.get(m, 0) + att.spec.state_bytes
            self._susp_count[m] = self._susp_count.get(m, 0) + 1
            self._susp_total += att.spec.state_bytes
            if self._injector is not None:
                self._cancel_shadow(att.spec.key)
                att.rate = 1.0  # a later Resume draws a fresh fate
            self.scheduler.on_task_suspended(att)
        elif isinstance(action, Kill):
            att = action.attempt
            assert att.state is TaskState.RUNNING, (att.spec.key, att.state)
            slot = self._slot_by_task.pop(att.spec.key)
            del self._occupied[slot]
            del self._occupied_by_phase[slot.phase][slot]
            self._free[slot.phase][slot] = None
            att.progress = 0.0
            self._job_state(att.spec.job_id).transition(att, TaskState.PENDING)
            att.machine = None
            att.started_at = None
            self._bump(att.spec.key)
            if self._injector is not None:
                self._cancel_shadow(att.spec.key)
                att.rate = 1.0
            self.scheduler.on_task_killed(att)
        else:  # pragma: no cover - defensive
            raise TypeError(f"unknown action {action!r}")
        if self.action_listener is not None:
            self.action_listener(action, now)

    # ------------------------------------------------------------------
    # Live-service injection seam (repro_torch.service).  Everything here is a
    # thin, deterministic wrapper over the ordinary event heap: a live
    # session and its journal replay push the exact same events in the
    # exact same order, so the twin's schedule is bit-identical.
    # ------------------------------------------------------------------
    def submit(self, spec: JobSpec) -> None:
        """Inject a dynamic job arrival (live master admission path).

        The job must arrive at or after the current simulation time and
        must not reuse a known job id.  Jobs passed to the constructor
        are seeded by ``run()``; ``submit`` is for arrivals that become
        known only while the simulation is underway.
        """
        if spec.arrival_time < self._now:
            raise ValueError(
                f"job {spec.job_id} arrival {spec.arrival_time} is in "
                f"the past (now={self._now})"
            )
        if spec.job_id in self.scheduler.jobs:
            raise ValueError(f"duplicate job id {spec.job_id}")
        self._arrivals_left += 1
        self._push(spec.arrival_time, _ARRIVAL, spec)

    def inject_fault(self, t: float, kind: str, machine: int) -> None:
        """Schedule a *scripted* machine fault at simulation time ``t``.

        ``kind`` is ``"crash"`` or ``"recover"``.  Unlike the stochastic
        crash/recover chain, scripted events do not regenerate (a
        scripted crash schedules no recovery and vice versa) and are
        never moot — the live service maps worker death onto ``crash``
        and worker rejoin onto ``recover``, and those must take effect
        even on an idle cluster.  Requires an armed fault layer
        (``FaultModel(external=True)`` suffices).
        """
        if self._injector is None:
            raise RuntimeError(
                "scripted faults need an armed fault layer — construct "
                "with SimConfig(faults=FaultModel(external=True, ...))"
            )
        if kind not in ("crash", "recover"):
            raise ValueError(f"unknown scripted fault kind {kind!r}")
        if t < self._now:
            raise ValueError(f"scripted fault at {t} is in the past "
                             f"(now={self._now})")
        self._push(t, _FAULT, (f"x{kind}", machine))

    def set_event_epsilon(self, eps: float) -> None:
        """Retune the coalescing window width mid-run (live service:
        the auto-epsilon controller tracks arrival burstiness).

        Only legal while no window is open — ``run(until=...)`` always
        flushes the open window before returning, so the live loop can
        retune after any advance.  The change is journaled as an event
        so the twin replay retunes at the identical point.
        """
        if eps < 0:
            raise ValueError(f"event_epsilon must be >= 0, got {eps}")
        if self._window_end is not None:  # pragma: no cover - defensive
            raise RuntimeError(
                "cannot retune event_epsilon with a coalescing window "
                "open; call run(until=now) first"
            )
        self.event_epsilon = float(eps)

    # ------------------------------------------------------------------
    # Event processing
    # ------------------------------------------------------------------
    def _on_arrival(self, spec: JobSpec) -> None:
        self._arrivals_left -= 1
        self.result.arrival[spec.job_id] = self._now
        self.scheduler.on_job_arrival(spec, self._now)
        # Jobs with no tasks at all complete immediately.
        js = self._job_state(spec.job_id)
        if js.is_done():
            self._complete_job(js)

    def _on_complete(self, att: TaskAttempt, epoch: int) -> None:
        if self._epoch.get(att.spec.key) != epoch:
            return  # stale (task was suspended/killed since)
        if att.state is not TaskState.RUNNING:
            return
        slot = self._slot_by_task.pop(att.spec.key)
        del self._occupied[slot]
        del self._occupied_by_phase[slot.phase][slot]
        self._free[slot.phase][slot] = None
        att.progress = att.spec.duration
        self._job_state(att.spec.job_id).transition(att, TaskState.DONE)
        self._bump(att.spec.key)
        if self._injector is not None:
            att.rate = 1.0
            self._cancel_shadow(att.spec.key)  # primary won the race
            self._injector.note_success(att.machine)
            self._maybe_lose_sample(att)  # must precede on_task_complete
        self.scheduler.on_task_complete(att.spec.job_id, att.spec.key, self._now)
        js = self._job_state(att.spec.job_id)
        if js.is_done() and js.completion_time is None:
            self._complete_job(js)

    def _on_progress(self, att: TaskAttempt, epoch: int) -> None:
        if self._epoch.get(att.spec.key) != epoch:
            return
        if att.state is not TaskState.RUNNING:
            return
        elapsed = self._now - att.started_at
        # Fraction of this task's input processed so far.  A straggling
        # attempt accrues work at att.rate, but the scheduler still sees
        # wall-clock `elapsed` — exactly the skewed signal a real
        # heartbeat would deliver (the sigma = Delta/p estimator then
        # over-estimates the straggler's size, as on a real cluster).
        worked = att.progress + (
            elapsed if att.rate == 1.0 else elapsed * att.rate
        )
        fraction = min(1.0, worked / att.spec.duration)
        self.scheduler.on_task_progress(
            att.spec.job_id, att.spec.key, fraction, elapsed, self._now
        )

    # ------------------------------------------------------------------
    # Fault layer (repro_torch.core.faults; see docs/faults.md).  Nothing below
    # is reachable when SimConfig.faults is disabled — zero-fault runs
    # stay bit-identical to pre-fault builds.
    # ------------------------------------------------------------------
    def _arm_fate(self, att: TaskAttempt, epoch: int, now: float) -> None:
        """Draw the (re)started attempt's fate and schedule its injected
        failure and/or speculative-execution check."""
        inj = self._injector
        fail_at, rate = inj.attempt_fate(att)
        att.rate = rate
        if rate != 1.0:
            inj.stats["stragglers"] += 1
            inj.record(now, "straggle", att.spec.key, att.attempts)
            if inj.model.speculation:
                # When a nominal-speed attempt would have finished, check
                # whether a speculative copy is worth launching.
                self._push(
                    now + att.remaining, _FAULT, ("spec_check", att, epoch)
                )
        if fail_at is not None:
            if att.failures < inj.model.max_task_retries:
                wall = att.remaining * fail_at / rate
                self._push(now + wall, _FAULT, ("taskfail", att, epoch))
            else:
                # Retry budget spent: stop injecting new failures into
                # this task — it reruns cleanly to completion, so no job
                # is ever lost — and account for the suppression.
                inj.stats["retries_exhausted"] += 1

    def _maybe_lose_sample(self, att: TaskAttempt) -> None:
        """Estimation-sample loss: drop this completed attempt's duration
        observation before the TrainingModule records it."""
        inj = self._injector
        if inj.model.sample_loss_rate <= 0.0:
            return
        tr = getattr(self.scheduler, "training", None)
        if tr is None:
            return
        jid, phase = att.spec.job_id, att.spec.phase
        if not tr.is_training(jid, phase):
            return
        if att.spec.key not in tr.sample_keys(jid, phase):
            return
        if inj.sample_lost(att):
            inj.stats["sample_losses"] += 1
            inj.record(self._now, "sample_lost", att.spec.key)
            self.scheduler.on_sample_lost(att)

    def _cancel_shadow(self, key: tuple) -> None:
        """Tear down the speculative copy of ``key`` — its primary
        completed, suspended, was killed, failed, or crashed out from
        under it (so any pending spec_done event is now moot)."""
        rec = self._spec_running.pop(key, None)
        if rec is None:
            return
        slot, started, _gen = rec
        self._free[slot.phase][slot] = None
        inj = self._injector
        inj.stats["work_lost_s"] += max(0.0, self._now - started)
        inj.stats["speculative_losses"] += 1
        inj.record(self._now, "spec_cancel", key)

    def _fail_task(self, att: TaskAttempt, reason: str) -> None:
        """Fail one live attempt (injected failure or machine crash):
        discard its progress, hand it to the scheduler as FAILED, and
        schedule the re-admission after the capped exponential backoff."""
        now = self._now
        inj = self._injector
        js = self._job_state(att.spec.job_id)
        if att.state is TaskState.RUNNING:
            slot = self._slot_by_task.pop(att.spec.key)
            del self._occupied[slot]
            del self._occupied_by_phase[slot.phase][slot]
            self._free[slot.phase][slot] = None
            elapsed = now - att.started_at
            if att.rate != 1.0:
                elapsed *= att.rate
            inj.stats["work_lost_s"] += att.progress + max(0.0, elapsed)
            self._cancel_shadow(att.spec.key)
        elif att.state is TaskState.SUSPENDED:
            # The swapped-out context dies with its host machine.
            m = att.machine if att.machine is not None else -1
            self._susp_bytes[m] = (
                self._susp_bytes.get(m, 0) - att.spec.state_bytes
            )
            self._susp_count[m] = self._susp_count.get(m, 0) - 1
            self._susp_total -= att.spec.state_bytes
            inj.stats["work_lost_s"] += att.progress
        else:  # pragma: no cover - callers only fail live attempts
            return
        att.progress = 0.0
        att.rate = 1.0
        att.failures += 1
        # Transition BEFORE clearing att.machine: the leaving-SUSPENDED
        # index removal in JobState.transition is machine-keyed.
        js.transition(att, TaskState.FAILED)
        att.machine = None
        att.started_at = None
        self._bump(att.spec.key)
        self.scheduler.on_task_failed(att)
        inj.record(now, reason, att.spec.key, att.failures)
        inj.stats["retries"] += 1
        self._push(
            now + inj.backoff(att.failures), _FAULT,
            ("readmit", att, att.failures),
        )

    def _fault_moot(self, payload: tuple) -> bool:
        """Whether a popped _FAULT event is stale.  Checked before the
        event may advance the clock: a moot fault event must not inflate
        the makespan or regenerate further machine churn."""
        kind = payload[0]
        if kind in ("xcrash", "xrecover"):
            # Scripted (live-service) events never go stale: a worker
            # death must take the machine down even on an idle cluster.
            return False
        if kind in ("crash", "recover", "probation"):
            return self._arrivals_left == 0 and not self.scheduler._live
        if kind in ("taskfail", "spec_check"):
            att, ep = payload[1], payload[2]
            return (
                self._epoch.get(att.spec.key) != ep
                or att.state is not TaskState.RUNNING
            )
        if kind == "readmit":
            att, gen = payload[1], payload[2]
            return att.state is not TaskState.FAILED or att.failures != gen
        if kind == "spec_done":
            att, gen = payload[1], payload[2]
            rec = self._spec_running.get(att.spec.key)
            return rec is None or rec[2] != gen
        return False  # pragma: no cover - defensive

    def _on_fault(self, payload: tuple) -> None:
        kind = payload[0]
        if kind == "crash":
            self._on_machine_crash(payload[1])
        elif kind == "recover":
            self._on_machine_recover(payload[1])
        elif kind == "xcrash":
            self._on_machine_crash(payload[1], chain=False)
        elif kind == "xrecover":
            self._on_machine_recover(payload[1], chain=False)
        elif kind == "probation":
            self._on_probation_end(payload[1])
        elif kind == "taskfail":
            self._on_task_fail_event(payload[1])
        elif kind == "readmit":
            self._on_readmit(payload[1])
        elif kind == "spec_check":
            self._on_spec_check(payload[1], payload[2])
        elif kind == "spec_done":
            self._on_spec_done(payload[1])
        else:  # pragma: no cover - defensive
            raise ValueError(f"unknown fault event {kind!r}")

    def _on_machine_crash(self, m: int, chain: bool = True) -> None:
        inj = self._injector
        now = self._now
        was_up = m not in self._machine_down
        self._machine_down[m] = "crash"  # upgrades a blacklist entry
        inj.stats["machine_crashes"] += 1
        inj.record(now, "crash", m)
        # Fail every attempt RUNNING on the machine...
        for phase in (Phase.MAP, Phase.REDUCE):
            for slot, att in list(self._occupied_by_phase[phase].items()):
                if slot.machine == m:
                    inj.stats["crash_task_failures"] += 1
                    self._fail_task(att, "crash_taskfail")
        # ...every attempt SUSPENDED on it...
        for js in list(self.scheduler._live.values()):
            for phase in (Phase.MAP, Phase.REDUCE):
                bucket = js.suspended_by_machine(phase).get(m)
                for key in list(bucket) if bucket else ():
                    inj.stats["crash_task_failures"] += 1
                    self._fail_task(js.tasks[key], "crash_taskfail")
        # ...and every speculative shadow it hosted.
        for key, rec in list(self._spec_running.items()):
            if rec[0].machine == m:
                self._cancel_shadow(key)
        if was_up:
            self.scheduler.on_machine_crashed(m)
        # Scripted crashes (chain=False) schedule no recovery: the
        # machine stays down until an explicit scripted recover (live
        # service: until the worker rejoins).
        if chain:
            self._push(now + inj.next_recover_delay(m), _FAULT, ("recover", m))

    def _on_machine_recover(self, m: int, chain: bool = True) -> None:
        inj = self._injector
        if self._machine_down.get(m) == "crash":
            del self._machine_down[m]
            inj.stats["machine_recoveries"] += 1
            inj.record(self._now, "recover", m)
            self.scheduler.on_machine_recovered(m)
        # Chain the next outage regardless of blacklist state: the
        # crash/recover cadence is a property of the machine, not of its
        # blacklist state.  Scripted recoveries (chain=False) regenerate
        # nothing.
        if chain:
            self._push(
                self._now + inj.next_outage_delay(m), _FAULT, ("crash", m)
            )

    def _on_probation_end(self, m: int) -> None:
        inj = self._injector
        inj.end_probation(m)
        inj.stats["probations_ended"] += 1
        if self._machine_down.get(m) == "blacklist":
            del self._machine_down[m]
            inj.record(self._now, "unblacklist", m)
            self.scheduler.on_machine_recovered(m)

    def _on_task_fail_event(self, att: TaskAttempt) -> None:
        inj = self._injector
        m = att.machine
        inj.stats["task_failures"] += 1
        self._fail_task(att, "taskfail")
        # Injected failures strike the hosting machine; crash-induced
        # ones don't (the machine is already down and not at fault).
        if m is not None and inj.note_injected_failure(m):
            if m not in self._machine_down:
                self._machine_down[m] = "blacklist"
                inj.stats["blacklists"] += 1
                inj.record(self._now, "blacklist", m)
                self._push(
                    self._now + inj.model.probation_s, _FAULT,
                    ("probation", m),
                )
                self.scheduler.on_machine_crashed(m)

    def _on_readmit(self, att: TaskAttempt) -> None:
        """Re-admission backoff served: FAILED -> PENDING."""
        self._job_state(att.spec.job_id).transition(att, TaskState.PENDING)
        self._injector.record(self._now, "readmit", att.spec.key)
        self.scheduler.on_task_readmitted(att)

    def _on_spec_check(self, att: TaskAttempt, epoch: int) -> None:
        """A straggling attempt outlived its nominal completion time:
        launch a speculative copy on a spare slot, or keep checking."""
        inj = self._injector
        key = att.spec.key
        if key in self._spec_running:
            return  # pragma: no cover - single spec_check per epoch
        # Work the straggler still has left, in nominal seconds.
        worked = att.progress + (self._now - att.started_at) * att.rate
        remaining = att.spec.duration - worked
        if remaining <= inj.model.speculation_min_remaining:
            return
        if att.spec.duration >= remaining / att.rate:
            return  # a from-scratch copy would lose the race anyway
        phase = att.spec.phase
        slots = self.free_slots(phase)
        slot = next(
            (s for s in slots if s.machine != att.machine),
            slots[0] if slots else None,
        )
        if slot is None:
            # No spare capacity right now: check again next heartbeat.
            self._push(
                self._now + self.heartbeat, _FAULT,
                ("spec_check", att, epoch),
            )
            return
        del self._free[phase][slot]
        gen = next(self._spec_seq)
        self._spec_running[key] = (slot, self._now, gen)
        inj.stats["speculative_launches"] += 1
        inj.record(self._now, "spec_launch", key, slot.machine)
        self._push(
            self._now + att.spec.duration, _FAULT, ("spec_done", att, gen)
        )

    def _on_spec_done(self, att: TaskAttempt) -> None:
        """The speculative copy finished first and wins the race: the
        straggling primary is killed, the task completes on the shadow's
        machine."""
        inj = self._injector
        key = att.spec.key
        slot, _started, _gen = self._spec_running.pop(key)
        self._free[slot.phase][slot] = None
        # The primary is guaranteed RUNNING here: any suspend / kill /
        # fail / complete of it cancels the shadow, mooting this event.
        assert att.state is TaskState.RUNNING, (key, att.state)
        pslot = self._slot_by_task.pop(key)
        del self._occupied[pslot]
        del self._occupied_by_phase[pslot.phase][pslot]
        self._free[pslot.phase][pslot] = None
        elapsed = (self._now - att.started_at) * att.rate
        inj.stats["work_lost_s"] += att.progress + max(0.0, elapsed)
        inj.stats["speculative_wins"] += 1
        inj.record(self._now, "spec_win", key, slot.machine)
        att.progress = att.spec.duration
        att.rate = 1.0
        js = self._job_state(att.spec.job_id)
        js.transition(att, TaskState.DONE)
        att.machine = slot.machine
        self._bump(key)
        inj.note_success(slot.machine)
        self._maybe_lose_sample(att)
        self.scheduler.on_task_complete(att.spec.job_id, key, self._now)
        if js.is_done() and js.completion_time is None:
            self._complete_job(js)

    def _complete_job(self, js: JobState) -> None:
        js.completion_time = self._now
        self.result.completion[js.spec.job_id] = self._now
        self.result.locality_hits += js.locality_hits
        self.result.locality_misses += js.locality_misses
        self.scheduler.on_job_complete(js.spec.job_id, self._now)
        if self.completion_listener is not None:
            self.completion_listener(js.spec.job_id, self._now)

    def _live_jobs_exist(self) -> bool:
        return bool(self.scheduler._live)

    def _sample_timeline(self) -> None:
        if not self.track_timeline:
            return
        counts: dict[tuple[int, Phase], int] = {}
        for att in self._occupied.values():
            k = (att.spec.job_id, att.spec.phase)
            counts[k] = counts.get(k, 0) + 1
        for (jid, phase), n in sorted(counts.items()):
            self.result.timeline.append((self._now, jid, phase.value, n))

    def _run_pass(self) -> None:
        """Close any open coalescing window, run one scheduling pass at
        the current time, apply its actions, and keep the heartbeat
        armed."""
        self._window_end = None
        self.passes += 1
        for action in self.scheduler.schedule(self, self._now):
            self._apply(action)
        self._sample_timeline()
        if self._live_jobs_exist() and not self._tick_pending:
            self._push(self._now + self.heartbeat, _TICK, None)
            self._tick_pending = True

    # ------------------------------------------------------------------
    def run(self, until: float = math.inf, max_events: int | None = None) -> SimResult:
        """Run (or incrementally continue) the simulation up to ``until``."""
        if not getattr(self, "_arrivals_seeded", False):
            self._arrivals_seeded = True
            for spec in self._jobs:
                self._push(spec.arrival_time, _ARRIVAL, spec)
            inj = self._injector
            if inj is not None and inj.model.machine_mtbf > 0.0:
                # Seed each machine's first outage; crash/recover chains
                # regenerate from there (repro_torch.core.faults).
                for m in range(self.spec.num_machines):
                    self._push(inj.next_outage_delay(m), _FAULT, ("crash", m))
        n_events = 0
        eps = self.event_epsilon
        while self._heap:
            # Barrier check first: it processes no event, so it neither
            # consumes the max_events budget nor may the budget preempt
            # the flush — callers always observe fully-scheduled state
            # at `until`.
            if self._heap[0][0] > until:
                if self._window_end is not None:
                    # A prior slice left a window open and this run's
                    # barrier is before the window's next event: flush
                    # the deferred pass, exactly where an unsliced
                    # run(until) would have placed it.
                    self._run_pass()
                break
            n_events += 1
            if max_events is not None and n_events > max_events:
                raise EventLimitReached(
                    f"simulator exceeded {max_events} events at t={self._now}"
                    " — scheduler livelock?"
                )
            t, kind, _, payload = heapq.heappop(self._heap)
            if kind == _FAULT and self._fault_moot(payload):
                # Dropped before the clock moves: a stale fault event
                # must neither inflate the makespan nor re-arm machine
                # churn after the workload has drained.
                continue
            self.events_processed += 1
            if eps > 0.0 and self._window_end is None:
                # New coalescing window, anchored at its head event.
                self._window_end = t + eps
            self._now = max(self._now, t)
            # State mutations apply at their own event time, in stable
            # (time, kind, seq) heap order — identical to the eps=0 loop.
            if kind == _ARRIVAL:
                self._on_arrival(payload)
            elif kind == _COMPLETE:
                self._on_complete(*payload)
            elif kind == _PROGRESS:
                self._on_progress(*payload)
            elif kind == _TICK:
                self._tick_pending = False
                self.scheduler.on_tick(self._now)
            elif kind == _FAULT:
                self._on_fault(payload)
            # Coalesce before scheduling a pass: with eps > 0, any event
            # inside the open window; with eps = 0 (legacy), only
            # same-timestamp ARRIVAL/COMPLETE batches.
            if self._heap and self._heap[0][0] <= until:
                if eps > 0.0:
                    if self._heap[0][0] <= self._window_end:
                        continue
                elif self._heap[0][0] <= self._now and (
                    self._heap[0][1] in (_ARRIVAL, _COMPLETE)
                ):
                    continue
            self._run_pass()
        self.result.stats = self.scheduler.stats
        if self._injector is not None:
            self.result.faults = self._injector.stats_dict()
        self.result.makespan = self._now
        self.result.passes = self.passes
        self.result.events = self.events_processed
        return self.result
