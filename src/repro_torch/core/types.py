"""Core datatypes shared by every scheduler (HFSP, FIFO, FAIR) and by both
execution substrates (the discrete-event simulator and the gang runtime).

A copy of ``repro.core.types``; the port imports nothing of ``repro``.

Terminology follows the paper:

* a *job* has two phases, MAP and REDUCE; each phase is a bag of *tasks*;
* a task runs on one *slot* of a *machine* (TaskTracker);
* job *size* is serialized: the sum of its task runtimes as if executed on a
  single slot (Sect. 3.1 — "the remaining amount of work of a job is
  independent of the resources available in the cluster");
* *sojourn time* = completion time - arrival time.

In the TPU adaptation (see DESIGN.md §2) a "machine" is a host with a gang
of chips, a "slot" is a gang slot, and a "task" is a step quantum; the
datatypes are identical, only the duration/cost models differ.

Performance note: schedulers are consulted on *every* simulator event
(tens of thousands per workload), so :class:`JobState` maintains
incremental per-(phase, state) indices — every task state change MUST go
through :meth:`JobState.transition` so that queries stay O(bucket) and
counters stay O(1).
"""

from __future__ import annotations

import enum
import itertools
import math
from dataclasses import dataclass, field


class Phase(enum.Enum):
    MAP = "map"
    REDUCE = "reduce"

    # Members are singletons: identity hash is consistent with enum
    # equality and skips Enum.__hash__'s per-call name hashing — Phase
    # keys index the per-pass bucket dicts on the scheduler hot path.
    __hash__ = object.__hash__

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


class TaskState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    SUSPENDED = "suspended"  # EAGER-preempted; state swapped out
    # Failed (injected fault or machine crash) and sitting out its
    # re-admission backoff.  Not schedulable demand: a FAILED task is
    # neither pending nor live until the fault layer re-admits it
    # (FAILED -> PENDING).  The job's phase stays unfinished throughout.
    FAILED = "failed"
    DONE = "done"

    __hash__ = object.__hash__  # see Phase.__hash__


class Preemption(enum.Enum):
    """Preemption primitive (Sect. 3.3)."""

    EAGER = "eager"  # SUSPEND/RESUME (SIGSTOP/SIGCONT; TPU: HBM<->host DMA)
    WAIT = "wait"    # wait for the running task to drain
    KILL = "kill"    # discard work, re-queue the task from scratch


@dataclass
class TaskSpec:
    """Immutable description of one task."""

    job_id: int
    phase: Phase
    index: int
    duration: float               # true serialized runtime (seconds)
    input_hosts: tuple[int, ...] = ()   # machines holding this task's input
    state_bytes: int = 0          # working-set size (preemption cost model)
    # Cached identity tuple (job_id, phase, index) — hot in every scheduler
    # pass, so computed once.
    key: tuple = field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        self.key = (self.job_id, self.phase.value, self.index)


@dataclass
class JobSpec:
    """Immutable description of one job, as produced by the workload layer."""

    job_id: int
    arrival_time: float
    map_tasks: tuple[TaskSpec, ...]
    reduce_tasks: tuple[TaskSpec, ...]
    weight: float = 1.0           # GPS weight (Sect. 5, "different priorities")
    name: str = ""
    # Fraction of MAP tasks that must finish before REDUCE tasks become
    # schedulable (the alpha parameter of Sect. 2.2, footnote 1).
    reduce_slowstart: float = 1.0

    def tasks(self, phase: Phase) -> tuple[TaskSpec, ...]:
        return self.map_tasks if phase is Phase.MAP else self.reduce_tasks

    @property
    def size_map(self) -> float:
        return sum(t.duration for t in self.map_tasks)

    @property
    def size_reduce(self) -> float:
        return sum(t.duration for t in self.reduce_tasks)

    @property
    def size(self) -> float:
        return self.size_map + self.size_reduce


@dataclass
class TaskAttempt:
    """Mutable run state of one task (possibly across suspend/resume/kill).

    ``state`` must only be changed through :meth:`JobState.transition`.
    """

    spec: TaskSpec
    state: TaskState = TaskState.PENDING
    machine: int | None = None
    progress: float = 0.0         # seconds of work already done
    started_at: float | None = None
    suspended_at: float | None = None
    attempts: int = 0             # bumped on every (re)start, incl. after KILL
    # Monotone per-job suspension order (assigned by JobState.transition);
    # lets machine-grouped scans replay the suspension-bucket order exactly.
    susp_seq: int = 0
    # Fault layer (repro_torch.core.faults): execution-speed multiplier of the
    # current attempt (1.0 nominal, <1.0 while straggling) and the number
    # of injected/crash failures this task has absorbed so far.
    rate: float = 1.0
    failures: int = 0

    @property
    def remaining(self) -> float:
        return max(0.0, self.spec.duration - self.progress)

    def is_schedulable(self) -> bool:
        return self.state is TaskState.PENDING

    def is_live(self) -> bool:
        return self.state in (TaskState.RUNNING, TaskState.SUSPENDED)


@dataclass
class JobState:
    """Mutable bookkeeping for one job inside a scheduler.

    Maintains per-(phase, state) dict buckets (insertion-ordered sets) and a
    MAP pending-by-host index so schedulers can take O(1)/O(bucket)
    decisions at every heartbeat.
    """

    spec: JobSpec
    tasks: dict[tuple, TaskAttempt] = field(default_factory=dict)
    # Estimated serialized size per phase; None until the Training module
    # produces the initial estimate (Sect. 3.2).
    est_size: dict[Phase, float] = field(default_factory=dict)
    # True while the phase size is still the xi-weighted initial guess.
    in_training: dict[Phase, bool] = field(default_factory=dict)
    completion_time: float | None = None
    first_dispatch_time: float | None = None
    locality_hits: int = 0
    locality_misses: int = 0
    # -- incremental indices (private; see transition()) --------------------
    _buckets: dict = field(default_factory=dict, repr=False)
    _pending_by_host: dict = field(default_factory=dict, repr=False)
    _done: dict = field(default_factory=dict, repr=False)
    # SUSPENDED tasks grouped by the machine holding their swapped-out
    # state: phase -> machine -> {key: attempt}.  Lets the HFSP resume path
    # visit only machines that can actually act instead of scanning every
    # suspended task each pass.
    _suspended_by_machine: dict = field(default_factory=dict, repr=False)
    _susp_seq: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        for phase in (Phase.MAP, Phase.REDUCE):
            for st in TaskState:
                self._buckets[(phase, st)] = {}
            self._done[phase] = 0
            self._suspended_by_machine[phase] = {}
        if not self.tasks:
            for t in itertools.chain(self.spec.map_tasks, self.spec.reduce_tasks):
                att = TaskAttempt(spec=t)
                self.tasks[t.key] = att
                self._buckets[(t.phase, TaskState.PENDING)][t.key] = att
                if t.phase is Phase.MAP:
                    for h in t.input_hosts:
                        self._pending_by_host.setdefault(h, {})[t.key] = att

    # -- the single state-transition entry point ----------------------------
    def transition(self, att: TaskAttempt, new_state: TaskState) -> None:
        phase, key = att.spec.phase, att.spec.key
        old_state = att.state
        if old_state is new_state:
            return
        del self._buckets[(phase, old_state)][key]
        self._buckets[(phase, new_state)][key] = att
        att.state = new_state
        if new_state is TaskState.SUSPENDED:
            self._susp_seq += 1
            att.susp_seq = self._susp_seq
            m = att.machine if att.machine is not None else -1
            self._suspended_by_machine[phase].setdefault(m, {})[key] = att
        elif old_state is TaskState.SUSPENDED:
            m = att.machine if att.machine is not None else -1
            bucket = self._suspended_by_machine[phase].get(m)
            if bucket is not None:
                bucket.pop(key, None)
                if not bucket:
                    del self._suspended_by_machine[phase][m]
        if phase is Phase.MAP and att.spec.input_hosts:
            if old_state is TaskState.PENDING:
                for h in att.spec.input_hosts:
                    self._pending_by_host.get(h, {}).pop(key, None)
            elif new_state is TaskState.PENDING:  # KILL re-queues
                for h in att.spec.input_hosts:
                    self._pending_by_host.setdefault(h, {})[key] = att
        if new_state is TaskState.DONE:
            self._done[phase] += 1
        elif old_state is TaskState.DONE:  # pragma: no cover - never undone
            self._done[phase] -= 1

    # -- O(1) counters -------------------------------------------------------
    def n_state(self, phase: Phase, st: TaskState) -> int:
        return len(self._buckets[(phase, st)])

    def n_pending(self, phase: Phase) -> int:
        return self.n_state(phase, TaskState.PENDING)

    def n_running(self, phase: Phase) -> int:
        return self.n_state(phase, TaskState.RUNNING)

    def n_suspended(self, phase: Phase) -> int:
        return self.n_state(phase, TaskState.SUSPENDED)

    def n_done(self, phase: Phase) -> int:
        return self._done[phase]

    def n_unfinished(self, phase: Phase) -> int:
        return len(self.spec.tasks(phase)) - self._done[phase]

    # -- bucket views (O(bucket size)) ---------------------------------------
    def attempts(self, phase: Phase) -> list[TaskAttempt]:
        return [self.tasks[t.key] for t in self.spec.tasks(phase)]

    def pending(self, phase: Phase) -> list[TaskAttempt]:
        return list(self._buckets[(phase, TaskState.PENDING)].values())

    def iter_pending(self, phase: Phase):
        return iter(self._buckets[(phase, TaskState.PENDING)].values())

    def running(self, phase: Phase) -> list[TaskAttempt]:
        return list(self._buckets[(phase, TaskState.RUNNING)].values())

    def suspended(self, phase: Phase) -> list[TaskAttempt]:
        return list(self._buckets[(phase, TaskState.SUSPENDED)].values())

    def suspended_by_machine(self, phase: Phase) -> dict[int, dict]:
        """SUSPENDED tasks grouped by machine (read-only view).  Within a
        machine, insertion order equals suspension order; across machines,
        ``TaskAttempt.susp_seq`` recovers the global suspension order."""
        return self._suspended_by_machine[phase]

    def unfinished(self, phase: Phase) -> list[TaskAttempt]:
        return [a for a in self.attempts(phase) if a.state is not TaskState.DONE]

    def local_pending(self, machine: int):
        """Pending MAP tasks whose input lives on ``machine`` (delay sched)."""
        return self._pending_by_host.get(machine, {}).values()

    # -- phase queries -------------------------------------------------------
    def phase_done(self, phase: Phase) -> bool:
        return self.n_unfinished(phase) == 0

    def map_completion_fraction(self) -> float:
        total = len(self.spec.map_tasks)
        if total == 0:
            return 1.0
        return self._done[Phase.MAP] / total

    def reduce_unlocked(self) -> bool:
        return self.map_completion_fraction() >= self.spec.reduce_slowstart

    def is_done(self) -> bool:
        return self.phase_done(Phase.MAP) and self.phase_done(Phase.REDUCE)

    def active_phase(self) -> Phase:
        """The phase the job currently needs slots for."""
        return Phase.MAP if not self.phase_done(Phase.MAP) else Phase.REDUCE

    # -- sizes -------------------------------------------------------------
    def true_remaining(self, phase: Phase) -> float:
        return sum(a.remaining for a in self.attempts(phase))

    def estimated_remaining(self, phase: Phase) -> float:
        """Remaining serialized work per the *estimate* (what HFSP sees)."""
        est = self.est_size.get(phase)
        if est is None:
            return math.inf
        done = sum(a.progress for a in self.attempts(phase))
        return max(0.0, est - done)


@dataclass(frozen=True, eq=False)
class SlotKey:
    """One slot on one machine, typed by phase (MAP slots vs REDUCE slots).

    Hash/eq are identity-cached: slot objects are created once by the
    executor and reused, and hashing them is on the scheduler hot path.
    """

    machine: int
    phase: Phase
    index: int

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.machine, self.phase.value, self.index))
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other) -> bool:
        return self is other or (
            isinstance(other, SlotKey)
            and self.machine == other.machine
            and self.phase is other.phase
            and self.index == other.index
        )


@dataclass
class ClusterSpec:
    """Static description of the cluster the scheduler manages.

    The defaults mirror the paper's Amazon cluster: 100 nodes, 4 MAP slots
    and 2 REDUCE slots each (Sect. 4.1).
    """

    num_machines: int = 100
    map_slots_per_machine: int = 4
    reduce_slots_per_machine: int = 2
    # TPU adaptation: cost of EAGER suspend/resume = state_bytes / dma_bw
    # (0 disables the cost model and reproduces SIGSTOP-like behaviour).
    dma_bandwidth: float = 0.0
    # Hysteresis thresholds on total suspended bytes per machine (Sect. 3.3,
    # "Finite machine resources").  When suspended state exceeds `hi`, the
    # scheduler falls back EAGER->WAIT until it drops below `lo`.
    suspend_bytes_hi: int = 1 << 62
    suspend_bytes_lo: int = 1 << 61

    def slots(self, phase: Phase) -> int:
        per = (
            self.map_slots_per_machine
            if phase is Phase.MAP
            else self.reduce_slots_per_machine
        )
        return self.num_machines * per

    def suspend_cost(self, state_bytes: int) -> float:
        if self.dma_bandwidth <= 0:
            return 0.0
        return state_bytes / self.dma_bandwidth


@dataclass
class Assignment:
    """A scheduling decision returned to the executor."""

    task: TaskAttempt
    slot: SlotKey
    local: bool = True
    resumed: bool = False


@dataclass
class SchedulerStats:
    """Counters every scheduler maintains; consumed by benchmarks."""

    suspensions: int = 0
    resumes: int = 0
    kills: int = 0
    waits: int = 0
    delay_sched_waits: int = 0
    training_tasks: int = 0
    hysteresis_fallbacks: int = 0
    # Discipline-API diagnostics: rank-stability preemption hysteresis
    # (repro_torch.core.disciplines.StabilityHysteresis) and PSBS late-job
    # virtual re-injections (PSBSLateAging).
    rank_stability_checks: int = 0
    rank_stability_vetoes: int = 0
    #: Jobs whose stability verdict was refreshed through the fused
    #: per-pass ``rank_stability_batch`` projection (vs one batched
    #: projection per job on the lazy path).
    rank_stability_batched: int = 0
    late_job_bumps: int = 0
    #: Live-service wall-tick maintenance (Scheduler.on_wall_tick ->
    #: PreemptionPolicy.on_wall_refresh): how many wall-clock refresh
    #: rounds ran, and how many cached stability verdicts they
    #: re-priced.  Always 0 in offline simulation (never ticked) —
    #: decision-neutral by contract, so these are telemetry only.
    wall_refreshes: int = 0
    wall_refreshed_verdicts: int = 0
