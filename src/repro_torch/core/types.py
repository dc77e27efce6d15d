"""Workload datatypes (the subset of ``repro.core.types`` that the
workload generator and the accel cell synthesis read).

Terminology follows the paper:

* a *job* has two phases, MAP and REDUCE; each phase is a bag of *tasks*;
* a task runs on one *slot* of a *machine* (TaskTracker);
* job *size* is serialized: the sum of its task runtimes as if executed on a
  single slot (Sect. 3.1);
* *sojourn time* = completion time - arrival time.

The scheduler-side run state (``TaskAttempt``, ``JobState``, ``SlotKey``)
arrives with the discrete-event simulator slice of the port.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Phase(enum.Enum):
    MAP = "map"
    REDUCE = "reduce"

    # Members are singletons: identity hash is consistent with enum
    # equality and skips Enum.__hash__'s per-call name hashing.
    __hash__ = object.__hash__

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


@dataclass
class TaskSpec:
    """Immutable description of one task."""

    job_id: int
    phase: Phase
    index: int
    duration: float               # true serialized runtime (seconds)
    input_hosts: tuple[int, ...] = ()   # machines holding this task's input
    state_bytes: int = 0          # working-set size (preemption cost model)
    # Cached identity tuple (job_id, phase, index).
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


@dataclass
class ClusterSpec:
    """Static description of the cluster the scheduler manages.

    The defaults mirror the paper's Amazon cluster: 100 nodes, 4 MAP slots
    and 2 REDUCE slots each (Sect. 4.1).
    """

    num_machines: int = 100
    map_slots_per_machine: int = 4
    reduce_slots_per_machine: int = 2
    # EAGER suspend/resume cost = state_bytes / dma_bw (0 disables the
    # cost model and reproduces SIGSTOP-like behaviour).
    dma_bandwidth: float = 0.0
    # Hysteresis thresholds on total suspended bytes per machine (Sect. 3.3,
    # "Finite machine resources").
    suspend_bytes_hi: int = 1 << 62
    suspend_bytes_lo: int = 1 << 61
