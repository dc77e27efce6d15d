"""Declarative scenario specifications (the experiment matrix, Sect. 4).

A copy of ``repro.scenarios.spec`` (the port imports nothing of
``repro``).  Field names, defaults, ``to_dict`` and the hash rule are the
reference's, so a spec built here has the reference's cell id and
``spec_hash`` and a stored sweep result is found under the same key.

A :class:`ScenarioSpec` names one *cell* of the paper's evaluation matrix
by composing orthogonal axes:

* **workload** — what jobs arrive (fb / fb_scaled / ml / a recorded JSONL
  trace), at what scale and seed;
* **cluster**  — machines and per-machine slot shape (Sect. 4.1's Amazon
  cluster by default);
* **scheduler** — policy, preemption primitive, size-estimation error
  model (Fig. 6), virtual-cluster numeric backend;
* **sim**      — executor knobs (heartbeat).

Specs are frozen, hashable, and round-trip losslessly through plain JSON
dicts (``to_dict`` / ``from_dict``): a spawned sweep attempt receives its
cell as that dict.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, fields, is_dataclass, replace

#: Schema version of the dict/JSON form of a ScenarioSpec (bumped on any
#: field addition/rename so stored sweep results can detect staleness).
SPEC_VERSION = 1

WORKLOAD_KINDS = ("fb", "fb_scaled", "ml", "trace")
#: The built-in scheduling disciplines (informational; the authoritative
#: set is the discipline registry, ``repro_torch.core.disciplines.names()``,
#: which third-party code extends at runtime).  Policy names are NOT
#: validated at spec construction — a spec is plain data and must be
#: able to name a discipline that is registered later; resolution (and
#: the unknown-name error listing what IS registered) happens in
#: :func:`repro_torch.scenarios.runner.build_scheduler`.
POLICIES = ("fifo", "fair", "hfsp", "srpt", "las", "psbs")
PREEMPTIONS = ("eager", "wait", "kill")


@dataclass(frozen=True)
class WorkloadAxis:
    """What arrives: generator kind + its knobs.

    ``kind="trace"`` replays a recorded JSONL trace through the same
    simulator — golden traces are just another scenario.
    """

    kind: str = "fb"
    seed: int = 0
    num_jobs: int = 100
    #: Strip REDUCE tasks (the paper's MAP-only FB variant, Sect. 4.3).
    map_only: bool = False
    #: Intra-job task-time skew (lognormal sigma; 0 = none, the paper).
    task_jitter: float = 0.0
    #: Machines holding HDFS input replicas.  None = the cluster's machine
    #: count.  Pin it explicitly when sweeping cluster.num_machines so the
    #: workload (placement AND the shared RNG stream behind arrivals/
    #: durations) stays identical across the size axis — hosts beyond the
    #: cluster are simply permanent locality misses (paper-cluster-size
    #: pins 100, the Fig. 5 convention).
    num_hosts: int | None = None
    #: kind="trace": path to the JSONL trace file.
    trace_path: str | None = None

    def __post_init__(self) -> None:
        if self.kind not in WORKLOAD_KINDS:
            raise ValueError(
                f"unknown workload kind {self.kind!r}; expected {WORKLOAD_KINDS}"
            )
        if self.kind == "trace" and not self.trace_path:
            raise ValueError("workload kind 'trace' requires trace_path")


@dataclass(frozen=True)
class ClusterAxis:
    """Cluster shape (defaults = the paper's Amazon cluster, Sect. 4.1)."""

    num_machines: int = 100
    map_slots: int = 4
    reduce_slots: int = 2
    #: TPU adaptation: EAGER suspend/resume DMA bandwidth (0 = free).
    dma_bandwidth: float = 0.0


@dataclass(frozen=True)
class SchedulerAxis:
    """Policy + preemption + estimation-error model + vcluster backend.

    ``policy`` names a discipline.  It is validated lazily, by whatever
    runs the spec — not here — so specs and sweeps can be constructed
    over disciplines registered from user code.
    """

    policy: str = "hfsp"
    #: Preemption primitive for the engine-family disciplines (hfsp,
    #: srpt, las, psbs, and custom engine assemblies); fifo/fair never
    #: preempt and ignore it.
    preemption: str = "eager"
    #: Fig. 6 error model: finalized estimates perturbed uniformly in
    #: [s*(1-alpha), s*(1+alpha)].
    error_alpha: float = 0.0
    error_seed: int = 0
    sample_set_size: int = 5
    delta: float = 60.0
    #: Virtual-cluster numeric backend (None = auto-select).
    vc_backend: str | None = None
    #: PSBS calibration knobs (the ``paper-psbs-calibration`` preset
    #: sweeps them): late-job re-injection aggressiveness and the
    #: rank-stability spread the preemption hysteresis tolerates.
    #: Ignored by every other policy.
    #: At their defaults these fields are *omitted* from ``to_dict`` —
    #: like a disabled FaultAxis — so every pre-existing spec hash (and
    #: therefore every stored sweep result) stays valid.
    psbs_late_factor: float = 1.0
    psbs_max_spread: int = 0

    def __post_init__(self) -> None:
        if self.preemption not in PREEMPTIONS:
            raise ValueError(
                f"unknown preemption {self.preemption!r}; expected {PREEMPTIONS}"
            )


@dataclass(frozen=True)
class FaultAxis:
    """Fault-injection axis — field-for-field mirror of the simulator's
    fault model, kept separate so the declarative layer stays
    import-light and plain-JSON.

    All rates default to 0: a default axis is disabled, and a disabled
    axis is *omitted* from ``to_dict`` so every pre-fault spec hash (and
    therefore every stored sweep result) stays valid.
    """

    seed: int = 0
    machine_mtbf: float = 0.0
    machine_mttr: float = 60.0
    task_fail_rate: float = 0.0
    max_task_retries: int = 5
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    straggler_prob: float = 0.0
    straggler_factor: float = 3.0
    sample_loss_rate: float = 0.0
    blacklist_threshold: int = 3
    probation_s: float = 120.0
    speculation: bool = True
    speculation_min_remaining: float = 1.0

    @property
    def enabled(self) -> bool:
        return (
            self.machine_mtbf > 0.0
            or self.task_fail_rate > 0.0
            or self.straggler_prob > 0.0
            or self.sample_loss_rate > 0.0
        )


@dataclass(frozen=True)
class ScenarioSpec:
    """One fully-specified experiment cell."""

    name: str = "scenario"
    workload: WorkloadAxis = field(default_factory=WorkloadAxis)
    cluster: ClusterAxis = field(default_factory=ClusterAxis)
    scheduler: SchedulerAxis = field(default_factory=SchedulerAxis)
    heartbeat: float = 3.0
    #: Simulator epsilon-window event coalescing (seconds; 0 = a pass per
    #: event, bit-identical to the legacy loop).  A spec axis so
    #: sweeps can report the sojourn-vs-scheduler-overhead tradeoff per
    #: cell (the ``paper-fb-eps`` preset).  The string ``"auto"`` derives
    #: the width from the materialized workload's arrival burstiness
    #: (repro_torch.core.simulator.auto_event_epsilon) — still deterministic
    #: per cell, since the workload is a pure function of the spec.
    #: Default is ``"auto"`` (the ``paper-fb-eps`` preset quantified the
    #: tradeoff as negligible sojourn movement for a large pass-count
    #: cut); pass ``0.0`` explicitly for the legacy a-pass-per-event
    #: loop.
    event_epsilon: float | str = "auto"
    #: Fault injection (machine churn, task failures, stragglers, sample
    #: loss — the ``paper-faults`` preset).
    faults: FaultAxis = field(default_factory=FaultAxis)

    # -- JSON round-trip -----------------------------------------------------
    def to_dict(self) -> dict:
        sched = _axis_dict(self.scheduler)
        # Default-valued psbs knobs are omitted (the FaultAxis rule: a
        # knob at its default must not perturb the hash, so spec hashes
        # minted before the knob existed — and every stored sweep
        # result keyed by them — stay valid).
        for knob in ("psbs_late_factor", "psbs_max_spread"):
            if sched[knob] == _SCHEDULER_DEFAULTS[knob]:
                del sched[knob]
        d = {
            "version": SPEC_VERSION,
            "name": self.name,
            "workload": _axis_dict(self.workload),
            "cluster": _axis_dict(self.cluster),
            "scheduler": sched,
            "heartbeat": self.heartbeat,
            "event_epsilon": self.event_epsilon,
        }
        # Only when enabled: a disabled axis must not perturb the hash
        # of pre-fault specs (stored sweep results stay resumable).
        if self.faults.enabled:
            d["faults"] = _axis_dict(self.faults)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        v = d.get("version", SPEC_VERSION)
        if v != SPEC_VERSION:
            raise ValueError(
                f"scenario spec version {v} != supported {SPEC_VERSION}"
            )
        return cls(
            name=d.get("name", "scenario"),
            workload=WorkloadAxis(**d.get("workload", {})),
            cluster=ClusterAxis(**d.get("cluster", {})),
            scheduler=SchedulerAxis(**d.get("scheduler", {})),
            heartbeat=d.get("heartbeat", 3.0),
            event_epsilon=d.get("event_epsilon", "auto"),
            faults=FaultAxis(**d.get("faults", {})),
        )

    # -- identity ------------------------------------------------------------
    def spec_hash(self) -> str:
        """Stable content hash (sweep stores key results by it so a spec
        edit invalidates stale cells instead of silently reusing them)."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- axis overrides ------------------------------------------------------
    def override(self, **dotted) -> "ScenarioSpec":
        """Return a copy with dotted-path overrides applied, e.g.
        ``spec.override(**{"scheduler.policy": "fair", "workload.seed": 3})``.
        Top-level fields use their plain name (``heartbeat=...``).
        Overrides touching one axis are applied together, so co-dependent
        fields (e.g. ``workload.kind="trace"`` + ``workload.trace_path``)
        validate against the combined state."""
        by_axis: dict[str, dict[str, object]] = {}
        top: dict[str, object] = {}
        for path, value in dotted.items():
            if "." in path:
                axis_name, leaf = path.split(".", 1)
                axis = getattr(self, axis_name, None)
                if (
                    not is_dataclass(axis)
                    or not any(f.name == leaf for f in fields(axis))
                ):
                    raise KeyError(f"unknown scenario field {path!r}")
                by_axis.setdefault(axis_name, {})[leaf] = value
            else:
                if not any(f.name == path for f in fields(self)):
                    raise KeyError(f"unknown scenario field {path!r}")
                top[path] = value
        changes: dict[str, object] = dict(top)
        for axis_name, leaves in by_axis.items():
            changes[axis_name] = replace(getattr(self, axis_name), **leaves)
        return replace(self, **changes)

    def quick(self) -> "ScenarioSpec":
        """Reduced-scale variant for smoke sweeps: same matrix axes, small
        trace (30 jobs, 20 machines for the fb kinds).  Deterministic —
        the quick cell is itself a well-defined scenario."""
        if self.workload.kind in ("fb", "fb_scaled"):
            out = self.override(**{
                "workload.num_jobs": min(self.workload.num_jobs, 30),
                "cluster.num_machines": min(self.cluster.num_machines, 20),
            })
        elif self.workload.kind == "ml":
            out = self.override(**{
                "workload.num_jobs": min(self.workload.num_jobs, 12),
            })
        else:
            out = self
        return replace(out, name=out.name + "@quick")


def _axis_dict(axis) -> dict:
    return {f.name: getattr(axis, f.name) for f in fields(axis)}


#: SchedulerAxis field defaults (for the to_dict omit-at-default rule).
_SCHEDULER_DEFAULTS = {f.name: f.default for f in fields(SchedulerAxis)}


# ---------------------------------------------------------------------------
# Sweeps: a parameter grid over a base scenario
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SweepSpec:
    """A named experiment = union of parameter grids over a base scenario.

    Each grid maps a dotted axis path (see :meth:`ScenarioSpec.override`)
    to the values it takes; a grid expands to the cartesian product of its
    axes and the sweep to the (de-duplicated) union of its grids.  Multiple
    grids express non-rectangular matrices — e.g. Fig. 6's HFSP
    error-alpha x error-seed grid plus a single error-independent FAIR
    reference cell.

    Per-cell seeding is deterministic by construction: any RNG seed
    (workload seed, estimator error seed) is an explicit axis value baked
    into the cell's spec, so a cell's result is a pure function of the
    cell — the contract the resumable result store relies on.
    """

    name: str
    base: ScenarioSpec
    grids: tuple[tuple[tuple[str, tuple], ...], ...] = ((),)

    @staticmethod
    def grid(**axes) -> tuple[tuple[str, tuple], ...]:
        """One grid: ``SweepSpec.grid(**{"scheduler.policy": ["fifo"]})``."""
        return tuple((k, tuple(v)) for k, v in axes.items())

    def expand(self) -> list[tuple[str, ScenarioSpec]]:
        """[(cell_id, spec)] — deterministic order, duplicates dropped."""
        cells: list[tuple[str, ScenarioSpec]] = []
        seen: set[str] = set()
        for grid in self.grids:
            for combo in _product(grid):
                spec = self.base.override(**dict(combo))
                cid = cell_id(combo)
                if cid not in seen:
                    seen.add(cid)
                    cells.append((cid, spec))
        return cells


def cell_id(combo: tuple[tuple[str, object], ...]) -> str:
    """Human-readable deterministic cell key, e.g.
    ``scheduler.policy=hfsp,workload.seed=2`` (empty combo -> ``base``)."""
    if not combo:
        return "base"
    return ",".join(f"{k}={v}" for k, v in sorted(combo))


def parse_cell_id(cid: str) -> dict[str, str]:
    """Inverse of :func:`cell_id`: {dotted-path: value-as-string}.

    The single decoder for every cell-id consumer (benchmarks, examples)
    — values are returned as strings, the caller casts.  Note the format
    does not escape ``,``/``=``; axes whose *values* contain them (e.g. a
    swept trace_path) are not representable and a sweep over them should
    key cells differently.
    """
    if cid == "base":
        return {}
    return dict(part.split("=", 1) for part in cid.split(","))


def _product(grid: tuple[tuple[str, tuple], ...]):
    """Cartesian product of one grid's axes as override tuples."""
    if not grid:
        yield ()
        return
    (key, values), rest = grid[0], grid[1:]
    for v in values:
        for tail in _product(rest):
            yield ((key, v),) + tail
