"""Composable scheduling disciplines (the Discipline API).

The paper observes that "the architecture underlying HFSP is suitable for
any size-based scheduling discipline" (Sect. 5): the scheduling *engine* —
demand-indexed passes, executor hooks, delay scheduling, the preemption
machinery, the Training module — is policy-agnostic, and what makes HFSP
"HFSP" is only *how jobs are ranked* (projected virtual-cluster finish
time) plus *how rank conflicts are resolved* (suspend/resume preemption
with hysteresis).  This module makes that composition explicit.  A
**discipline** is

* a :class:`RankPolicy`   — a total job order per phase (FSP virtual
  finish time, SRPT estimated remaining size, LAS attained service,
  arrival order, fair deficit);
* a :class:`PreemptionPolicy` — the preemption primitive (none /
  suspend-resume / drain-wait / kill-restart) plus hysteresis hooks
  that can veto a preemption (PSBS consults
  :meth:`~repro_torch.core.hfsp.HFSPScheduler.rank_stability` here);
* an optional :class:`AgingPolicy` — how job priorities move with time
  (virtual-cluster PS progression, plain wall-clock attained service, or
  PSBS-style re-injection of *late* jobs whose virtual copy finished
  before the real one);

assembled by a :class:`DisciplineRegistry` that the scenario engine
resolves by name, so ``SweepSpec.grid(**{"scheduler.policy": ["hfsp",
"srpt", "las", "psbs"]})`` — or any third-party registration — just
works::

    from repro_torch.core import disciplines

    class LargestFirstRank(disciplines.KeyedRankPolicy):
        name = "largest-first"
        needs_estimates = True

        def key(self, engine, js, phase, now):
            import math
            est = js.est_size.get(phase, math.inf)
            return (-est if math.isfinite(est) else math.inf,
                    js.spec.arrival_time, js.spec.job_id)

    disciplines.register("lpt", disciplines.engine_discipline(
        "lpt", LargestFirstRank, description="longest processing time first"
    ))

The built-in FIFO / FAIR / HFSP schedulers are registered here as thin
assemblies of the same parts (their rank keys live in this module; the
registry build functions construct the exact scheduler objects the scenario
runner built before this API existed, so routing through the registry is
bit-identical on the golden conformance traces), and SRPT, LAS, and PSBS
are provided as the first new disciplines — the experimental axis of
"Revisiting Size-Based Scheduling with Estimated Job Sizes" and PSBS
(Dell'Amico et al., 2014).

Engine invariants a policy may rely on are documented in
``docs/disciplines.md``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.scheduler import Scheduler, job_sort_key_fifo
from repro_torch.core.types import ClusterSpec, Phase, Preemption


# ---------------------------------------------------------------------------
# Rank policies: a total job order per phase
# ---------------------------------------------------------------------------
class RankPolicy:
    """Produces the per-phase total job order the engine schedules by.

    ``order_and_pos`` returns ``(order, pos_of)`` where ``order`` is the
    phase-live job ids in ascending rank (best-to-serve first) and
    ``pos_of`` maps job id -> index in ``order``.  The engine treats both
    as *pass-constant*: they are read once per pass and never mutated.

    Two capability flags tell the engine which subsystems to maintain:

    * ``needs_estimates`` — run the Training module (sample-task
      dispatch, size estimation, estimate-error injection);
    * ``uses_vcluster``   — maintain and age the per-phase virtual
      cluster (membership, size updates, lazy PS aging).

    ``invalidate(phase)`` is called by the engine after every structural
    event that can change rank keys or membership (arrivals, task
    completions, suspend/resume/kill materializations, estimate updates,
    REDUCE slow-start unlocks; ``phase=None`` means both phases).
    Policies that cache their order drop it here; policies whose order
    lives elsewhere (the virtual-cluster caches) may ignore it.
    """

    name = "rank"
    needs_estimates = True
    uses_vcluster = False

    def order_and_pos(
        self, engine, phase: Phase, now: float
    ) -> tuple[list[int], dict[int, int]]:
        raise NotImplementedError

    def invalidate(self, phase: Phase | None = None) -> None:
        pass


class VirtualFinishRank(RankPolicy):
    """FSP rank (Sect. 3.1): ascending projected finish time under the
    simulated max-min-fair PS virtual cluster.  The order lives in the
    virtual cluster's caches (valid across passes until the next
    structural event), so this policy carries no state of its own."""

    name = "virtual-finish"
    needs_estimates = True
    uses_vcluster = True

    def order_and_pos(self, engine, phase, now):
        vc = engine.vc[phase]
        return vc.schedule_order(now), vc.schedule_pos(now)


class KeyedRankPolicy(RankPolicy):
    """Rank by a per-job sort key over the phase-live set, with a
    per-phase order cache invalidated by the engine's structural hooks.

    Rank keys must be *event-constant*: derived only from state that
    changes at executor events (estimates, the attained-service
    counters, arrival metadata) — never from continuously-advancing
    quantities — so a cached order stays exact between events and a
    steady-state pass pays O(1) here (the same contract the virtual
    cluster's order cache relies on).
    """

    def __init__(self) -> None:
        self._order: dict[str, list[int] | None] = {
            Phase.MAP.value: None, Phase.REDUCE.value: None,
        }
        self._pos: dict[str, dict[int, int] | None] = {
            Phase.MAP.value: None, Phase.REDUCE.value: None,
        }

    def key(self, engine, js, phase: Phase, now: float) -> tuple:
        """Total-order sort key (ascending = scheduled first).  Must
        embed a deterministic tiebreak (arrival time, job id)."""
        raise NotImplementedError

    def order_and_pos(self, engine, phase, now):
        pv = phase.value
        order = self._order[pv]
        if order is None:
            jobs = engine.demand_union(phase)
            order = sorted(
                jobs, key=lambda j: self.key(engine, jobs[j], phase, now)
            )
            self._order[pv] = order
            self._pos[pv] = {j: i for i, j in enumerate(order)}
        return order, self._pos[pv]

    def invalidate(self, phase: Phase | None = None) -> None:
        if phase is None:
            for pv in self._order:
                self._order[pv] = None
                self._pos[pv] = None
        else:
            self._order[phase.value] = None
            self._pos[phase.value] = None


class SRPTRank(KeyedRankPolicy):
    """Shortest Remaining Processing Time on *estimated* sizes: rank =
    phase size estimate minus attained service.  Uses the Training
    module's online estimates (and inherits the estimate-error model),
    but not the virtual cluster — remaining work depletes with the real
    attained-service counters, not a PS emulation.  Underestimated jobs
    clamp to zero remaining and monopolize the head of the order — the
    known SRPT fragility under estimation error that the
    ``paper-estimation-error-disciplines`` preset reproduces."""

    name = "srpt-remaining"
    needs_estimates = True
    uses_vcluster = False

    def key(self, engine, js, phase, now):
        est = js.est_size.get(phase, math.inf)
        if math.isfinite(est):
            rem = max(
                0.0,
                est - engine.attained_service(js.spec.job_id, phase),
            )
        else:
            rem = math.inf
        return (rem, js.spec.arrival_time, js.spec.job_id)


class LASRank(KeyedRankPolicy):
    """Least Attained Service (FB / foreground-background): jobs that
    have received the least service rank first.  Needs no size estimates
    at all — the size-oblivious end of the size-based spectrum, the
    reference point for how much the estimates actually buy."""

    name = "las-attained"
    needs_estimates = False
    uses_vcluster = False

    def key(self, engine, js, phase, now):
        return (
            engine.attained_service(js.spec.job_id, phase),
            js.spec.arrival_time,
            js.spec.job_id,
        )


class ArrivalRank(KeyedRankPolicy):
    """Priority-weighted arrival order — the stock Hadoop FIFO key.  The
    FIFO scheduler's sorted queue is built on :meth:`key_of`; using the
    policy inside the preemptive engine yields a preemptive-FIFO
    discipline (not registered by default)."""

    name = "arrival"
    needs_estimates = False
    uses_vcluster = False

    key_of = staticmethod(job_sort_key_fifo)

    def key(self, engine, js, phase, now):
        return self.key_of(js)


class FairDeficitRank(RankPolicy):
    """The FAIR deficit order: furthest below the max-min fair target
    first, FIFO ties.  Unlike the other ranks this is not a static job
    key — the targets are recomputed per pass from the live demand — so
    the FAIR scheduler drives its own pass and only the key lives here.
    """

    name = "fair-deficit"
    needs_estimates = False
    uses_vcluster = False

    @staticmethod
    def deficit_key(targets: dict[int, int], by_id: dict, phase: Phase):
        """Sort key closure over one pass's fair targets."""

        def key(j: int) -> tuple:
            js = by_id[j]
            return (
                -(targets[j] - js.n_running(phase)),
                js.spec.arrival_time,
                j,
            )

        return key


# ---------------------------------------------------------------------------
# Preemption policies
# ---------------------------------------------------------------------------
@dataclass
class PreemptionPolicy:
    """The preemption primitive plus hysteresis hooks.

    ``mode`` is the primitive the engine's preemption machinery applies
    (EAGER suspend/resume, WAIT drain, KILL restart — Sect. 3.3; the
    engine's suspended-bytes EAGER->WAIT fallback applies on top).
    ``may_preempt`` is consulted right before the job scheduler preempts
    on behalf of a job with unmet demand; returning False skips the
    preemption for this pass (the job retries next pass).  The default
    always allows — bit-identical to the pre-API engine.
    """

    mode: Preemption = Preemption.EAGER

    def may_preempt(self, engine, js, phase: Phase, now: float) -> bool:
        return True

    def on_pass(
        self, engine, phase: Phase, now: float, have_free: bool
    ) -> None:
        """Once per (phase, scheduling pass), right after the engine read
        the free-slot state and before any job is visited — the place to
        prefetch whatever ``may_preempt`` will consult this pass (the
        batched rank-stability refresh).  Must be decision-neutral: only
        caches may change.  Default: no-op."""

    def on_estimate(self, engine, job_id: int, phase: Phase) -> None:
        """A job's phase-size estimate was just revised (sample
        observation landed).  Lets a policy mark cached verdicts dirty
        without scanning live jobs each pass.  Default: no-op."""

    def on_wall_refresh(self, engine, now: float) -> int:
        """Wall-clock-driven maintenance, reached only through the live
        service's :meth:`~repro_torch.core.scheduler.Scheduler.on_wall_tick`
        seam (offline simulation never calls it).  MUST be
        decision-neutral: only caches whose contents are bit-identical
        to what the lazy path would compute may change, so the replay
        twin — which replays journaled *simulation* events with no wall
        clock — stays deterministic.  Returns how many cached entries
        were refreshed (telemetry).  Default: no-op."""
        return 0

    def forget(self, job_id: int) -> None:
        """Evict any per-job state (called by the engine when the job
        completes)."""


@dataclass
class StabilityHysteresis(PreemptionPolicy):
    """Rank-stability preemption hysteresis (the PSBS assembly's hook).

    While a job is still in training its size estimate is provisional;
    preempting on its behalf risks suspend/resume thrash if the next
    sample observation reorders it.  Before allowing a preemption for an
    in-training job, this policy prices the job's rank across the
    Training module's candidate sizes in one batched what-if projection
    (:meth:`~repro_torch.core.hfsp.HFSPScheduler.rank_stability`) and vetoes
    the preemption when the position spread exceeds ``max_spread``.
    Verdicts are cached per (job, phase) at the current
    observation-count (observation counts only grow, so one slot per
    job-phase suffices): each estimate revision costs at most one
    batched projection, and the cache stays O(active jobs) — the
    engine's ``forget`` call evicts completed jobs.
    """

    #: Largest schedule-position spread across candidate sizes that
    #: still counts as "settled" (0 = require full agreement).
    max_spread: int = 0

    def __post_init__(self) -> None:
        # (job, phase.value) -> (observation count, spread, vetoed).
        self._cache: dict[tuple[int, str], tuple[int, int, bool]] = {}
        # phase.value -> jobs whose estimate moved since their verdict
        # was cached — the only candidates the on_pass prefetch must
        # re-price, so the prefetch costs O(estimate revisions), never
        # O(live jobs).
        self._dirty: dict[str, dict[int, None]] = {
            Phase.MAP.value: {}, Phase.REDUCE.value: {}
        }

    def may_preempt(self, engine, js, phase, now):
        jid = js.spec.job_id
        if not engine.training.is_training(jid, phase):
            return True
        n_obs = engine.training.n_observations(jid, phase)
        ck = (jid, phase.value)
        hit = self._cache.get(ck)
        if hit is None or hit[0] != n_obs:
            positions = engine.rank_stability(jid, phase, now)
            spread = (max(positions) - min(positions)) if positions else 0
            hit = (n_obs, spread, spread > self.max_spread)
            self._cache[ck] = hit
        _, spread, vetoed = hit
        engine.note_rank_stability(spread, vetoed)
        return not vetoed

    def on_estimate(self, engine, job_id, phase):
        if engine.training.is_training(job_id, phase):
            self._dirty[phase.value][job_id] = None

    def on_pass(self, engine, phase, now, have_free):
        """Batched verdict refresh: on a slot-starved pass (the only
        kind whose job walk can reach ``may_preempt``), drain the
        dirty set — jobs whose estimate was revised since their cached
        verdict (``on_estimate``) — and re-price every genuinely stale
        one through ONE ``rank_stability_batch`` projection.
        Per-scenario results are independent, so each verdict is
        bit-identical to the lazy per-job path — which still covers
        jobs the dirty set misses (first consult of a fresh job, or a
        drain below the 2-job batch threshold: a single job batches
        nothing).  Cost is O(revisions since last drain), never
        O(live jobs)."""
        if have_free:
            return
        dirty = self._dirty[phase.value]
        if len(dirty) < 2:
            return
        tr = engine.training
        stale: list[tuple[int, int]] = []
        for jid in dirty:
            if not tr.is_training(jid, phase):
                continue
            n_obs = tr.n_observations(jid, phase)
            hit = self._cache.get((jid, phase.value))
            if hit is None or hit[0] != n_obs:
                stale.append((jid, n_obs))
        dirty.clear()
        if len(stale) < 2:
            return
        positions = engine.rank_stability_batch(
            phase, [jid for jid, _ in stale], now
        )
        for jid, n_obs in stale:
            pos = positions.get(jid, [])
            spread = (max(pos) - min(pos)) if pos else 0
            self._cache[(jid, phase.value)] = (
                n_obs, spread, spread > self.max_spread
            )

    def on_wall_refresh(self, engine, now):
        """Live-service stale-verdict refresh: drain BOTH phases' dirty
        sets and re-price every genuinely stale verdict through one
        batched projection per phase — no slot-starvation gate and no
        2-job batch threshold, because wall time (a long idle stretch
        between simulation events) is what triggered us, not a pass.
        Decision-neutral by the same argument as :meth:`on_pass`: each
        refreshed verdict is bit-identical to what the lazy
        ``may_preempt`` path would compute on its next consult, so
        scheduling decisions (and the replay twin) are unchanged — the
        tick only moves the projection cost off the decision path."""
        refreshed = 0
        for phase in (Phase.MAP, Phase.REDUCE):
            dirty = self._dirty[phase.value]
            if not dirty:
                continue
            tr = engine.training
            stale: list[tuple[int, int]] = []
            for jid in dirty:
                if not tr.is_training(jid, phase):
                    continue
                n_obs = tr.n_observations(jid, phase)
                hit = self._cache.get((jid, phase.value))
                if hit is None or hit[0] != n_obs:
                    stale.append((jid, n_obs))
            dirty.clear()
            if not stale:
                continue
            positions = engine.rank_stability_batch(
                phase, [jid for jid, _ in stale], now
            )
            for jid, n_obs in stale:
                pos = positions.get(jid, [])
                spread = (max(pos) - min(pos)) if pos else 0
                self._cache[(jid, phase.value)] = (
                    n_obs, spread, spread > self.max_spread
                )
            refreshed += len(stale)
        return refreshed

    def forget(self, job_id: int) -> None:
        self._cache.pop((job_id, Phase.MAP.value), None)
        self._cache.pop((job_id, Phase.REDUCE.value), None)
        for d in self._dirty.values():
            d.pop(job_id, None)


# ---------------------------------------------------------------------------
# Aging policies
# ---------------------------------------------------------------------------
class AgingPolicy:
    """How job priorities move as time passes.

    ``advance`` is called whenever the engine's clock moves (every
    event); ``on_pass`` once per (phase, scheduling pass), before the
    rank order is read — the place for pass-scoped priority adjustments.
    """

    name = "none"

    def advance(self, engine, dt: float, now: float) -> None:
        pass

    def on_pass(self, engine, phase: Phase, now: float) -> None:
        pass

    def forget(self, job_id: int) -> None:
        """Evict any per-job state (called by the engine when the job
        completes)."""


class WallClockAging(AgingPolicy):
    """No explicit aging state: priorities move only through the
    event-materialized attained-service counters (SRPT's remaining
    shrinks, LAS's attained grows).  The engine does nothing per tick."""

    name = "wall-clock"


class VirtualClusterAging(AgingPolicy):
    """FSP aging (Sect. 3.1): elapsed time is distributed as progress to
    every allocated *virtual* task (lazily — see
    :meth:`repro_torch.core.vcluster.VirtualCluster.age`)."""

    name = "virtual-cluster"

    def advance(self, engine, dt, now):
        for vc in engine.vc.values():
            vc.age(dt)


@dataclass
class PSBSLateAging(VirtualClusterAging):
    """PSBS-style late-job aging on top of FSP virtual progression.

    Under estimation error, an *underestimated* job's virtual copy
    finishes before the real job does.  Plain FSP then gives the "late"
    job absolute priority forever (its projected finish lies in the
    past) — one badly underestimated giant can monopolize the cluster.
    PSBS instead re-injects late jobs into the virtual cluster with a
    fresh size re-estimate so they keep competing fairly: ``late_factor
    x estimated-task-time x real-unfinished-tasks`` of virtual
    remaining work, scaled by ``growth ** bump-count`` — exponential
    escalation, so a job whose true size exceeds its estimate by a
    factor F is re-injected only O(log F) times (each bump costs an
    order-cache rebuild; without escalation a badly underestimated job
    would go virtually-done again within one estimated-task-time and
    re-rank the cluster every pass).  Detection is cheap:
    :meth:`VirtualCluster.virtually_done` is horizon-gated, so
    steady-state passes pay O(1) and the scan only runs when queued
    aging could actually have finished a job.
    """

    name = "psbs-late"
    #: Fraction of the re-estimated remaining work re-injected per bump.
    late_factor: float = 1.0
    #: Escalation base: bump k re-injects growth**k times the base
    #: re-estimate (2.0 = classic doubling).
    growth: float = 2.0
    #: Per-(phase, job) bump counts (event-deterministic).
    _bumps: dict = field(default_factory=dict, repr=False)

    def on_pass(self, engine, phase, now):
        vc = engine.vc[phase]
        late = vc.virtually_done()
        if not late:
            return
        bumped = False
        for jid in late:
            js = engine.jobs.get(jid)
            if js is None or jid not in vc:
                continue
            n_left = js.n_unfinished(phase)
            if not n_left:
                continue
            k = (phase.value, jid)
            count = self._bumps.get(k, 0)
            self._bumps[k] = count + 1
            tt = vc.jobs[jid].task_time
            scale = self.growth ** min(count, 50)
            vc.set_remaining(
                jid, self.late_factor * max(tt * n_left, tt) * scale
            )
            engine.stats.late_job_bumps += 1
            bumped = True
        if bumped:
            # The virtual ranks just moved: drop cached orders (and the
            # engine's epoch-keyed pass caches) before this pass reads
            # them.
            engine._rank_dirty(phase)

    def forget(self, job_id: int) -> None:
        self._bumps.pop((Phase.MAP.value, job_id), None)
        self._bumps.pop((Phase.REDUCE.value, job_id), None)


# ---------------------------------------------------------------------------
# Disciplines and the registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Discipline:
    """A named, buildable scheduling discipline.

    ``build(cluster, **axis_kwargs) -> Scheduler`` receives the scenario
    scheduler-axis fields as keyword arguments (``preemption``,
    ``sample_set_size``, ``delta``, ``error_alpha``, ``error_seed``,
    ``vc_backend``, ``vc_device``, plus ``config=`` for a pre-built
    scheduler config)
    and must ignore the ones it does not consume — FIFO ignores all of
    them.  The ``rank`` / ``preemption`` / ``aging`` fields are the
    assembly's *descriptive* policy names (what ``list`` surfaces and
    docs reference); the build function is the executable assembly.
    """

    name: str
    build: Callable[..., Scheduler]
    rank: str = "rank"
    preemption: str = "eager"
    aging: str = "none"
    description: str = ""


class DisciplineRegistry:
    """Name -> Discipline, resolved by the scenario engine at build time
    (:func:`repro_torch.scenarios.runner.build_scheduler`); scenario specs do
    NOT validate policy names eagerly, so registering a discipline from
    user code is enough to make it sweepable."""

    def __init__(self) -> None:
        self._disciplines: dict[str, Discipline] = {}

    def register(
        self, name: str, discipline: Discipline, *, override: bool = False
    ) -> Discipline:
        if not override and name in self._disciplines:
            raise ValueError(
                f"discipline {name!r} is already registered; pass "
                f"override=True to replace it"
            )
        self._disciplines[name] = discipline
        return discipline

    def get(self, name: str) -> Discipline:
        try:
            return self._disciplines[name]
        except KeyError:
            raise KeyError(
                f"unknown scheduling discipline {name!r}; registered: "
                f"{', '.join(self.names())}"
            ) from None

    def names(self) -> list[str]:
        return sorted(self._disciplines)

    def build(self, name: str, cluster: ClusterSpec, **kwargs) -> Scheduler:
        return self.get(name).build(cluster, **kwargs)


#: The default (module-level) registry every consumer resolves against.
REGISTRY = DisciplineRegistry()


def register(
    name: str, discipline: Discipline, *, override: bool = False
) -> Discipline:
    """Register ``discipline`` under ``name`` in the default registry."""
    return REGISTRY.register(name, discipline, override=override)


def get(name: str) -> Discipline:
    return REGISTRY.get(name)


def names() -> list[str]:
    return REGISTRY.names()


def build_scheduler(name: str, cluster: ClusterSpec, **kwargs) -> Scheduler:
    """Build the named discipline's scheduler (the scenario runner's
    single resolution point)."""
    return REGISTRY.build(name, cluster, **kwargs)


# ---------------------------------------------------------------------------
# Built-in assemblies
# ---------------------------------------------------------------------------
def _engine_config(
    *,
    preemption: Preemption | str = "eager",
    sample_set_size: int = 5,
    delta: float = 60.0,
    error_alpha: float = 0.0,
    error_seed: int = 0,
    vc_backend: str | None = None,
    vc_device: str = "cuda",
    config=None,
    **_ignored,
):
    """HFSPConfig from scenario scheduler-axis kwargs (``config=``
    short-circuits for callers holding a fully-built config — tests and
    benchmarks that set debug knobs like ``paranoid_indexes``)."""
    if config is not None:
        return config
    from repro_torch.core.hfsp import HFSPConfig

    if isinstance(preemption, str):
        preemption = Preemption(preemption)
    return HFSPConfig(
        preemption=preemption,
        sample_set_size=sample_set_size,
        delta=delta,
        error_alpha=error_alpha,
        error_seed=error_seed,
        vc_backend=vc_backend,
        vc_device=vc_device,
    )


def engine_discipline(
    name: str,
    rank_factory: Callable[[], RankPolicy],
    *,
    aging_factory: Callable[[], AgingPolicy] | None = None,
    hysteresis: Callable[[Preemption], PreemptionPolicy] | None = None,
    description: str = "",
) -> Discipline:
    """Assemble a size-based-engine discipline from policy factories —
    the ~5-line path for registering a custom rank (see module
    docstring and docs/disciplines.md)."""
    rank_probe = rank_factory()

    def build(cluster: ClusterSpec, **kwargs) -> Scheduler:
        from repro_torch.core.hfsp import HFSPScheduler

        cfg = _engine_config(**kwargs)
        policy = hysteresis(cfg.preemption) if hysteresis else None
        return HFSPScheduler(
            cluster,
            cfg,
            rank=rank_factory(),
            aging=aging_factory() if aging_factory else None,
            preemption_policy=policy,
            name=name,
        )

    return Discipline(
        name=name,
        build=build,
        rank=rank_probe.name,
        preemption="axis" if hysteresis is None else "axis+stability",
        aging=(
            aging_factory().name
            if aging_factory
            else (
                VirtualClusterAging.name
                if rank_probe.uses_vcluster
                else WallClockAging.name
            )
        ),
        description=description,
    )


def _build_fifo(cluster: ClusterSpec, *, config=None, **_ignored) -> Scheduler:
    from repro_torch.core.fifo import FIFOScheduler

    return FIFOScheduler(cluster, config)


def _build_fair(cluster: ClusterSpec, *, config=None, **_ignored) -> Scheduler:
    from repro_torch.core.fair import FairScheduler

    return FairScheduler(cluster, config)


register("fifo", Discipline(
    name="fifo",
    build=_build_fifo,
    rank=ArrivalRank.name,
    preemption="none",
    aging=WallClockAging.name,
    description="stock Hadoop FIFO (priority-weighted arrival order)",
))

register("fair", Discipline(
    name="fair",
    build=_build_fair,
    rank=FairDeficitRank.name,
    preemption="none",
    aging=WallClockAging.name,
    description="Hadoop Fair Scheduler (max-min deficit order)",
))

register("hfsp", engine_discipline(
    "hfsp",
    VirtualFinishRank,
    description="HFSP: FSP virtual-finish rank + axis preemption (the paper)",
))

register("srpt", engine_discipline(
    "srpt",
    SRPTRank,
    description="SRPT on estimated remaining size (error-fragile)",
))

register("las", engine_discipline(
    "las",
    LASRank,
    description="least attained service (size-oblivious reference)",
))

def _build_psbs(
    cluster: ClusterSpec,
    *,
    psbs_late_factor: float = 1.0,
    psbs_max_spread: int = 0,
    **kwargs,
) -> Scheduler:
    """PSBS assembly with its calibration knobs exposed as scenario axes
    (``scheduler.psbs_late_factor`` / ``scheduler.psbs_max_spread``, see
    the ``paper-psbs-calibration`` preset): how aggressively late jobs
    are re-injected, and how much rank-stability spread the hysteresis
    tolerates before vetoing a preemption.  Defaults reproduce the first
    assembly exactly."""
    from repro_torch.core.hfsp import HFSPScheduler

    cfg = _engine_config(**kwargs)
    return HFSPScheduler(
        cluster,
        cfg,
        rank=VirtualFinishRank(),
        aging=PSBSLateAging(late_factor=float(psbs_late_factor)),
        preemption_policy=StabilityHysteresis(
            mode=cfg.preemption, max_spread=int(psbs_max_spread)
        ),
        name="psbs",
    )


register("psbs", Discipline(
    name="psbs",
    build=_build_psbs,
    rank=VirtualFinishRank.name,
    preemption="axis+stability",
    aging=PSBSLateAging.name,
    description="PSBS: FSP + late-job aging + rank-stability hysteresis",
))
