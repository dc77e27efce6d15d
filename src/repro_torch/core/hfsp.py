"""The Hadoop Fair Sojourn Protocol scheduler (Sect. 3).

HFSP is a *hierarchical* scheduler (Sect. 3.1.1):

* the **top-level scheduler** balances slots between the Training module
  (job size estimation, Sect. 3.2) and the job scheduler;
* the **job scheduler** ranks jobs by their projected finish time under a
  simulated max-min-fair processor-sharing discipline (the *virtual
  cluster*, Sect. 3.1) and focuses real cluster resources on the jobs that
  would finish first, preempting jobs that would finish later;
* **preemption** (Sect. 3.3) is EAGER (suspend/resume), WAIT (drain) or
  KILL, with a hysteresis fallback EAGER->WAIT when too much task state is
  suspended ("Finite machine resources").

Interaction rules between delay scheduling and preemption (these matter —
naive composition causes suspend/resume thrash):

* a job that *voluntarily declined* free slots this pass (delay
  scheduling, hoping for data locality) must NOT preempt other jobs in the
  same pass — preemption is for jobs that genuinely cannot be served;
* slots freed *by* preemption are assigned immediately, bypassing the
  delay-scheduling wait (locality was already forfeited by deciding to
  preempt).

The scheduler is pure decision logic: it runs unmodified under the
discrete-event simulator (:mod:`repro_torch.core.simulator`, the paper's Mumak
analogue) and under the gang runtime (:mod:`repro_torch.runtime.gang`).

Performance notes (incremental scheduler-state engine)
------------------------------------------------------
The scheduler runs a full pass on every executor event, so per-pass cost is
the practicality bottleneck (Sect. 4's "negligible overhead" claim).
Profiling the 100-job FB trace on the pre-incremental code showed the
per-pass ``ensure_indices`` rebuild of the running-task indexes consuming
8.6 s of a 16.4 s simulation (53%): 66,891 full rebuilds, ~13 M
``dict.setdefault`` + ``list.append`` calls and ~2 M list sorts, all to
recreate state that changes by only a handful of tasks per event.

This module now reads the base scheduler's *incremental* run-state indexes
(``Scheduler._slot_of`` / ``_run_by_job`` / ``_run_by_machine``, updated in
O(1) by executor hooks — see :mod:`repro_torch.core.scheduler`), making a pass
O(changed-tasks + actions) instead of O(running-tasks).  Together with lazy
virtual-cluster aging (:mod:`repro_torch.core.vcluster`) and the machine-grouped
suspended index (:class:`repro_torch.core.types.JobState`), the same trace runs
>=3x faster end-to-end with a bit-identical schedule.

Invariants the fast paths rely on (all cross-checked every pass under
``SchedulerConfig.paranoid_indexes``):

* the run indexes mirror exactly the executor's occupied slots, including
  per-bucket insertion order (preemption victim selection is
  order-sensitive);
* indexes never change *during* a pass — the executor applies actions only
  after ``schedule()`` returns, so claim filtering (``_claimed``) is the
  only intra-pass state;
* the job loop visits jobs in ascending projected-finish position and
  claims only grow, so victim eligibility shrinks monotonically within a
  pass — an empty victim walk on a machine stays empty (``victim_dead``),
  and per-machine victim lists can be memoized pass-wide (``victim_memo``);
* a machine with neither a free slot nor a running later-ordered task is a
  provable no-op for the suspended-task resume path, so whole machines are
  skipped via the per-(job, phase, machine) suspended index.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.disciplines import (
    AgingPolicy,
    PreemptionPolicy,
    RankPolicy,
    VirtualClusterAging,
    VirtualFinishRank,
    WallClockAging,
)
from repro_torch.core.estimator import (
    FirstOrderEstimator,
    TaskTimeEstimator,
    TrainingModule,
)
from repro_torch.core.scheduler import (
    Action,
    ClusterView,
    Kill,
    LazySet,
    Resume,
    Scheduler,
    SchedulerConfig,
    Suspend,
)
from repro_torch.core.types import (
    ClusterSpec,
    JobSpec,
    JobState,
    Phase,
    Preemption,
    SlotKey,
    TaskAttempt,
    TaskState,
)
from repro_torch.core.vcluster import VirtualCluster


@dataclass
class HFSPConfig(SchedulerConfig):
    """Paper defaults (Sect. 4.1): sample set 5, Delta = 60 s, xi = 1,
    Training module may use the whole cluster, eager preemption on."""

    preemption: Preemption = Preemption.EAGER
    sample_set_size: int = 5
    delta: float = 60.0
    xi: float = 1.0
    # Max slots the top-level scheduler grants the Training module (Sect.
    # 3.2: bounded "to avoid starvation in the job scheduler, for workloads
    # with bursty arrivals").  None = all slots (the paper's configuration).
    max_training_slots: int | None = None
    estimator_factory: Callable[[], TaskTimeEstimator] = FirstOrderEstimator
    # Multiplicative error injected into finalized size estimates, used by
    # the Fig. 6 robustness experiment: a wrong estimate is drawn uniformly
    # in [size*(1-alpha), size*(1+alpha)].
    error_alpha: float = 0.0
    error_seed: int = 0
    # Virtual-cluster numeric backend ("numpy" | "torch" | "auto"); None
    # defers to $REPRO_VC_BACKEND, then "auto" — numpy kernels, each of
    # which latches to torch once a phase's live-job count reaches its
    # threshold (the backends are held to bit-identical schedules by
    # tests/test_torch_sim.py, so the switch is behavior-neutral).
    vc_backend: str | None = None
    # Live-job threshold of the "auto" backend's numpy->torch latch, one
    # for both kernels; None takes each kernel's own on a CUDA device
    # (vcluster.AUTO_FILL_THRESHOLD, AUTO_PROJECT_THRESHOLD) and none on
    # the CPU.
    vc_auto_threshold: int | None = None
    # Device of the torch backend's kernels ("cuda" or "cpu"); a "torch"
    # or "auto" virtual cluster on a CUDA device raises at construction
    # when this process has none.
    vc_device: str = "cuda"
    # Live-service wall-tick maintenance cadence (seconds of *wall*
    # clock between stale-estimate refreshes through the preemption
    # policy's on_wall_refresh hook).  Only reachable via the service
    # master's on_wall_tick pacer — offline simulation never ticks, so
    # the knob is inert there.  <= 0 disables.
    wall_refresh_every: float = 10.0


class HFSPScheduler(Scheduler):
    """The size-based scheduling *engine*, assembled into a discipline.

    With the default policies (``rank=VirtualFinishRank()``, plain
    preemption, virtual-cluster aging) this IS the paper's HFSP,
    bit-identical to the pre-Discipline-API scheduler.  The seams —
    ``rank`` (job order), ``preemption_policy`` (primitive + hysteresis
    veto), ``aging`` (priority movement over time) — let the registry
    (:mod:`repro_torch.core.disciplines`) assemble SRPT, LAS, PSBS, or any
    third-party discipline out of the same engine: demand-indexed
    passes, the Training module, delay scheduling, and the preemption
    machinery are shared; only the policies differ.  The rank policy's
    capability flags gate the subsystems: ``needs_estimates`` runs the
    Training module, ``uses_vcluster`` maintains and ages the virtual
    cluster.
    """

    name = "hfsp"

    def __init__(
        self,
        cluster: ClusterSpec,
        config: HFSPConfig | None = None,
        *,
        rank: RankPolicy | None = None,
        preemption_policy: PreemptionPolicy | None = None,
        aging: AgingPolicy | None = None,
        name: str | None = None,
    ):
        cfg = config or HFSPConfig()
        if (
            preemption_policy is not None
            and preemption_policy.mode is not cfg.preemption
        ):
            # The policy's mode is authoritative: the engine's preemption
            # machinery keeps reading config.preemption, so the two must
            # agree — on a private copy, never by mutating the caller's
            # config object (which may be shared across schedulers).
            cfg = dataclasses.replace(cfg, preemption=preemption_policy.mode)
        super().__init__(cluster, cfg)
        self.config: HFSPConfig = cfg
        self.rank = rank or VirtualFinishRank()
        self.preemption_policy = preemption_policy or PreemptionPolicy(
            mode=cfg.preemption
        )
        self.aging = aging or (
            VirtualClusterAging()
            if self.rank.uses_vcluster
            else WallClockAging()
        )
        if name is not None:
            self.name = name
        self.training = TrainingModule(
            sample_set_size=cfg.sample_set_size,
            delta=cfg.delta,
            xi=cfg.xi,
            estimator=cfg.estimator_factory(),
        )
        self.vc: dict[Phase, VirtualCluster] = {
            p: VirtualCluster(
                phase=p,
                slots=cluster.slots(p),
                backend=cfg.vc_backend,
                auto_threshold=cfg.vc_auto_threshold,
                device=cfg.vc_device,
            )
            for p in (Phase.MAP, Phase.REDUCE)
        }
        self._clock = 0.0
        self._eager_enabled = True  # hysteresis state (Sect. 3.3)
        # (job_id, phase.value) pairs whose phase has been started
        # (training begun / virtual job added) — the run-once guard for
        # the REDUCE slow-start unlock, policy-independent.
        self._phase_started: set[tuple[int, str]] = set()
        # Largest rank-stability position spread observed by the
        # preemption-hysteresis hook (whatif_diagnostics).
        self._max_rank_spread = 0
        # Monotone rank-state version: bumped (via _rank_dirty) whenever
        # the schedule order may change.  Together with the base
        # scheduler's _run_epoch it keys the cross-pass caches below —
        # between passes with equal epochs, the actor list and the
        # per-machine victim maxima are provably identical, so a
        # steady-state (heartbeat-only) pass reuses them in O(1).
        self._rank_epoch = 0
        # phase.value -> (epoch key, sorted actor list).
        self._actor_cache: dict[str, tuple[tuple, list[int]]] = {}
        # (machine, phase.value) -> max schedule position among the
        # machine's RUNNING tasks (-1 = none ranked); lazily filled, and
        # dropped wholesale when either epoch moves.
        self._mvmax: dict[tuple[int, str], int] = {}
        self._mvmax_epoch: tuple[int, int] | None = None
        # Pass-scoped victim-order cache (reset per phase pass).
        self._pass_victims: list[int] | None = None
        # Machines currently out of the cluster (crashed or blacklisted
        # by the fault layer); the virtual clusters' capacity is
        # recomputed from this set so crash/recover stays idempotent.
        self._down_machines: set[int] = set()
        if cfg.error_alpha > 0:
            import numpy as _np

            self._err_rng = _np.random.default_rng(cfg.error_seed)
        else:
            self._err_rng = None
        # Last wall-clock stale-estimate refresh (see on_wall_tick).
        self._last_wall_refresh: float | None = None

    # ------------------------------------------------------------------
    # Aging (Sect. 3.1): each event distributes elapsed time as progress
    # to every allocated virtual task.
    # ------------------------------------------------------------------
    def _advance(self, now: float) -> None:
        dt = now - self._clock
        if dt > 0:
            self.aging.advance(self, dt, now)
            self._clock = now

    # ------------------------------------------------------------------
    # Events
    # ------------------------------------------------------------------
    def on_job_arrival(self, spec: JobSpec, now: float) -> JobState:
        self._advance(now)
        js = super().on_job_arrival(spec, now)
        self._start_phase(js, Phase.MAP)
        self._maybe_unlock_reduce(js)
        return js

    def _perturb(self, est: float) -> float:
        """Fig. 6 error injection on *finalized* estimates.

        Floored at a tiny positive size: with ``error_alpha > 1`` (the
        paper-psbs-calibration preset's heavier-than-Fig.-6 regime) the
        uniform factor can go negative, and a negative size is
        meaningless to the virtual cluster.  For ``alpha <= 1`` the
        factor is >= 0 and the floor changes nothing (an exactly-zero
        draw has probability zero), so every pre-existing cell result
        is untouched."""
        if self._err_rng is None or not math.isfinite(est):
            return est
        a = self.config.error_alpha
        return float(
            max(est * self._err_rng.uniform(1.0 - a, 1.0 + a), 1e-9)
        )

    def _start_phase(self, js: JobState, phase: Phase) -> None:
        tasks = js.spec.tasks(phase)
        self._phase_started.add((js.spec.job_id, phase.value))
        if self.rank.needs_estimates:
            est = self.training.start_phase(js, phase)
            js.est_size[phase] = est
            if tasks and self.rank.uses_vcluster:
                self.vc[phase].add_job(
                    js.spec.job_id, est, len(tasks), weight=js.spec.weight
                )
        self._rank_dirty(phase)

    def _maybe_unlock_reduce(self, js: JobState) -> None:
        if (
            js.spec.reduce_tasks
            and (js.spec.job_id, Phase.REDUCE.value) not in self._phase_started
            and js.reduce_unlocked()
        ):
            self._start_phase(js, Phase.REDUCE)

    def on_task_complete(self, job_id: int, key: tuple, now: float) -> None:
        self._advance(now)
        super().on_task_complete(job_id, key, now)  # run-state index upkeep
        js = self.jobs.get(job_id)
        if js is None:
            return
        phase = Phase(key[1])
        att = js.tasks[key]
        if self.rank.needs_estimates:
            new_est = self.training.observe_completion(
                js, phase, key, att.spec.duration
            )
            if new_est is not None:
                new_est = self._perturb(new_est)
                js.est_size[phase] = new_est
                if self.rank.uses_vcluster:
                    self.vc[phase].set_size(job_id, new_est)
                self.preemption_policy.on_estimate(self, job_id, phase)
        if js.n_unfinished(phase) == 0 and self.rank.uses_vcluster:
            self.vc[phase].remove_job(job_id)
        # NOTE: real task completions do NOT shrink the virtual cap — the
        # virtual cluster is a pure PS simulation (see vcluster docstring).
        if phase is Phase.MAP:
            self._maybe_unlock_reduce(js)
        # Attained service / estimates / membership changed for THIS
        # phase only (a MAP completion cannot move REDUCE rank keys; a
        # freshly-unlocked REDUCE phase was invalidated by _start_phase
        # above).
        self._rank_dirty(phase)

    def on_task_progress(
        self, job_id: int, key: tuple, fraction: float, elapsed: float, now: float
    ) -> None:
        """REDUCE-style early size estimation: sigma = Delta / p (Sect. 3.2.1)."""
        self._advance(now)
        js = self.jobs.get(job_id)
        if js is None:
            return
        phase = Phase(key[1])
        if not self.rank.needs_estimates:
            return
        new_est = self.training.observe_progress(js, phase, key, fraction, elapsed)
        if new_est is not None:
            new_est = self._perturb(new_est)
            js.est_size[phase] = new_est
            if self.rank.uses_vcluster:
                self.vc[phase].set_size(job_id, new_est)
            self.preemption_policy.on_estimate(self, job_id, phase)
            self._rank_dirty(phase)

    def on_job_complete(self, job_id: int, now: float) -> None:
        self._advance(now)
        super().on_job_complete(job_id, now)
        for vc in self.vc.values():
            vc.remove_job(job_id)
        for pv in (Phase.MAP.value, Phase.REDUCE.value):
            self._phase_started.discard((job_id, pv))
        self._skip_counts.pop(job_id, None)
        # Let the policies evict their per-job state (hysteresis verdict
        # cache, PSBS bump counts) so long runs stay O(live jobs).
        self.preemption_policy.forget(job_id)
        self.aging.forget(job_id)
        self._rank_dirty()

    # -- run-state hooks: keep the Training module's demand indexes in
    # lockstep with sample-task state changes (O(sample set) per event).
    def _training_sync(self, att) -> None:
        phase = att.spec.phase
        jid = att.spec.job_id
        if self.training.is_training(jid, phase):
            js = self.jobs.get(jid)
            if js is not None:
                self.training.sync_job(js, phase)

    def on_task_started(self, att, slot) -> None:
        super().on_task_started(att, slot)
        self._training_sync(att)

    def on_task_resumed(self, att, slot) -> None:
        super().on_task_resumed(att, slot)
        self._training_sync(att)
        self._rank_dirty(att.spec.phase)

    def on_task_suspended(self, att) -> None:
        super().on_task_suspended(att)
        self._training_sync(att)
        self._rank_dirty(att.spec.phase)

    def on_task_killed(self, att) -> None:
        super().on_task_killed(att)
        self._training_sync(att)
        self._rank_dirty(att.spec.phase)

    # -- fault hooks (see repro_torch.core.faults / docs/faults.md) ------------
    def on_task_failed(self, att) -> None:
        super().on_task_failed(att)
        self._training_sync(att)  # a FAILED sample is neither wanted nor running
        self._rank_dirty(att.spec.phase)

    def on_task_readmitted(self, att) -> None:
        super().on_task_readmitted(att)
        self._training_sync(att)  # a re-admitted sample is dispatchable again
        self._rank_dirty(att.spec.phase)

    def on_machine_crashed(self, machine: int) -> None:
        super().on_machine_crashed(machine)
        self._down_machines.add(machine)
        self._resize_vclusters()

    def on_machine_recovered(self, machine: int) -> None:
        super().on_machine_recovered(machine)
        self._down_machines.discard(machine)
        self._resize_vclusters()

    def _resize_vclusters(self) -> None:
        """Recompute virtual capacity from the down-machine set (an
        idempotent recompute, so crash-while-blacklisted sequences cannot
        double-count a machine)."""
        if self.rank.uses_vcluster:
            n_down = len(self._down_machines)
            for phase, per in (
                (Phase.MAP, self.cluster.map_slots_per_machine),
                (Phase.REDUCE, self.cluster.reduce_slots_per_machine),
            ):
                self.vc[phase].set_slots(
                    max(1, self.cluster.slots(phase) - n_down * per)
                )
        self._rank_dirty()

    def on_sample_lost(self, att) -> None:
        """A completed sample task's duration observation was dropped in
        flight: re-request a replacement sample so the size estimate is
        fit from real observations.  Fires before ``on_task_complete``,
        whose normal refit/sync path then sees the updated sample set."""
        if not self.rank.needs_estimates:
            return
        js = self.jobs.get(att.spec.job_id)
        if js is None:
            return
        self.training.lose_sample(js, att.spec.phase, att.spec.key)
        self._rank_dirty(att.spec.phase)

    def _paranoid_check(self, view: ClusterView, phase: Phase) -> None:
        super()._paranoid_check(view, phase)
        # The Training module's demand indexes share the hook-update
        # contract, so the paranoid pass cross-checks them too.
        self.training.check_indexes(phase, self.jobs)

    def on_tick(self, now: float) -> None:
        self._advance(now)

    # ------------------------------------------------------------------
    # Scheduling
    # ------------------------------------------------------------------
    def schedule(self, view: ClusterView, now: float) -> list[Action]:
        self._advance(now)
        self._begin_pass()
        self._update_hysteresis(view)
        if self.rank.uses_vcluster:
            self._warm_order_caches(now)
        actions: list[Action] = []
        for phase in (Phase.MAP, Phase.REDUCE):
            actions.extend(self._phase_schedule(view, phase, now))
        return actions

    def _warm_order_caches(self, now: float) -> None:
        """Cross-phase batched projection warm (torch backend only).

        When BOTH phases' schedule-order caches are cold — the typical
        state right after a structural event batch (arrivals, size
        re-estimates) touching MAP and REDUCE — the two PS projections
        are priced in one batched launch instead of two, halving kernel
        launches on the structural-event path.  Behavior-neutral: the
        padded batch computes bit-identical finish times (masked padding
        adds exact float zeros), and each phase's order cache is warmed
        with exactly what ``schedule_order`` would have computed.

        Only applied while both phases fit one sub-1024 padding bucket:
        there the batch is a pure dispatch amortization (single calls
        would not segment either).  At larger widths the batch kernel
        (no shrinking-bucket compaction, lockstep rows padded to the
        wider phase) does MORE work than two segmented single-phase
        projections, so the normal per-phase path wins."""
        vcs = [self.vc[p] for p in (Phase.MAP, Phase.REDUCE)]
        if any(vc.project_backend != "torch" for vc in vcs):
            return
        cold = [vc for vc in vcs if vc.order_cache_cold()]
        if len(cold) < 2:
            return
        from repro_torch.core import vcluster_torch
        import numpy as np

        states = []
        for vc in cold:
            vc._materialize()
            states.append(vc._state_arrays())
        width = max(len(s[0]) for s in states)
        if vcluster_torch._bucket(width) > 1024:
            return  # segmented per-phase projections are cheaper here
        b = len(cold)
        rem_b = np.zeros((b, width))
        caps_b = np.zeros((b, width))
        ws_b = np.zeros((b, width))
        n_valid = np.zeros(b, dtype=np.int64)
        for i, (ids, rem, caps, ws) in enumerate(states):
            n_valid[i] = len(ids)
            rem_b[i, : len(ids)] = rem
            caps_b[i, : len(ids)] = caps
            ws_b[i, : len(ids)] = ws
        fin_b = vcluster_torch.project_finish_times_batch(
            rem_b,
            caps_b,
            ws_b,
            np.array([float(vc.slots) for vc in cold]),
            float(now),
            n_valid=n_valid,
            device=cold[0].device,
        )
        for vc, (ids, _, _, _), row in zip(cold, states, fin_b):
            vc.warm_order_cache(
                {j: float(f) for j, f in zip(ids, row[: len(ids)])}
            )

    # -- what-if projections (batched on the torch backend) -------------
    def whatif_finish_times(
        self, phase: Phase, scenarios: list[dict[int, float]], now: float
    ) -> list[dict[int, float]]:
        """PS finish times under hypothetical remaining-work overrides.

        Each scenario maps job_id -> hypothetical remaining serialized
        work; unnamed jobs keep their current state.  On the torch backend
        every scenario prices in one batched launch — this is the hook for
        preemption-policy experiments (e.g. "would suspending J actually
        move the needle?") and epsilon-window event batching."""
        self._advance(now)
        return self.vc[phase].projected_finish_batch(scenarios, now)

    def rank_stability(
        self, job_id: int, phase: Phase, now: float
    ) -> list[int]:
        """Schedule positions ``job_id`` would occupy across the Training
        module's candidate sizes (leave-one-out refits of the current
        sample observations) — a measure of how settled the job's rank is
        while its size estimate is still provisional.  All candidates are
        evaluated in a single batched projection with ``set_size``
        semantics (remaining AND virtual parallelism re-derived per
        candidate, exactly what the estimator update would apply)."""
        self._advance(now)
        js = self.jobs.get(job_id)
        vc = self.vc[phase]
        if js is None or job_id not in vc:
            return []
        sizes = self.training.candidate_sizes(js, phase)
        if not sizes:
            return []
        scenarios = [{job_id: s} for s in sizes]
        fins = vc.projected_finish_batch(scenarios, now, as_sizes=True)
        return [vc._order_from_fin(fin).index(job_id) for fin in fins]

    def rank_stability_batch(
        self, phase: Phase, job_ids: list[int], now: float
    ) -> dict[int, list[int]]:
        """Rank-stability positions for MANY jobs in ONE batched
        projection.

        Concatenates every job's candidate-size scenarios (exactly the
        per-job :meth:`rank_stability` scenarios, in the same per-job
        order) into a single ``projected_finish_batch`` call, then slices
        the results back per job.  Scenario rows are independent, so each
        job's positions are bit-identical to its per-job call — this is
        the epsilon-window fusion: after a coalesced event window many
        in-training jobs need re-pricing at once, and one batched
        dispatch replaces one per job (the ROADMAP "re-project whole
        windows through one projected_finish_batch call" item).
        """
        self._advance(now)
        vc = self.vc[phase]
        spans: list[tuple[int, int, int]] = []  # (job_id, start, count)
        scenarios: list[dict[int, float]] = []
        for jid in job_ids:
            js = self.jobs.get(jid)
            if js is None or jid not in vc:
                spans.append((jid, len(scenarios), 0))
                continue
            sizes = self.training.candidate_sizes(js, phase)
            spans.append((jid, len(scenarios), len(sizes)))
            scenarios.extend({jid: s} for s in sizes)
        if not scenarios:
            return {jid: [] for jid, _, _ in spans}
        self.stats.rank_stability_batched += sum(
            1 for _, _, n in spans if n
        )
        fins = vc.projected_finish_batch(scenarios, now, as_sizes=True)
        out: dict[int, list[int]] = {}
        for jid, start, count in spans:
            out[jid] = [
                vc._order_from_fin(fin).index(jid)
                for fin in fins[start:start + count]
            ]
        return out

    def note_rank_stability(self, spread: int, vetoed: bool) -> None:
        """Record one preemption-hysteresis consultation (called by
        :class:`repro_torch.core.disciplines.StabilityHysteresis`); surfaces
        in :meth:`whatif_diagnostics` and the scenario report layer."""
        self.stats.rank_stability_checks += 1
        if vetoed:
            self.stats.rank_stability_vetoes += 1
        if spread > self._max_rank_spread:
            self._max_rank_spread = spread

    def on_wall_tick(self, wall_now: float, now: float) -> None:
        """Live-service wall-clock maintenance (the first consumer of
        the :meth:`~repro_torch.core.scheduler.Scheduler.on_wall_tick` seam).

        Every ``config.wall_refresh_every`` wall seconds, drain the
        preemption policy's stale-verdict backlog through
        ``on_wall_refresh`` — during long idle stretches between
        simulation events the lazy refresh paths (``on_pass`` /
        ``may_preempt``) never run, so without this tick a burst
        arriving after an idle period pays the whole batched projection
        on its first decision.  Sim-time purity: the hook is
        decision-neutral by contract (refreshed cache entries are
        bit-identical to what the lazy path would compute), so the
        journal replay twin — which never ticks — produces the same
        schedule; tests pin the completion fingerprint with and without
        ticks."""
        every = self.config.wall_refresh_every
        if every is None or every <= 0:
            return
        last = self._last_wall_refresh
        if last is not None and wall_now - last < every:
            return
        self._last_wall_refresh = wall_now
        refreshed = self.preemption_policy.on_wall_refresh(self, now)
        self.stats.wall_refreshes += 1
        self.stats.wall_refreshed_verdicts += int(refreshed or 0)

    def whatif_diagnostics(self) -> dict:
        """Preemption-hysteresis / what-if diagnostics for the scenario
        report layer (one dict per cell; all JSON-serializable).  Counts
        cover the whole run: how often the preemption policy priced a
        batched what-if projection (``rank_stability``), how often it
        vetoed a preemption, the largest rank spread it saw, and the
        PSBS late-job bumps.  These counters appear ONLY here — the
        report's ``stats`` block keeps its pre-Discipline-API fields
        (the suspended-bytes EAGER->WAIT fallbacks live there)."""
        return {
            "discipline": self.name,
            "rank_policy": self.rank.name,
            "aging_policy": self.aging.name,
            "rank_stability_checks": self.stats.rank_stability_checks,
            "rank_stability_vetoes": self.stats.rank_stability_vetoes,
            "rank_stability_batched": self.stats.rank_stability_batched,
            "max_rank_spread": self._max_rank_spread,
            "late_job_bumps": self.stats.late_job_bumps,
            # Calibration knobs of the assembled policies (None when the
            # assembly has no such knob — e.g. hfsp's plain FSP aging):
            # the paper-psbs-calibration preset reads its swept
            # late_factor/max_spread back from here per cell.
            "late_factor": getattr(self.aging, "late_factor", None),
            "max_spread": getattr(self.preemption_policy, "max_spread", None),
            # Live-only wall-tick maintenance (always 0 offline).
            "wall_refreshes": self.stats.wall_refreshes,
            "wall_refreshed_verdicts": self.stats.wall_refreshed_verdicts,
        }

    def _update_hysteresis(self, view: ClusterView) -> None:
        """EAGER -> WAIT fallback on suspended-state pressure (Sect. 3.3)."""
        total = view.total_suspended_bytes()
        if self._eager_enabled and total > self.cluster.suspend_bytes_hi:
            self._eager_enabled = False
            self.stats.hysteresis_fallbacks += 1
        elif not self._eager_enabled and total < self.cluster.suspend_bytes_lo:
            self._eager_enabled = True

    def _phase_schedule(
        self, view: ClusterView, phase: Phase, now: float
    ) -> list[Action]:
        actions: list[Action] = []
        pv = phase.value
        demand_indexed = self.config.demand_indexed
        live_scan: dict[int, JobState] | None = None
        if demand_indexed:
            if not self._n_live_phase[pv]:
                return actions
        else:
            # Index-free reference mode: phase-liveness comes from a
            # fresh live-table scan, so demand-index corruption diverges
            # the two modes instead of reproducing bit for bit.
            live_scan = self.live_jobs_scan(phase)
            if not live_scan:
                return actions
        # Run-state engine upkeep: O(1) count check (resyncs only under a
        # hook-less executor); full rebuild + assert in paranoid mode.
        self._maybe_resync_indexes(view, phase)
        if self.config.paranoid_indexes:
            self._paranoid_check(view, phase)
        # Pass-scoped priority adjustments (PSBS late-job re-injection)
        # run before the rank order is read so they shape this pass.
        self.aging.on_pass(self, phase, now)
        free = list(view.free_slots(phase))
        # Preemption-policy pass hook: when the pass starts slot-starved,
        # StabilityHysteresis re-prices every stale in-training verdict
        # through ONE rank_stability_batch projection here, so the
        # may_preempt consultations below are pure cache hits (identical
        # verdicts — vcluster state is static within a pass).
        self.preemption_policy.on_pass(self, phase, now, bool(free))
        # Jobs in the discipline's rank order (HFSP: ascending projected
        # PS finish time, Sect. 3.1; SRPT: estimated remaining; LAS:
        # attained service).  Positions come from the policy's order
        # cache — valid across passes until the next structural event —
        # so a steady-state pass pays O(1) here, not O(live jobs).
        order, pos_of = self.rank.order_and_pos(self, phase, now)
        # Pass-scoped victim-order cache (running jobs by ascending
        # position), built lazily on the first preemption walk.
        self._pass_victims = None

        eager_ok = (
            self.config.preemption is Preemption.EAGER and self._eager_enabled
        )
        n_live = (
            self._n_live_phase[pv] if demand_indexed else len(live_scan)
        )
        # Lazy: only preemption walks consult the protected set, and the
        # pool check materializes it at most once per phase pass.
        protected = LazySet(
            lambda: self._protected_keys(phase, n_live, live_scan)
        )
        # Pass-scoped memo of per-machine victim lists (position-sorted).
        # The run indexes are static during a pass, so each machine's list
        # is computed at most once per pass — previously the single most
        # expensive part of a pass when jobs held many suspended tasks.
        # ``victim_dead`` marks machines whose victim walk came up empty:
        # the job loop visits jobs in ascending position and claims only
        # grow, so victim eligibility (vpos > pos, unclaimed, unprotected)
        # shrinks monotonically within a pass — an empty walk stays empty.
        victim_memo: dict[int, list[tuple[int, TaskAttempt]]] = {}
        victim_dead: set[int] = set()

        # -- 1. Top-level scheduler: Training-module slots first.  "The
        # top-level scheduler responds to the arrival of a new job by
        # allocating a given set of resources to the Training module"
        # (Sect. 3.1.1) — under full load that requires preempting up to
        # the training job's fair share.
        acts, free = self._schedule_training(
            phase, free, now, pos_of, eager_ok, protected, n_live, live_scan,
        )
        actions.extend(acts)

        # -- 2. Job scheduler: focus resources in projected-finish order.
        # Only jobs with actionable demand — pending or suspended tasks —
        # can emit an action here, so those demand-index members are the
        # candidate set.  Jobs with running tasks only matter as
        # preemption victims and are reached through the victim order.
        pend = self._jobs_pending[pv]
        susp = self._jobs_suspended[pv]
        if demand_indexed and not pend and not susp:
            return actions
        rmax = -2  # lazy: highest schedule position of any running job
        if demand_indexed:
            lim = None
            if not free:
                rmax = self._max_running_pos(phase, order)
                if rmax < 0:
                    return actions
                lim = rmax
            actors = self._actors(
                phase, pend, susp, pos_of, lim, eager_ok, bool(free)
            )
        else:
            # Legacy walk: every phase-live job in schedule order.
            actors = [j for j in order if j in live_scan]
        jobs = self.jobs
        for jid in actors:
            pos = pos_of[jid]
            if demand_indexed and not free:
                if rmax == -2:
                    rmax = self._max_running_pos(phase, order)
                if pos >= rmax:
                    break  # ascending order: every later actor is a no-op too
            js = jobs[jid]
            # Resume suspended tasks in place (Sect. 3.3 locality), possibly
            # suspending tasks of *later-ordered* jobs on the same machine.
            if js.n_suspended(phase):
                acts, free = self._resume_with_preemption(
                    js, pos, phase, free, pos_of,
                    victim_memo, victim_dead, eager_ok, protected,
                )
                actions.extend(acts)
            # Start pending tasks on free slots (delay scheduling inside).
            n_delayed_before = self.stats.delay_sched_waits
            acts, free = self._assign_pending(js, phase, free, len(free), now)
            actions.extend(acts)
            delayed = self.stats.delay_sched_waits > n_delayed_before
            # Preempt later jobs for remaining unmet demand — but never on
            # behalf of a job that just declined slots to wait for locality.
            unmet = self._unclaimed_pending(js, phase)
            if (
                unmet > 0 and not free and not delayed
                # Hysteresis veto (checked last — it may price a batched
                # what-if projection): a discipline's preemption policy
                # can decline to preempt on behalf of this job this pass
                # (PSBS: while the job's rank is still unstable).
                and self.preemption_policy.may_preempt(self, js, phase, now)
            ):
                acts, freed = self._preempt_for(
                    js, pos, phase, unmet, pos_of, eager_ok, protected,
                )
                actions.extend(acts)
                if freed:
                    # Bypass delay scheduling: locality was forfeited when we
                    # chose to preempt.
                    saved = self.config.locality_enabled
                    self.config.locality_enabled = False
                    try:
                        acts, left = self._assign_pending(
                            js, phase, freed, len(freed), now
                        )
                    finally:
                        self.config.locality_enabled = saved
                    actions.extend(acts)
                    free.extend(left)
        return actions

    def _max_running_pos(self, phase: Phase, order: list[int]) -> int:
        """Highest schedule position among jobs with RUNNING tasks (-1 if
        none run).  Walks the cached order from the back, so the cost is
        O(trailing non-running jobs) — small in the focused steady state
        where HFSP serves the earliest-finishing jobs."""
        running = self._jobs_running[phase.value]
        if not running:
            return -1
        for i in range(len(order) - 1, -1, -1):
            if order[i] in running:
                return i
        return -1

    def _rank_dirty(self, phase: Phase | None = None) -> None:
        """The schedule order may have changed: bump the rank epoch
        (invalidating the cross-pass actor/mvmax caches) and forward the
        invalidation to the rank policy's own order cache."""
        self._rank_epoch += 1
        self.rank.invalidate(phase)

    def _actors(
        self,
        phase: Phase,
        pend: dict[int, None],
        susp: dict[int, None],
        pos_of: dict[int, int],
        lim: int | None,
        eager_ok: bool,
        have_free: bool,
    ) -> list[int]:
        """The pass's actor list (jobs that can emit an action), sorted
        by ascending rank position — cached across passes until the
        run/rank epochs move.

        Actor eligibility: known to the rank order and, when no slot is
        free, positioned before some running job (``lim``) — a job can
        then act only by preempting (or displacing into) a
        *later-ordered* running victim, so actors past every running
        job are provable no-ops (their victim walks break immediately
        and count nothing, in every preemption mode).

        Suspended-only actors get one further provable prune when no
        slot is free: resume is machine-local (Sect. 3.3), so such an
        actor can act only by suspending a later-ordered victim on a
        machine that holds its suspended state.  If no such machine has
        a running task positioned after the actor (``mvmax``), every
        candidate inside ``_resume_with_preemption`` fails the position
        test and the walk emits nothing — and without eager preemption
        the resume path cannot act at all without free slots.  Claims
        and the protected set only shrink eligibility further, so the
        position-only filter is exact for exclusion.  (Ranks like LAS
        can hold thousands of tied suspended jobs below ``lim``
        indefinitely; without this prune every heartbeat pass re-walked
        them all.)

        The epoch key makes the cache sound: the list is a pure function
        of the demand/run indexes (run epoch), the rank order (rank
        epoch), free-slot availability, and the hysteresis state — a
        pass that emitted actions bumps the run epoch through the
        executor hooks, so only genuinely idle passes hit the cache.
        The legacy walk (``demand_indexed=False``) never uses it; the
        equivalence suite pins the filter's neutrality."""
        pv = phase.value
        key = (self._run_epoch, self._rank_epoch, have_free, eager_ok)
        hit = self._actor_cache.get(pv)
        if hit is not None and hit[0] == key:
            return hit[1]
        cand = [
            j for j in pend
            if j in pos_of and (lim is None or pos_of[j] < lim)
        ]
        if have_free:
            cand.extend(
                j for j in susp
                if j not in pend
                and j in pos_of
                and (lim is None or pos_of[j] < lim)
            )
        elif eager_ok:
            jobs = self.jobs
            for j in susp:
                if j in pend or j not in pos_of:
                    continue
                p = pos_of[j]
                if lim is not None and p >= lim:
                    continue
                for m in jobs[j].suspended_by_machine(phase):
                    if self._machine_max_victim_pos(m, pv, pos_of) > p:
                        cand.append(j)
                        break
        actors = sorted(cand, key=pos_of.__getitem__)
        self._actor_cache[pv] = (key, actors)
        return actors

    def _machine_max_victim_pos(
        self, m: int, pv: str, pos_of: dict[int, int]
    ) -> int:
        """Highest schedule position among RUNNING tasks on machine
        ``m`` (-1 if none ranked) — the machine-local analogue of
        ``_max_running_pos``, cached across passes on the same epoch
        key as the actor list."""
        epoch = (self._run_epoch, self._rank_epoch)
        if self._mvmax_epoch != epoch:
            self._mvmax.clear()
            self._mvmax_epoch = epoch
        mk = (m, pv)
        v = self._mvmax.get(mk)
        if v is None:
            v = -1
            bucket = self._run_by_machine.get(mk)
            if bucket:
                for key in bucket:
                    p = pos_of.get(key[0])
                    if p is not None and p > v:
                        v = p
            self._mvmax[mk] = v
        return v

    def _victim_order(self, phase: Phase, pos_of: dict[int, int]) -> list[int]:
        """Jobs with RUNNING tasks by ascending schedule position, cached
        for the pass (the run indexes are static during a pass)."""
        if self._pass_victims is None:
            self._pass_victims = sorted(
                (
                    j for j in self._jobs_running[phase.value]
                    if j in pos_of
                ),
                key=pos_of.__getitem__,
            )
        return self._pass_victims

    def _pool_ok(self, phase: Phase, protected) -> bool:
        """True while >=1 RUNNING task could still be preempted this pass:
        running tasks minus protected sample tasks minus victims already
        claimed.  O(1) after the protected set materializes; turns the
        saturated-training pathology (every hungry job fruitlessly walking
        every running-but-protected task) into a single check."""
        pv = phase.value
        return (
            self._n_running_idx[pv]
            - len(protected)
            - self._claimed_running.get(pv, 0)
        ) > 0

    # -- training module (Sect. 3.2) -----------------------------------
    def _schedule_training(
        self,
        phase: Phase,
        free: list[SlotKey],
        now: float,
        pos_of: dict[int, int],
        eager_ok: bool,
        protected,
        n_live: int,
        live_scan: dict[int, JobState] | None,
    ) -> tuple[list[Action], list[SlotKey]]:
        actions: list[Action] = []
        legacy = live_scan is not None
        # Only jobs with a dispatchable sample task matter: iterate the
        # Training module's wanted index (O(actionable training jobs)),
        # not every in-training job — a job whose samples are all running
        # or observed cannot receive a training slot this pass.  The
        # index-free reference mode probes every active job instead (the
        # pre-index walk; `wanted_sample_tasks` below is the per-job
        # filter either way).
        if legacy:
            training_jobs = [
                live_scan[j]
                for j in self.training.active_jobs(phase)
                if j in live_scan
            ]
        else:
            training_jobs = [
                js
                for js in (
                    self._live.get(j) for j in self.training.wanted_jobs(phase)
                )
                if js is not None
            ]
        if not training_jobs:
            return actions, free
        # "Execution slots are assigned according to a 'fewer remaining
        # tasks' discipline, which implies short jobs are given priority."
        # job_id tiebreak = the live-dict (arrival) order the previous
        # stable sort inherited.
        training_jobs.sort(
            key=lambda js: (
                js.n_unfinished(phase), js.spec.arrival_time, js.spec.job_id,
            )
        )
        budget = self._training_budget(phase, live_scan)
        fair = max(1, self.cluster.slots(phase) // max(n_live, 1))
        mode = self.config.preemption
        can_preempt = not (
            mode is Preemption.WAIT
            or (mode is Preemption.EAGER and not eager_ok)
        )
        for js in training_jobs:
            wanted = self.training.wanted_sample_tasks(js, phase)
            if not wanted:
                continue
            quota = min(len(wanted), fair)
            # Free-slot assignments consume the global training budget;
            # preemption below merely SUBSTITUTES one training slot for
            # another, so it is not budget-gated.
            acts, free = self._assign_pending(
                js, phase, free, min(quota, max(budget, 0)), now,
                only_keys=wanted,
            )
            self.stats.training_tasks += len(acts)
            budget -= len(acts)
            quota -= len(acts)
            actions.extend(acts)
            # In-flight sample tasks count toward the fair share already
            # granted; only preempt for the genuinely unmet remainder.
            if legacy:
                running_samples = sum(
                    1
                    for k in self.training.sample_keys(js.spec.job_id, phase)
                    if js.tasks[k].state is TaskState.RUNNING
                )
            else:
                running_samples = len(
                    self.training.running_sample_keys(js.spec.job_id, phase)
                )
            unmet = min(quota, max(0, fair - running_samples))
            if unmet > 0 and not free and can_preempt:
                # Victims: last-ordered (largest) jobs first, never self.
                acts, freed = self._preempt_for(
                    js, -1, phase, unmet, pos_of, eager_ok, protected,
                )
                actions.extend(acts)
                if freed:
                    saved = self.config.locality_enabled
                    self.config.locality_enabled = False
                    try:
                        a2, left = self._assign_pending(
                            js, phase, freed, len(freed), now,
                            only_keys=self.training.wanted_sample_tasks(js, phase),
                        )
                    finally:
                        self.config.locality_enabled = saved
                    self.stats.training_tasks += len(a2)
                    budget -= len(a2)
                    actions.extend(a2)
                    free.extend(left)
        return actions, free

    def _training_budget(
        self, phase: Phase, live_scan: dict[int, JobState] | None = None
    ) -> int:
        cap = self.config.max_training_slots
        if cap is None:
            cap = self.cluster.slots(phase)
        # Slots currently held by still-training sample tasks count
        # against the budget — an O(1) read of the Training module's
        # running-sample counter (kept by the sync hooks).  The
        # index-free reference mode probes every active job's sample
        # states instead (the pre-index walk).
        if live_scan is None:
            in_flight = self.training.n_running_samples(phase)
        else:
            in_flight = 0
            for jid in self.training.active_jobs(phase):
                js = live_scan.get(jid)
                if js is None:
                    continue
                for k in self.training.sample_keys(jid, phase):
                    if js.tasks[k].state is TaskState.RUNNING:
                        in_flight += 1
        return max(0, cap - in_flight)

    # -- preemption (Sect. 3.3) ------------------------------------------
    def _protected_keys(
        self,
        phase: Phase,
        n_live: int,
        live_scan: dict[int, JobState] | None = None,
    ) -> set:
        """Running sample tasks shielded from preemption.  The Training
        module holds "at least a fair share" (Sect. 3.1.1) — a QUOTA of
        slots/num_jobs per training job, NOT blanket immunity (protecting
        every sample task would let one big in-training job starve a tiny
        arrival for a full task length)."""
        # Integer fair share, floored at 1: a running sample task is ALWAYS
        # shielded — two in-training jobs may otherwise kill each other's
        # samples every pass (progress resets under KILL => livelock).
        quota = max(1, self.cluster.slots(phase) // max(n_live, 1))
        out: set = set()
        if live_scan is not None:
            # Index-free reference mode: probe every active job's sample
            # states (the pre-index walk).
            for jid in self.training.active_jobs(phase):
                js = live_scan.get(jid)
                if js is None:
                    continue
                shielded = 0
                for key in self.training.sample_keys(jid, phase):
                    if shielded >= quota:
                        break
                    if js.tasks[key].state is TaskState.RUNNING:
                        out.add(key)
                        shielded += 1
            return out
        # Only jobs with >=1 RUNNING sample can contribute — read the
        # Training module's running-sample index (sample-set order per
        # job) instead of probing every active job's sample states.
        for keys in self.training.running_sample_jobs(phase).values():
            shielded = 0
            for key in keys:
                if shielded >= quota:
                    break
                out.add(key)
                shielded += 1
        return out

    def _preempt_for(
        self,
        js: JobState,
        pos: int,
        phase: Phase,
        unmet: int,
        pos_of: dict[int, int],
        eager_ok: bool,
        protected,
    ) -> tuple[list[Action], list[SlotKey]]:
        """Free up to ``unmet`` slots held by later-ordered jobs, walking
        the victim order (running jobs by schedule position) from the back
        (largest projected finish / size first).  Victims come straight
        from the incremental ``_run_by_job`` index — O(victims inspected),
        no pass-wide rebuild — and the walk stops at the first victim not
        ordered after ``pos``.  The preemptable-pool check skips the walk
        entirely once nothing unprotected is left running."""
        actions: list[Action] = []
        freed: list[SlotKey] = []
        if not self._pool_ok(phase, protected):
            return actions, freed
        mode = self.config.preemption
        wait_mode = mode is Preemption.WAIT or (
            mode is Preemption.EAGER and not eager_ok
        )
        pv = phase.value
        vorder = self._victim_order(phase, pos_of)
        self_id = js.spec.job_id
        for i in range(len(vorder) - 1, -1, -1):  # back-to-front
            if unmet <= 0:
                break
            vjid = vorder[i]
            if pos_of[vjid] <= pos:
                break  # ascending victim order: no later-ordered jobs left
            if vjid == self_id:
                continue
            bucket = self._run_by_job.get((vjid, pv))
            victims: list[TaskAttempt] | tuple = (
                list(bucket.values()) if bucket else ()
            )
            if victims and self.training.is_training(vjid, phase):
                # Prefer non-sample tasks: suspending a sample silently
                # cancels its runtime observation and stalls estimation.
                sample = set(self.training.sample_keys(vjid, phase))
                victims = sorted(
                    victims, key=lambda a: a.spec.key in sample
                )
            for att in victims:
                if unmet <= 0:
                    break
                key = att.spec.key
                if (
                    key in self._claimed
                    or att.state is not TaskState.RUNNING
                    or key in protected
                ):
                    continue
                if wait_mode:
                    self.stats.waits += 1
                    unmet -= 1  # we *would* preempt; count and move on
                    continue
                slot = self._slot_of.get(key)
                if slot is None:
                    continue
                self._claim(att)
                if mode is Preemption.EAGER:
                    actions.append(Suspend(att))
                    self.stats.suspensions += 1
                else:  # KILL
                    actions.append(Kill(att))
                    self.stats.kills += 1
                freed.append(slot)
                unmet -= 1
        return actions, freed

    def _resume_with_preemption(
        self,
        js: JobState,
        pos: int,
        phase: Phase,
        free: list[SlotKey],
        pos_of: dict[int, int],
        victim_memo: dict[int, list[tuple[int, TaskAttempt]]],
        victim_dead: set[int],
        eager_ok: bool,
        protected,
    ) -> tuple[list[Action], list[SlotKey]]:
        """Resume suspended tasks *on the machine that holds their state*
        (Sect. 3.3 "Impact on data locality"): free slot if available, else
        suspend a later-ordered job's task on that machine, else wait.

        Free slots are bucketed by machine once (O(free)) instead of being
        linearly scanned per suspended task; victims come from the
        incremental per-(machine, phase) run index, position-sorted at most
        once per machine per pass (``victim_memo``; the indexes are static
        during a pass, so the memo mirrors the old pass-wide snapshot)."""
        actions: list[Action] = []
        if not js.n_suspended(phase):
            return actions, free
        if not free and not eager_ok:
            return actions, free  # no slots and no preemption: nothing can move
        if not free and not self._pool_ok(phase, protected):
            # No slots and nothing unprotected left running: both the
            # free-slot and the victim path fail for every suspended task.
            return actions, free
        pv = phase.value
        # Potential-victim machines: machines hosting a running task of a
        # later-ordered job (only those can yield a slot via preemption).
        # Bounded collection: if later-running tasks outnumber this job's
        # suspended tasks, scanning the suspended tasks directly is
        # cheaper — fall back to the full scan (victim_machines=None).
        victim_machines: set[int] | None = set()
        if eager_ok:
            slot_of = self._slot_of
            n_later = 0
            budget = js.n_suspended(phase)
            # Walk the pass-cached victim order (running jobs ascending
            # by position) from the back: the later-ordered victims are
            # exactly its suffix, so the scan is O(min(later victims,
            # budget)) instead of O(running jobs) — same resulting set
            # (or the same None bail once later-running tasks outnumber
            # the suspended budget), since membership does not depend on
            # iteration order.
            vorder = self._victim_order(phase, pos_of)
            for i in range(len(vorder) - 1, -1, -1):
                vjid = vorder[i]
                if pos_of[vjid] <= pos:
                    break  # ascending order: no later-ordered jobs left
                bucket = self._run_by_job.get((vjid, pv))
                if not bucket:
                    continue
                n_later += len(bucket)
                if n_later > budget:
                    victim_machines = None
                    break
                for k in bucket:
                    victim_machines.add(slot_of[k].machine)
        if not free and victim_machines is not None and not victim_machines:
            # No free slot anywhere and no later-ordered job is running:
            # every suspended task would fail both the free-slot and the
            # victim path — provably a no-op, skip the O(suspended) scan
            # (the common steady state while a preempted job waits).
            return actions, free
        free_by_machine: dict[int, list[SlotKey]] = {}
        for s in free:
            free_by_machine.setdefault(s.machine, []).append(s)
        used: set[SlotKey] = set()
        claimed = self._claimed
        sbm = js.suspended_by_machine(phase)
        if victim_machines is None:
            # Full scan in suspension order (original path).
            candidates = js.suspended(phase)
        else:
            # Only machines that can actually act: a free slot to resume
            # into, or a later-ordered victim to displace.  A machine in
            # neither set is a provable no-op for every suspended task on
            # it (its victim walk would break on vpos <= pos immediately).
            candidates = []
            for m, bucket in sbm.items():
                if m in free_by_machine or m in victim_machines:
                    candidates.extend(bucket.values())
            candidates.sort(key=lambda a: a.susp_seq)
        for att in candidates:
            if att.spec.key in claimed:
                continue
            m = att.machine if att.machine is not None else -1
            slots = free_by_machine.get(m)
            if slots:
                slot = slots.pop(0)
                used.add(slot)
                self._claim(att)
                actions.append(Resume(att, slot))
                self.stats.resumes += 1
                continue
            if not eager_ok or m in victim_dead:
                continue
            # Largest-position (latest-finishing) victim on this machine.
            entries = victim_memo.get(m)
            if entries is None:
                entries = []
                bucket = self._run_by_machine.get((m, pv))
                if bucket:
                    for victim in bucket.values():
                        vp = pos_of.get(victim.spec.job_id)
                        if vp is not None:
                            entries.append((vp, victim))
                    entries.sort(key=lambda t: t[0])
                victim_memo[m] = entries
            found = False
            for vpos, victim in reversed(entries):
                if vpos <= pos:
                    break  # all remaining victims are earlier-ordered: wait
                vkey = victim.spec.key
                if (
                    vkey in claimed
                    or victim.state is not TaskState.RUNNING
                    or vkey in protected
                ):
                    continue
                vslot = self._slot_of.get(vkey)
                if vslot is None:
                    continue
                self._claim(victim)
                actions.append(Suspend(victim))
                self.stats.suspensions += 1
                self._claim(att)
                actions.append(Resume(att, vslot))
                self.stats.resumes += 1
                found = True
                break
            if not found:
                victim_dead.add(m)
        if used:
            free = [s for s in free if s not in used]
        return actions, free
