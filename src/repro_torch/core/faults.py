"""Deterministic fault injection for the scheduling engine.

The simulator drives four fault kinds as first-class events, every one of
them drawn from a seeded :class:`FaultModel`:

* **machine crash / recover** — a machine goes down for an
  exponentially-distributed outage; every task running or suspended on it
  fails and re-enters the pending demand through the executor hooks;
* **single-task failure** — an attempt dies partway through its work
  (the failure point is itself a draw), modeling JVM / container deaths;
* **transient slowdown (straggler)** — an attempt runs at
  ``1/straggler_factor`` of nominal speed, triggering speculative
  re-execution with first-finisher-wins kill of the loser;
* **estimation-sample loss** — a completed sample task's duration
  observation is dropped before the TrainingModule sees it, so the size
  estimate must be re-fit from the remaining samples (the
  lost-information regime of "Revisiting Size-Based Scheduling").

Determinism contract (see ``docs/faults.md``): every random decision uses
a *key-derived* RNG — ``np.random.default_rng((seed, stream, *key))`` —
never a shared sequential stream.  A decision's draw depends only on its
identity (machine id and outage ordinal; task key and attempt number),
not on the global order decisions happen to be made in.  That makes the
full failure trace bit-reproducible across reruns, across the
numpy/torch/auto vcluster backends, and across ``event_epsilon`` settings
(coalescing reorders *scheduling passes*, never the event mutations the
draws hang off).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.types import TaskAttempt

# RNG stream tags (the second element of every derivation key).  Distinct
# per decision family so streams never collide.
_STREAM_CRASH = 11     # (seed, 11, machine, ordinal) -> outage/uptime draws
_STREAM_FATE = 12      # (seed, 12, job, phase, index, attempt) -> fail/straggle
_STREAM_SAMPLE = 13    # (seed, 13, job, phase, index, attempt) -> sample loss

_PHASE_IDX = {"map": 0, "reduce": 1}


@dataclass(frozen=True)
class FaultModel:
    """Seeded description of the fault regime.  All rates default to 0:
    a default-constructed model is inert (``enabled`` is False) and the
    simulator skips the fault layer entirely."""

    seed: int = 0
    # Machine churn: mean time between failures / to recovery, per
    # machine, in sim-seconds.  mtbf <= 0 disables crashes.
    machine_mtbf: float = 0.0
    machine_mttr: float = 60.0
    # Probability that any given task attempt dies partway through.
    task_fail_rate: float = 0.0
    # Injected-failure retry budget per task.  Crash-induced failures do
    # NOT consume the budget (the task did nothing wrong), so liveness is
    # guaranteed: every task is eventually retried to completion.
    max_task_retries: int = 5
    # Capped exponential re-admission backoff after a failure (seconds).
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    # Probability an attempt straggles, and how slow it then runs
    # (execution rate = 1 / straggler_factor).
    straggler_prob: float = 0.0
    straggler_factor: float = 3.0
    # Probability a completed sample task's duration observation is lost
    # before the TrainingModule records it.
    sample_loss_rate: float = 0.0
    # Blacklisting: a machine accumulating this many injected task
    # failures without an intervening success is taken out of the free
    # pool for ``probation`` seconds (strikes carry over: one more
    # failure right after probation re-blacklists it).
    blacklist_threshold: int = 3
    probation_s: float = 120.0
    # Speculative re-execution of straggling attempts (first finisher
    # wins; the loser is killed and its work counted as lost).
    speculation: bool = True
    # A speculative copy is only worth launching if the straggler still
    # has at least this much nominal work left (seconds).
    speculation_min_remaining: float = 1.0
    # Externally-driven faults: keep the injector armed even with every
    # stochastic rate at zero, so scripted crash/recover events
    # (Simulator.inject_fault — the live service maps worker death and
    # rejoin onto these) route through the same failure/readmission
    # machinery.  No events are *drawn*: an external-only model seeds no
    # outages and injects no task failures.
    external: bool = False

    @property
    def enabled(self) -> bool:
        return (
            self.machine_mtbf > 0.0
            or self.task_fail_rate > 0.0
            or self.straggler_prob > 0.0
            or self.sample_loss_rate > 0.0
            or self.external
        )


class FaultInjector:
    """Draws fault decisions from a :class:`FaultModel` and keeps the
    deterministic failure trace plus blacklist strike counts.

    The injector is pure bookkeeping — the simulator owns all mutation
    (failing tasks, taking machines down, scheduling re-admissions)."""

    def __init__(self, model: FaultModel, num_machines: int):
        self.model = model
        self.num_machines = num_machines
        self._strikes: dict[int, int] = {}
        # Per-machine ordinal of the next crash-stream draw.
        self._crash_draws: dict[int, int] = {}
        # Deterministic event trace: (time, kind, detail) tuples in
        # injection order.  Compared verbatim by the conformance goldens.
        self.trace: list[tuple] = []
        self.stats = {
            "machine_crashes": 0,
            "machine_recoveries": 0,
            "task_failures": 0,
            "crash_task_failures": 0,
            "stragglers": 0,
            "sample_losses": 0,
            "retries": 0,
            "retries_exhausted": 0,
            "blacklists": 0,
            "probations_ended": 0,
            "speculative_launches": 0,
            "speculative_wins": 0,
            "speculative_losses": 0,
            "work_lost_s": 0.0,
        }

    # -- key-derived draws ---------------------------------------------------
    def _rng(self, stream: int, *key: int) -> np.random.Generator:
        return np.random.default_rng((self.model.seed, stream, *key))

    def next_outage_delay(self, machine: int) -> float:
        """Uptime until this machine's next crash (exponential, mean
        mtbf).  Ordinal-keyed: the k-th draw for machine m is the same
        regardless of what any other machine did."""
        k = self._crash_draws.get(machine, 0)
        self._crash_draws[machine] = k + 1
        rng = self._rng(_STREAM_CRASH, machine, k)
        return float(rng.exponential(self.model.machine_mtbf))

    def next_recover_delay(self, machine: int) -> float:
        k = self._crash_draws.get(machine, 0)
        self._crash_draws[machine] = k + 1
        rng = self._rng(_STREAM_CRASH, machine, k)
        return float(rng.exponential(self.model.machine_mttr))

    def attempt_fate(self, att: TaskAttempt) -> tuple[float | None, float]:
        """Fate of one (re)started attempt: ``(fail_fraction, rate)``.

        ``fail_fraction`` is the fraction of the attempt's remaining work
        at which it dies (None = survives); ``rate`` is the execution
        speed (1.0 nominal, ``1/straggler_factor`` if straggling).  All
        three underlying uniforms are drawn unconditionally so a fate is
        a pure function of (task identity, attempt ordinal)."""
        s = att.spec
        rng = self._rng(
            _STREAM_FATE, s.job_id, _PHASE_IDX[s.phase.value], s.index,
            att.attempts,
        )
        u_fail = float(rng.random())
        frac = float(rng.random())
        u_strag = float(rng.random())
        m = self.model
        fail_at = None
        if m.task_fail_rate > 0.0 and u_fail < m.task_fail_rate:
            # Die somewhere strictly inside the attempt.
            fail_at = min(max(frac, 1e-6), 1.0 - 1e-6)
        rate = 1.0
        if m.straggler_prob > 0.0 and u_strag < m.straggler_prob:
            rate = 1.0 / max(1.0, m.straggler_factor)
        return fail_at, rate

    def sample_lost(self, att: TaskAttempt) -> bool:
        """Whether this completed attempt's size-sample observation is
        dropped before reaching the TrainingModule."""
        m = self.model
        if m.sample_loss_rate <= 0.0:
            return False
        s = att.spec
        rng = self._rng(
            _STREAM_SAMPLE, s.job_id, _PHASE_IDX[s.phase.value], s.index,
            att.attempts,
        )
        return bool(rng.random() < m.sample_loss_rate)

    # -- retry / backoff -----------------------------------------------------
    def backoff(self, failures: int) -> float:
        """Re-admission delay after the task's ``failures``-th failure:
        capped exponential, ``min(base * 2^(failures-1), cap)``."""
        m = self.model
        return min(m.backoff_base * (2.0 ** max(0, failures - 1)), m.backoff_cap)

    # -- blacklist strikes ---------------------------------------------------
    def note_injected_failure(self, machine: int) -> bool:
        """Record an injected task failure on ``machine``; True when the
        strike count just reached the blacklist threshold."""
        n = self._strikes.get(machine, 0) + 1
        self._strikes[machine] = n
        return n == self.model.blacklist_threshold

    def note_success(self, machine: int) -> None:
        """A task completed cleanly on ``machine``: reset its strikes."""
        if self._strikes.get(machine):
            self._strikes[machine] = 0

    def end_probation(self, machine: int) -> None:
        """Probation served: the machine rejoins the pool one strike shy
        of the threshold — a single further failure re-blacklists it."""
        self._strikes[machine] = self.model.blacklist_threshold - 1

    # -- trace / reporting ---------------------------------------------------
    def record(self, time: float, kind: str, *detail) -> None:
        self.trace.append((round(time, 9), kind, *detail))

    def stats_dict(self) -> dict:
        out = dict(self.stats)
        out["trace_len"] = len(self.trace)
        return out


class FirstFinisherWins:
    """Tiny arbiter for racing redundant executions of the same work.

    Contenders call :meth:`finish` when done; the first caller for a key
    wins (True), every later caller is the loser (False) and should
    discard its work.  Shared by the simulator's speculative task
    re-execution, the gang runtime's spare-gang speculation, and the
    sweep runner's straggler re-issue."""

    def __init__(self):
        self._winner: dict = {}

    def finish(self, key, contender) -> bool:
        if key in self._winner:
            return False
        self._winner[key] = contender
        return True

    def winner(self, key):
        return self._winner.get(key)

    def decided(self, key) -> bool:
        return key in self._winner

    def reset(self, key) -> None:
        self._winner.pop(key, None)
