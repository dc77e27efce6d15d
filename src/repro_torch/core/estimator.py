"""Job size estimation — the Training module (Sect. 3.2).

Size-based scheduling needs job sizes, which are unknown a priori.  HFSP
estimates them online:

* the *initial estimate* of a phase is ``num_tasks x mean-recent-task-time
  x xi`` where xi in [1, inf) is the confidence parameter (Sect. 3.1.1);
* a *sample set* of ``s`` tasks (s=5 in the paper) is executed under a fair
  share granted by the top-level scheduler; their measured runtimes are fed
  to a *pluggable estimator* that fits a task-time CDF by least-squares
  regression against a reference distribution family (Sect. 3.2.1);
* REDUCE tasks can be orders of magnitude longer than MAP tasks, so their
  runtime is estimated *before completion* as ``sigma = Delta / p`` where
  ``p`` is the fraction of input processed after ``Delta`` seconds of
  execution (Delta = 60 s in the paper) — p embeds input-size skew.

Estimators return a full per-task duration *vector* (the paper's
``M_i = [sigma(m_1), sigma(m_2), ...]``); the phase size estimate is its sum.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Protocol

import numpy as np

from repro_torch.core.types import JobState, Phase, TaskState


# ---------------------------------------------------------------------------
# Pluggable task-time distribution estimators (Sect. 3.2.1)
# ---------------------------------------------------------------------------
class TaskTimeEstimator(Protocol):
    """Fit a task-time distribution from sample runtimes and extrapolate."""

    def fit_vector(self, samples: list[float], num_tasks: int) -> list[float]:
        """Return estimated durations for all ``num_tasks`` tasks."""
        ...


class FirstOrderEstimator:
    """Mean-based estimator (what the paper's experiments use: 'first order
    statistic estimators that assume uniformly distributed task sizes')."""

    def fit_vector(self, samples: list[float], num_tasks: int) -> list[float]:
        if not samples:
            return [math.inf] * num_tasks
        mu = float(np.mean(samples))
        return [mu] * num_tasks


@dataclass
class DistributionFitEstimator:
    """Least-squares CDF regression against a reference family (Sect. 3.2.1).

    ``family`` picks the reference task-time distribution; parameters are
    fit by minimizing squared error between the model CDF and the empirical
    CDF of the samples.  The estimated CDF is then inverted at the
    mid-quantiles ``(k + 0.5)/n`` to produce the per-task duration vector.
    """

    family: str = "lognormal"  # uniform | exponential | lognormal | weibull

    def fit_vector(self, samples: list[float], num_tasks: int) -> list[float]:
        if not samples:
            return [math.inf] * num_tasks
        xs = np.sort(np.asarray(samples, dtype=np.float64))
        xs = np.maximum(xs, 1e-9)
        n = len(xs)
        # Empirical CDF at the sample points (Hazen plotting positions).
        ecdf = (np.arange(1, n + 1) - 0.5) / n
        q = (np.arange(num_tasks) + 0.5) / num_tasks
        if self.family == "uniform" or n == 1:
            # U(a, b): LS fit degenerates to moment matching on order stats.
            a, b = self._fit_uniform(xs, ecdf)
            vec = a + q * (b - a)
        elif self.family == "exponential":
            # F(x) = 1 - exp(-x/mu): -log(1-F) = x/mu -> LS through origin.
            y = -np.log1p(-np.clip(ecdf, 0, 1 - 1e-9))
            mu = float(np.dot(xs, y) / max(np.dot(y, y), 1e-30))
            vec = -mu * np.log1p(-np.clip(q, 0, 1 - 1e-12))
        elif self.family == "weibull":
            # log(-log(1-F)) = k log x - k log lam -> linear LS.
            y = np.log(-np.log1p(-np.clip(ecdf, 0, 1 - 1e-9)))
            k, c = np.polyfit(np.log(xs), y, 1)
            k = max(float(k), 1e-3)
            lam = math.exp(-float(c) / k)
            vec = lam * (-np.log1p(-np.clip(q, 0, 1 - 1e-12))) ** (1.0 / k)
        else:  # lognormal: Phi^-1(F) = (log x - m)/s -> linear LS.
            y = _norm_ppf(np.clip(ecdf, 1e-9, 1 - 1e-9))
            s, m = np.polyfit(y, np.log(xs), 1)
            vec = np.exp(m + s * _norm_ppf(np.clip(q, 1e-12, 1 - 1e-12)))
        vec = np.maximum(np.asarray(vec, dtype=np.float64), 1e-9)
        return [float(v) for v in vec]

    @staticmethod
    def _fit_uniform(xs: np.ndarray, ecdf: np.ndarray) -> tuple[float, float]:
        # LS fit of F(x) = (x-a)/(b-a) over the samples.
        slope, intercept = np.polyfit(xs, ecdf, 1) if len(xs) > 1 else (0.0, 0.0)
        if slope <= 1e-12:
            lo = hi = float(np.mean(xs))
            return lo, hi
        a = -intercept / slope
        b = a + 1.0 / slope
        return min(a, float(xs[0])), max(b, float(xs[-1]))


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    """Acklam's rational approximation of the standard normal inverse CDF
    (numpy-only; scipy is not available in this environment)."""
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    p = np.asarray(p, dtype=np.float64)
    out = np.empty_like(p)
    plow, phigh = 0.02425, 1 - 0.02425
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    if np.any(lo):
        qq = np.sqrt(-2 * np.log(p[lo]))
        out[lo] = (((((c[0] * qq + c[1]) * qq + c[2]) * qq + c[3]) * qq + c[4]) * qq + c[5]) / (
            (((d[0] * qq + d[1]) * qq + d[2]) * qq + d[3]) * qq + 1
        )
    if np.any(hi):
        qq = np.sqrt(-2 * np.log(1 - p[hi]))
        out[hi] = -(((((c[0] * qq + c[1]) * qq + c[2]) * qq + c[3]) * qq + c[4]) * qq + c[5]) / (
            (((d[0] * qq + d[1]) * qq + d[2]) * qq + d[3]) * qq + 1
        )
    if np.any(mid):
        qq = p[mid] - 0.5
        r = qq * qq
        out[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * qq / (
            ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
        )
    return out


# ---------------------------------------------------------------------------
# Recent-task statistics (for the xi-weighted initial estimate, Sect. 3.1.1)
# ---------------------------------------------------------------------------
@dataclass
class RecentTaskStats:
    """Rolling mean of recently-completed task durations, per phase."""

    window: int = 50
    default: float = 30.0  # cold-start guess (seconds) before any completion
    _hist: dict[Phase, deque] = field(default_factory=dict)

    def observe(self, phase: Phase, duration: float) -> None:
        self._hist.setdefault(phase, deque(maxlen=self.window)).append(duration)

    def mean(self, phase: Phase) -> float:
        h = self._hist.get(phase)
        return float(np.mean(h)) if h else self.default


# ---------------------------------------------------------------------------
# The Training module (Sect. 3.2)
# ---------------------------------------------------------------------------
@dataclass
class _PhaseTraining:
    sample_keys: list[tuple] = field(default_factory=list)
    observed: dict[tuple, float] = field(default_factory=dict)
    done: bool = False


@dataclass
class TrainingModule:
    """Drives per-job size estimation; acts as a sub-scheduler fed slots by
    the top-level scheduler (Sect. 3.1.1).

    Parameters mirror the paper's Sect. 4.1 configuration: sample set size
    ``t`` = 5 for both phases, ``Delta`` = 60 s, confidence ``xi`` = 1.
    """

    sample_set_size: int = 5
    delta: float = 60.0
    xi: float = 1.0
    estimator: TaskTimeEstimator = field(default_factory=FirstOrderEstimator)
    recent: RecentTaskStats = field(default_factory=RecentTaskStats)
    _training: dict[tuple[int, Phase], _PhaseTraining] = field(default_factory=dict)
    # Insertion-ordered index of (job, phase) pairs still training — lets
    # the scheduler iterate only in-training jobs instead of probing every
    # live job each pass.  Entries leave when training finalizes.
    _active: dict[tuple[int, Phase], None] = field(default_factory=dict)
    # -- demand indexes (kept in lockstep with task-state events) -----------
    # Jobs with >=1 dispatchable sample task (PENDING and unobserved) —
    # exactly the jobs the training scheduler can act on this pass.
    _wanted: dict[Phase, dict[int, None]] = field(
        default_factory=lambda: {Phase.MAP: {}, Phase.REDUCE: {}}
    )
    # Per-job RUNNING sample keys (in sample-set order) for active jobs,
    # plus an O(1) total — feeds the training budget and the protected-key
    # quota without re-probing every active job's sample set each pass.
    _running: dict[Phase, dict[int, dict[tuple, None]]] = field(
        default_factory=lambda: {Phase.MAP: {}, Phase.REDUCE: {}}
    )
    _n_running: dict[Phase, int] = field(
        default_factory=lambda: {Phase.MAP: 0, Phase.REDUCE: 0}
    )

    # -- lifecycle -----------------------------------------------------------
    def start_phase(self, job: JobState, phase: Phase) -> float:
        """Begin training for a job phase; return the initial size estimate.

        Initial estimate = num_tasks x mean recent task duration x xi.
        xi = inf parks the job at the back of the queue until trained.
        """
        tasks = job.spec.tasks(phase)
        st = _PhaseTraining()
        st.sample_keys = [t.key for t in tasks[: self.sample_set_size]]
        if not tasks:
            st.done = True
        self._training[(job.spec.job_id, phase)] = st
        job.in_training[phase] = not st.done
        if not st.done:
            self._active[(job.spec.job_id, phase)] = None
            self.sync_job(job, phase)
        if not tasks:
            return 0.0
        if math.isinf(self.xi):
            return math.inf
        return len(tasks) * self.recent.mean(phase) * self.xi

    def is_training(self, job_id: int, phase: Phase) -> bool:
        return (job_id, phase) in self._active

    def active_jobs(self, phase: Phase) -> list[int]:
        """Job ids still training this phase, in training-start order."""
        return [j for (j, p) in self._active if p is phase]

    # -- demand-index queries (O(1) / O(result)) -----------------------------
    def wanted_jobs(self, phase: Phase) -> list[int]:
        """Training jobs with >=1 dispatchable sample task this phase —
        the only jobs the training scheduler can act on."""
        return list(self._wanted[phase])

    def n_running_samples(self, phase: Phase) -> int:
        """Total RUNNING sample tasks across active jobs (O(1))."""
        return self._n_running[phase]

    def running_sample_keys(self, job_id: int, phase: Phase) -> list[tuple]:
        """RUNNING sample keys of one active job, in sample-set order."""
        return list(self._running[phase].get(job_id, ()))

    def running_sample_jobs(self, phase: Phase) -> dict[int, dict[tuple, None]]:
        """{job_id: running-sample-key dict} for active jobs with >=1
        RUNNING sample (read-only view; the protected-key quota walks
        this instead of probing every active job)."""
        return self._running[phase]

    def check_indexes(self, phase: Phase, jobs: dict[int, "JobState"]) -> None:
        """Paranoid cross-check: rebuild the wanted/running-sample
        reference by probing every active job's sample states and assert
        the incremental indexes match (called from HFSP's paranoid pass
        alongside the scheduler-level demand-index check)."""
        ref_wanted: set[int] = set()
        ref_running: dict[int, list[tuple]] = {}
        for (jid, p), st in self._training.items():
            if p is not phase or st.done or (jid, p) not in self._active:
                continue
            job = jobs.get(jid)
            if job is None:
                continue
            for key in st.sample_keys:
                att = job.tasks[key]
                if att.state is TaskState.RUNNING:
                    ref_running.setdefault(jid, []).append(key)
                elif att.state is TaskState.PENDING and key not in st.observed:
                    ref_wanted.add(jid)
        assert set(self._wanted[phase]) == ref_wanted, (
            f"training wanted mismatch ({phase}): "
            f"{set(self._wanted[phase])} != {ref_wanted}"
        )
        got_running = {j: list(ks) for j, ks in self._running[phase].items()}
        assert got_running == ref_running, (
            f"training running-sample mismatch ({phase})"
        )
        assert self._n_running[phase] == sum(
            len(v) for v in ref_running.values()
        ), f"training running-sample count mismatch ({phase})"

    def sync_job(self, job: JobState, phase: Phase) -> None:
        """Recompute this job's demand-index entries from its (<= sample
        set size) sample-task states.  Called after every executor event
        that can change a sample task's state or observation status —
        O(sample set) per event, which keeps every per-pass training query
        O(actionable) instead of O(active jobs)."""
        jid = job.spec.job_id
        st = self._training.get((jid, phase))
        run_idx = self._running[phase]
        old = run_idx.get(jid)
        if st is None or st.done:
            self._wanted[phase].pop(jid, None)
            if old is not None:
                self._n_running[phase] -= len(old)
                del run_idx[jid]
            return
        wanted = False
        running: dict[tuple, None] = {}
        for key in st.sample_keys:
            att = job.tasks[key]
            if att.state is TaskState.RUNNING:
                running[key] = None
            elif att.state is TaskState.PENDING and key not in st.observed:
                wanted = True
        if wanted:
            self._wanted[phase][jid] = None
        else:
            self._wanted[phase].pop(jid, None)
        self._n_running[phase] += len(running) - (len(old) if old else 0)
        if running:
            run_idx[jid] = running
        elif old is not None:
            del run_idx[jid]

    def sample_keys(self, job_id: int, phase: Phase) -> list[tuple]:
        st = self._training.get((job_id, phase))
        return list(st.sample_keys) if st else []

    def n_observations(self, job_id: int, phase: Phase) -> int:
        """Sample observations recorded so far — the estimate's version
        number (rank-stability verdicts are cached per version)."""
        st = self._training.get((job_id, phase))
        return len(st.observed) if st else 0

    def wanted_sample_tasks(self, job: JobState, phase: Phase) -> list[tuple]:
        """Sample-set tasks not yet dispatched (the slots this module asks
        the top-level scheduler for)."""
        st = self._training.get((job.spec.job_id, phase))
        if st is None or st.done:
            return []
        out = []
        for key in st.sample_keys:
            att = job.tasks[key]
            if att.state is TaskState.PENDING and key not in st.observed:
                out.append(key)
        return out

    def candidate_sizes(self, job: JobState, phase: Phase) -> list[float]:
        """Hypothetical phase sizes consistent with the observations so far.

        While a job is still training, its size estimate is provisional —
        each new sample observation can move it.  This returns the full
        refit plus every leave-one-out refit of the current sample
        durations (<= sample_set_size + 1 candidates, deterministic), i.e.
        the spread of sizes the estimator could settle on.  Feed these to
        :meth:`VirtualCluster.projected_finish_batch` (via
        ``HFSPScheduler.rank_stability``) to price all what-if
        re-projections in one batched kernel call."""
        st = self._training.get((job.spec.job_id, phase))
        if st is None or not st.observed:
            return []
        obs = list(st.observed.values())
        n_tasks = len(job.spec.tasks(phase))
        sizes = [float(sum(self.estimator.fit_vector(obs, n_tasks)))]
        if len(obs) > 1:
            for i in range(len(obs)):
                sub = obs[:i] + obs[i + 1:]
                sizes.append(float(sum(self.estimator.fit_vector(sub, n_tasks))))
        return sizes

    def lose_sample(self, job: JobState, phase: Phase, key: tuple) -> None:
        """Fault layer: a completed sample task's duration observation was
        dropped in flight (repro_torch.core.faults).  Re-request coherently:
        swap the lost key for a replacement task that can still run (so a
        real observation eventually arrives); when no replacement exists
        the sample set shrinks and :meth:`_maybe_finalize`'s threshold
        shrinks with it.  No-op if the key was already observed (e.g. an
        earlier sigma = Delta/p progress estimate survives the loss)."""
        st = self._training.get((job.spec.job_id, phase))
        if st is None or st.done or key not in st.sample_keys:
            return
        if key in st.observed:
            return
        idx = st.sample_keys.index(key)
        in_set = set(st.sample_keys)
        replacement = None
        for t in job.spec.tasks(phase):
            if t.key in in_set:
                continue
            if job.tasks[t.key].state is not TaskState.DONE:
                replacement = t.key
                break
        if replacement is not None:
            st.sample_keys[idx] = replacement
        else:
            del st.sample_keys[idx]
            if not st.sample_keys and not st.observed:
                # Every observation lost and nothing left to sample:
                # training can never complete — close it out; the phase
                # keeps its initial xi-weighted estimate.
                st.done = True
                job.in_training[phase] = False
                self._active.pop((job.spec.job_id, phase), None)
        self.sync_job(job, phase)

    # -- observations ----------------------------------------------------------
    def observe_completion(self, job: JobState, phase: Phase, key: tuple,
                           duration: float) -> float | None:
        """Record a finished task; returns the new phase-size estimate when
        the sample set completes, else None."""
        self.recent.observe(phase, duration)
        st = self._training.get((job.spec.job_id, phase))
        if st is None or st.done:
            return None
        if key in st.sample_keys:
            st.observed[key] = duration
        out = self._maybe_finalize(job, phase, st)
        self.sync_job(job, phase)
        return out

    def observe_progress(self, job: JobState, phase: Phase, key: tuple,
                         progress_fraction: float, elapsed: float) -> float | None:
        """REDUCE-style early estimate: sigma = Delta / p (Sect. 3.2.1).

        Called by the executor once a sample REDUCE task has run for
        ``Delta`` seconds; ``progress_fraction`` is the fraction of its
        input processed so far.
        """
        st = self._training.get((job.spec.job_id, phase))
        if st is None or st.done or key not in st.sample_keys:
            return None
        if key in st.observed:
            return None
        p = max(progress_fraction, 1e-9)
        st.observed[key] = elapsed / p
        out = self._maybe_finalize(job, phase, st)
        self.sync_job(job, phase)
        return out

    def _maybe_finalize(self, job: JobState, phase: Phase,
                        st: _PhaseTraining) -> float | None:
        """Refit the phase-size estimate after EVERY observation.

        Waiting for the full sample set before producing any estimate is
        fragile: if sample tasks get suspended under load, the job would
        keep a stale (often badly low) initial estimate, sort first
        forever, and preempt the very jobs that should run before it.
        Partial-sample estimates are provisional; training completes (and
        stops consuming Training-module slots) at ``sample_set_size``
        observations as in the paper."""
        n_needed = min(self.sample_set_size, len(job.spec.tasks(phase)))
        # Sample loss without a replacement shrinks the achievable set
        # (every observed key is a sample key, so len(sample_keys) bounds
        # the observations that can ever arrive).  Zero-fault runs always
        # have len(sample_keys) == n_needed — the min is inert there.
        n_needed = min(n_needed, len(st.sample_keys))
        if not st.observed:
            return None
        if len(st.observed) >= n_needed:
            st.done = True
            job.in_training[phase] = False
            self._active.pop((job.spec.job_id, phase), None)
        vec = self.estimator.fit_vector(
            list(st.observed.values()), len(job.spec.tasks(phase))
        )
        return float(sum(vec))
