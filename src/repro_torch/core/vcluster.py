"""The virtual cluster (Sect. 3.1).

HFSP ranks jobs by the time at which they *would* finish if the cluster were
running a max-min-fair processor-sharing (PS) discipline.  The virtual
cluster simulates exactly that: it mirrors the real cluster's slot counts,
allocates virtual slots to jobs with max-min fairness (round-robin, starting
from the smallest jobs), and *ages* jobs between scheduler events by
subtracting `dt x allocated_slots` from their serialized remaining work.

Job size is serialized (sum of task runtimes on one slot), so aging is
independent of the real cluster's state — the paper's trick for tolerating
failures and elastic width (DESIGN.md §2, §7).

One VirtualCluster instance exists per phase (MAP and REDUCE are scheduled
independently, Sect. 3.1).

Performance notes (the scheduler runs on every executor event):

* the discrete max-min allocation depends only on (caps, weights, slots) —
  NOT on remaining work — so it is recomputed lazily, only after
  membership/cap changes;
* the projected-finish ORDER is invariant under aging (in continuous PS all
  jobs age exactly at their allocated rate, so absolute projected finish
  times are constant between structural events); the order is therefore
  cached and recomputed only on job add/remove and size re-estimates.
  Cap changes (task completions) can only *accelerate* the affected job's
  PS finish; we accept the momentarily stale order until the next
  structural event, which in practice arrives within one heartbeat;
* **aging is lazy**: ``age(dt)`` appends ``dt`` to a pending queue in O(1)
  and per-job ``remaining``/``done`` are materialized only when a query or
  a structural change (add/remove/re-estimate) needs them.  On the steady-
  state event path — where the schedule-order cache is hot and no
  estimates change — an event therefore costs O(1) instead of O(jobs).
  Materialization *replays* the deferred increments one event-dt at a
  time under the allocation in force at that point (re-checking effective
  caps after every step, exactly like the old eager loop), so the
  resulting floating-point state is bit-identical to eager aging.

Numeric backends: the water-fill and finish-time-projection kernels exist
in two interchangeable implementations — the numpy reference in this
module and the padded fixed-shape torch version in
:mod:`repro_torch.core.vcluster_torch` (the water-fill kernel K1 and the
projection kernel on a CUDA device, their plain versions on the CPU),
selected per instance via ``VirtualCluster(backend="numpy"|"torch",
device=...)`` or globally via the ``REPRO_VC_BACKEND`` environment
variable.  ``tests/test_torch_sim.py`` holds the two to bit-identical
schedules.

A copy of ``repro.core.vcluster`` with the ``"jax"`` backend replaced by
``"torch"``.  Unlike the reference, a cluster resolves its device when it
is built: a ``"torch"`` or ``"auto"`` cluster on ``"cuda"`` in a process
without CUDA raises at once instead of staying on numpy.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.types import Phase

#: Recognized numeric kernel backends for water-fill / projection.
#: "numpy" is the scalar reference; "torch" is the padded fixed-shape
#: implementation in :mod:`repro_torch.core.vcluster_torch`.
BACKENDS = ("numpy", "torch")

#: Selectable backend choices: the kernel backends plus "auto", which
#: starts both kernels on numpy and latches each one to torch on its own,
#: once the live-job count reaches that kernel's threshold (below it, a
#: device round trip per call costs more than the numpy loop).  The switch
#: is behavior-neutral: the backends are held to bit-identical schedules
#: (tests/test_torch_sim.py).
BACKEND_CHOICES = BACKENDS + ("auto",)

#: Environment override for the default backend.
BACKEND_ENV = "REPRO_VC_BACKEND"

#: Live jobs (per phase) at which an "auto" cluster on a CUDA device moves
#: its projection to the card: the least count from which one wrapped
#: call (numpy in, the projection kernel, numpy out) beat numpy's loop at
#: every count measured, in chip_smoke.py's phase
#: ``vcluster_wrapped_calls`` on an H100 80GB HBM3, 700.00 W: 334 us
#: against 248 us at 8 jobs, 385 against 604 at 16, 4.1 ms against 42 ms
#: at 1024 and 69 ms against 2.0 s at 8192.  End to end the gain is not
#: shown yet: on paper-cluster-size's 10-machine hfsp cell (up to 37 live
#: jobs a phase, 312 projections on the card, ~3 s a run) the "auto" over
#: numpy wall was 0.947, 1.032 and 1.033 in three calls (phase
#: ``scenarios_cli``), inside the run-to-run spread of ~12%.
AUTO_PROJECT_THRESHOLD = 16

#: Live jobs at which an "auto" cluster on a CUDA device moves its
#: water-fill to K1; None: never.  In the same run numpy's loop won at
#: every count measured, 4 to 8192 jobs: the wrapped K1 call took 86-158
#: us (a host round trip around a few-us launch) against numpy's 11-100
#: us, 158 against 100 at 8192.
AUTO_FILL_THRESHOLD: int | None = None


def resolve_backend(backend: str | None = None) -> str:
    """Pick the backend: explicit arg > $REPRO_VC_BACKEND > auto.

    Returns one of :data:`BACKEND_CHOICES`; an unknown name raises."""
    b = backend or os.environ.get(BACKEND_ENV) or "auto"
    if b not in BACKEND_CHOICES:
        raise ValueError(
            f"unknown vcluster backend {b!r}; expected one of {BACKEND_CHOICES}"
        )
    return b


@dataclass
class _VJob:
    job_id: int
    remaining: float          # serialized seconds (estimated)
    cap: int                  # parallelism at arrival = task count
    weight: float = 1.0       # GPS weight (Sect. 5)
    size_rank: int = 0        # number of tasks at arrival; round-robin order
    done: float = 0.0         # virtual work already aged away (for estimate updates)
    task_time: float = 1.0    # estimated serialized seconds per task
    # Owning cluster (lazy aging): public queries materialize deferred
    # aging first so external readers never observe stale state.
    owner: "VirtualCluster | None" = field(default=None, repr=False, compare=False)

    def effective_cap(self) -> int:
        """Virtual parallelism: the number of *virtual* tasks still
        unfinished.  The virtual cluster is a pure PS simulation — its
        parallelism shrinks as virtual work depletes (the job's "tail"),
        NOT as real tasks complete.  Coupling it to real completions makes
        a focused job's projected PS finish time rise while it runs, which
        flips the schedule order and causes preemption thrash."""
        if self.owner is not None:
            self.owner._materialize()
        return self._ecap()

    def _ecap(self) -> int:
        """`effective_cap` without the lazy-aging flush (internal use,
        after the owner has already materialized)."""
        if math.isinf(self.remaining):
            return self.cap
        if self.task_time <= 0:
            return self.cap
        return max(1, min(self.cap, int(math.ceil(self.remaining / self.task_time - 1e-9))))


def max_min_allocation(
    demands: dict[int, tuple[float, float]], slots: float
) -> dict[int, float]:
    """Weighted max-min fair (water-filling) allocation.

    ``demands`` maps job_id -> (cap, weight).  Returns continuous slot
    shares summing to at most ``slots`` (less if total cap is smaller).
    """
    ids = list(demands)
    caps = np.array([demands[j][0] for j in ids], dtype=np.float64)
    ws = np.array([demands[j][1] for j in ids], dtype=np.float64)
    alloc = _water_fill(caps, ws, float(slots))
    return {j: float(a) for j, a in zip(ids, alloc)}


def _water_fill(caps: np.ndarray, ws: np.ndarray, slots: float) -> np.ndarray:
    """Vectorized weighted water-filling: fill proportionally to weight,
    clamp at cap, redistribute, repeat.  O(#cap-levels) rounds."""
    n = len(caps)
    alloc = np.zeros(n)
    active = caps > 0
    free = float(slots)
    while free > 1e-12 and active.any():
        total_w = ws[active].sum()
        if total_w <= 0:
            break
        share = np.zeros(n)
        share[active] = free * ws[active] / total_w
        headroom = caps - alloc
        capped = active & (share >= headroom - 1e-12)
        if not capped.any():
            alloc[active] += share[active]
            break
        grant = np.where(capped, headroom, 0.0)
        alloc += grant
        free -= float(grant.sum())
        active &= ~capped
    return alloc


def discrete_allocation(
    demands: dict[int, tuple[float, float]],
    slots: int,
    size_rank: dict[int, int],
    backend: str = "numpy",
    device: str = "cuda",
) -> dict[int, int]:
    """Integer max-min allocation via round-robin, small jobs first.

    "Max-min fairness is achieved using a round-robin mechanism that starts
    allocating virtual cluster resources to small jobs (in terms of their
    number of tasks)." (Sect. 3.1)

    Implemented as floor(water-fill) + leftover slots granted in cyclic
    small-job-first rounds among jobs with headroom.  The leftover pass is
    vectorized: whole rounds are granted with one clipped-minimum per
    round-batch, and the final partial round goes one slot each to the
    first eligible jobs in order — exactly the one-slot-at-a-time
    round-robin outcome, without the per-slot Python loop.
    """
    ids = sorted(demands, key=lambda j: (size_rank.get(j, 0), j))
    caps = np.array([demands[j][0] for j in ids], dtype=np.float64)
    ws = np.array([demands[j][1] for j in ids], dtype=np.float64)
    if backend == "torch":
        from repro_torch.core import vcluster_torch

        cont = vcluster_torch.water_fill(caps, ws, float(slots), device=device)
    else:
        cont = _water_fill(caps, ws, float(slots))
    base = np.minimum(np.floor(cont + 1e-9), caps).astype(np.int64)
    free = int(slots) - int(base.sum())
    headroom = (caps - base).astype(np.int64)
    while free > 0:
        elig = np.flatnonzero(headroom > 0)
        if elig.size == 0:
            break
        if free >= elig.size:
            # Grant as many whole rounds as currently fit; jobs capping
            # out release their share to the next while-iteration.
            cycles = free // elig.size
            grant = np.minimum(headroom[elig], cycles)
            base[elig] += grant
            headroom[elig] -= grant
            free -= int(grant.sum())
        else:
            # Final partial round: first `free` eligible jobs in
            # small-first order get one slot each.
            take = elig[:free]
            base[take] += 1
            headroom[take] -= 1
            free = 0
    return {j: int(b) for j, b in zip(ids, base)}


def project_finish_times(
    jobs: dict[int, tuple[float, float, float]], slots: float, now: float
) -> dict[int, float]:
    """Forward-simulate weighted max-min PS; return absolute finish times.

    ``jobs`` maps job_id -> (remaining_serialized, cap, weight).  Piecewise
    constant allocations: at each step the job with the minimal
    remaining/allocation finishes, its slots are redistributed, repeat.
    Jobs with infinite remaining (xi = inf initial estimates, Sect. 3.1.1)
    get finish time +inf and therefore sort last.
    """
    ids = list(jobs)
    rem = np.array([jobs[j][0] for j in ids], dtype=np.float64)
    caps = np.array([jobs[j][1] for j in ids], dtype=np.float64)
    ws = np.array([jobs[j][2] for j in ids], dtype=np.float64)
    fin = _project_array(rem, caps, ws, slots, now)
    return {j: float(f) for j, f in zip(ids, fin)}


def _project_array(
    rem: np.ndarray, caps: np.ndarray, ws: np.ndarray, slots: float, now: float
) -> np.ndarray:
    """Array-shaped core of :func:`project_finish_times` (shared with the
    numpy path of :meth:`VirtualCluster.projected_finish_batch`)."""
    rem = rem.copy()
    fin = np.full(len(rem), np.inf)
    live = (rem > 0) & (caps > 0)
    fin[~live] = now
    t = now
    while live.any():
        alloc = np.zeros(len(rem))
        alloc[live] = _water_fill(caps[live], ws[live], float(slots))
        with np.errstate(divide="ignore", invalid="ignore"):
            dt = np.where(live & (alloc > 0), rem / np.maximum(alloc, 1e-300), np.inf)
        dt_min = dt.min()
        if not np.isfinite(dt_min):
            break  # only infinite-size jobs left -> they never finish in PS
        t += float(dt_min)
        rem = np.where(live, np.maximum(rem - alloc * dt_min, 0.0), rem)
        done = live & (dt <= dt_min + 1e-12)
        fin[done] = t
        live &= ~done
    return fin


class VirtualCluster:
    """Mirror of the real cluster for one phase (Sect. 3.1)."""

    def __init__(
        self,
        phase: Phase,
        slots: int,
        backend: str | None = None,
        auto_threshold: int | None = None,
        device: str = "cuda",
    ):
        self.phase = phase
        self.slots = slots
        choice = resolve_backend(backend)
        #: Device of the torch kernels, resolved now for a "torch" or
        #: "auto" cluster (raises on "cuda" without CUDA); a "numpy"
        #: cluster never reads it.
        self.device = device if choice == "numpy" else resolve_device(device)
        #: Numeric backend of the water-fill and of the projection
        #: ("numpy" or "torch").  With choice "auto" both start as "numpy"
        #: and each latches to "torch" the first time the live-job count
        #: reaches its threshold in :attr:`_auto_at` (see
        #: _maybe_auto_upgrade) — latched, not hysteretic, so one crossing
        #: cannot thrash between backends.
        self.fill_backend = self.project_backend = \
            "numpy" if choice == "auto" else choice
        #: {kernel attribute: live jobs at which it latches} for the
        #: kernels still waiting under "auto".  ``auto_threshold`` sets one
        #: count for both; by default each kernel takes its own measured
        #: count on a CUDA device.  On the CPU the torch backend is the
        #: kernels' plain versions, op by op on the host, which never beat
        #: numpy's loops, so by default nothing latches there.
        self._auto_at: dict[str, int] = {}
        if choice == "auto":
            if auto_threshold is not None:
                at = {"fill_backend": auto_threshold,
                      "project_backend": auto_threshold}
            elif self.device.type == "cuda":
                at = {"fill_backend": AUTO_FILL_THRESHOLD,
                      "project_backend": AUTO_PROJECT_THRESHOLD}
            else:
                at = {}
            self._auto_at = {k: n for k, n in at.items() if n is not None}
        self._jobs: dict[int, _VJob] = {}
        self._alloc_cache: dict[int, int] | None = None
        # Allocated (vjob, slots) pairs with slots > 0 — the only jobs
        # aging touches; rebuilt together with the allocation.
        self._allocated_cache: list[tuple[_VJob, int]] | None = None
        self._order_cache: list[int] | None = None
        # {job_id: position in _order_cache}, derived lazily from the
        # order cache (same invalidation) — the demand-indexed scheduler
        # sorts only actionable jobs by position instead of walking the
        # whole order list every pass.
        self._pos_cache: dict[int, int] | None = None
        # Lazy aging: deferred per-event dt increments, replayed in order
        # by _materialize() (see module docstring).
        self._pending_dts: list[float] = []
        # -- virtually-done tracking (PSBS late-job aging) ------------------
        # Jobs whose virtual remaining hit 0 while still members ("late"
        # jobs: virtually finished, really unfinished).  Maintained by the
        # aging replay and the size setters; read by
        # ``virtually_done()``, which gates materialization on a
        # conservative horizon (min remaining/cap over live jobs = the
        # earliest any job could virtually finish) so steady-state reads
        # are O(1).  ``_pending_total`` mirrors sum(_pending_dts) in O(1).
        self._vdone: set[int] = set()
        self._pending_total = 0.0
        self._vdone_horizon: float | None = None

    @property
    def jobs(self) -> dict[int, _VJob]:
        """Live job table.  Materializes deferred aging so callers always
        see up-to-date ``remaining``/``done``."""
        self._materialize()
        return self._jobs

    # -- cache control --------------------------------------------------------
    def _invalidate_alloc(self) -> None:
        self._alloc_cache = None
        self._allocated_cache = None

    def _invalidate_order(self) -> None:
        self._order_cache = None
        self._pos_cache = None

    def set_slots(self, n: int) -> None:
        """Resize the virtual capacity (fault layer: machines leaving or
        rejoining the cluster).  Pending lazy aging is replayed first —
        it accrued under the old capacity."""
        if n == self.slots:
            return
        self._materialize()
        self.slots = n
        self._invalidate_alloc()
        self._invalidate_order()

    # -- membership ---------------------------------------------------------
    def add_job(
        self,
        job_id: int,
        est_size: float,
        num_tasks: int,
        weight: float = 1.0,
    ) -> None:
        self._materialize()  # pending aging belongs to the old membership
        tt = est_size / num_tasks if (num_tasks and math.isfinite(est_size)) else 1.0
        self._jobs[job_id] = _VJob(
            job_id=job_id,
            remaining=est_size,
            cap=num_tasks,
            weight=weight,
            size_rank=num_tasks,
            task_time=max(tt, 1e-9),
            owner=self,
        )
        self._sync_vdone(job_id)
        self._maybe_auto_upgrade()
        self._invalidate_alloc()
        self._invalidate_order()

    @property
    def backend(self) -> str:
        """"numpy" or "torch" when both kernels run there, else "mixed".
        The port reads :attr:`fill_backend` and :attr:`project_backend`;
        this stands in for the reference's ``VirtualCluster.backend``
        attribute, which its callers read."""
        if self.fill_backend == self.project_backend:
            return self.fill_backend
        return "mixed"

    def _maybe_auto_upgrade(self) -> None:
        """auto mode: latch a kernel numpy -> torch once live jobs reach
        its threshold.  Membership growth is the only path that can cross
        one, so this is checked on add_job only.  Behavior-neutral by the
        backend conformance contract (bit-identical schedules)."""
        for kernel, at in list(self._auto_at.items()):
            if len(self._jobs) >= at:
                setattr(self, kernel, "torch")
                del self._auto_at[kernel]

    def remove_job(self, job_id: int) -> None:
        self._materialize()
        if self._jobs.pop(job_id, None) is not None:
            self._vdone.discard(job_id)
            self._invalidate_alloc()
            self._invalidate_order()

    def __contains__(self, job_id: int) -> bool:
        return job_id in self._jobs

    # -- estimate updates (Training module, Sect. 3.2) ----------------------
    def set_remaining(self, job_id: int, remaining: float) -> None:
        if job_id in self._jobs:
            self._materialize()
            self._jobs[job_id].remaining = remaining
            self._sync_vdone(job_id)
            # The virtual parallelism (_ecap) is derived from `remaining`,
            # so a stale discrete allocation must not survive this update:
            # a lazily-timed rebuild would otherwise make the *timing* of
            # cache rebuilds observable in later aging (non-determinism
            # caught by test_schedule_order_deterministic_under_lazy_aging).
            self._invalidate_alloc()
            self._invalidate_order()

    def set_size(self, job_id: int, size: float) -> None:
        """Re-estimate total size: 'the job scheduler *updates* the remaining
        amount of work to be done for the job' (Sect. 3.1.1) — the virtual
        work already done is preserved."""
        if job_id in self._jobs:
            self._materialize()  # bring `done` up to date first
            v = self._jobs[job_id]
            v.remaining = max(0.0, size - v.done)
            self._sync_vdone(job_id)
            if v.cap and math.isfinite(size):
                v.task_time = max(size / v.cap, 1e-9)
            self._invalidate_alloc()
            self._invalidate_order()

    def set_cap(self, job_id: int, cap: int) -> None:
        if job_id in self._jobs and self._jobs[job_id].cap != cap:
            self._materialize()
            self._jobs[job_id].cap = cap
            self._invalidate_alloc()
            # Order kept: a cap drop only accelerates this job's PS finish
            # (see module docstring); next structural event refreshes it.

    def remaining(self, job_id: int) -> float:
        self._materialize()
        return self._jobs[job_id].remaining if job_id in self._jobs else 0.0

    def _sync_vdone(self, job_id: int) -> None:
        v = self._jobs[job_id]
        if not math.isinf(v.remaining) and v.remaining <= 0.0:
            self._vdone.add(job_id)
        else:
            self._vdone.discard(job_id)
        self._vdone_horizon = None

    def virtually_done(self) -> list[int]:
        """Job ids whose *virtual* remaining work is exhausted while they
        are still members (real tasks unfinished) — PSBS's "late" jobs
        (:class:`repro_torch.core.disciplines.PSBSLateAging`).

        Horizon-gated: queued lazy aging is only replayed when its
        cumulative dt could actually have finished a job (``min
        remaining/cap`` over live jobs — cap bounds any job's virtual
        service rate, so this is a conservative earliest-completion
        bound).  Steady-state calls with an unreachable horizon are O(1)
        and leave the lazy-aging queue untouched."""
        if self._pending_dts and (
            self._vdone_horizon is None
            or self._pending_total >= self._vdone_horizon - 1e-9
        ):
            self._materialize()
        if self._vdone_horizon is None:
            h = math.inf
            for v in self._jobs.values():
                if (
                    not math.isinf(v.remaining)
                    and v.remaining > 0.0
                    and v.cap > 0
                ):
                    d = v.remaining / v.cap
                    if d < h:
                        h = d
            self._vdone_horizon = h
        return sorted(self._vdone)

    # -- aging (Sect. 3.1, "Job aging") --------------------------------------
    def age(self, dt: float) -> None:
        """Distribute ``dt`` of progress to every allocated virtual task.

        O(1): the increment is queued and replayed by the next query or
        structural change."""
        if dt <= 0 or not self._jobs:
            return
        self._pending_dts.append(dt)
        self._pending_total += dt

    def _materialize(self) -> None:
        """Replay deferred aging increments, one event-dt at a time.

        Each step uses the allocation in force at that step and re-checks
        effective caps afterwards (a shrinking virtual tail redistributes
        slots), reproducing eager per-event aging bit for bit."""
        if not self._pending_dts:
            return
        pending, self._pending_dts = self._pending_dts, []
        self._pending_total = 0.0
        for dt in pending:
            self._age_step(dt)
        # Remaining work shrank: the virtual-completion horizon is stale
        # (recomputed lazily by the next virtually_done() query).
        self._vdone_horizon = None

    def _age_step(self, dt: float) -> None:
        cap_changed = False
        for vjob, a in self._allocated():
            before = vjob._ecap()
            vjob.done += a * dt
            if not math.isinf(vjob.remaining):
                vjob.remaining = max(0.0, vjob.remaining - a * dt)
                if vjob.remaining <= 0.0:
                    self._vdone.add(vjob.job_id)
            if vjob._ecap() != before:
                cap_changed = True
        if cap_changed:
            # A virtual tail shrank below its allocation: redistribute.
            self._invalidate_alloc()
        # Aging preserves the projected finish ORDER (continuous-PS
        # invariance): the order cache stays valid.

    # -- queries --------------------------------------------------------------
    def _allocated(self) -> list[tuple[_VJob, int]]:
        """(vjob, allocated-slots) pairs with a positive allocation —
        assumes deferred aging is already materialized (or mid-replay)."""
        if self._alloc_cache is None:
            demands = {
                j: (v._ecap(), v.weight) for j, v in self._jobs.items()
            }
            rank = {j: v.size_rank for j, v in self._jobs.items()}
            self._alloc_cache = discrete_allocation(
                demands, self.slots, rank, backend=self.fill_backend,
                device=self.device,
            )
            self._allocated_cache = [
                (self._jobs[j], a)
                for j, a in self._alloc_cache.items()
                if a > 0
            ]
        return self._allocated_cache

    def allocation(self) -> dict[int, int]:
        self._materialize()
        self._allocated()
        return self._alloc_cache

    def _state_arrays(self) -> tuple[list[int], np.ndarray, np.ndarray, np.ndarray]:
        """(ids, remaining, effective caps, weights) of the live jobs —
        assumes deferred aging is already materialized."""
        ids = list(self._jobs)
        rem = np.array([self._jobs[j].remaining for j in ids], dtype=np.float64)
        caps = np.array(
            [float(self._jobs[j]._ecap()) for j in ids], dtype=np.float64
        )
        ws = np.array([self._jobs[j].weight for j in ids], dtype=np.float64)
        return ids, rem, caps, ws

    def projected_finish(self, now: float) -> dict[int, float]:
        """Absolute PS finish time per job — HFSP's sort key (Sect. 3.1)."""
        self._materialize()
        if self.project_backend == "torch":
            from repro_torch.core import vcluster_torch

            ids, rem, caps, ws = self._state_arrays()
            fin = vcluster_torch.project_finish_times(
                rem, caps, ws, float(self.slots), float(now),
                device=self.device,
            )
            return {j: float(f) for j, f in zip(ids, fin)}
        return project_finish_times(
            {
                j: (v.remaining, v._ecap(), v.weight)
                for j, v in self._jobs.items()
            },
            self.slots,
            now,
        )

    def projected_finish_batch(
        self,
        scenarios: list[dict[int, float]],
        now: float,
        as_sizes: bool = False,
    ) -> list[dict[int, float]]:
        """What-if PS finish times for many hypothetical job sizes at once.

        Each scenario maps job_id -> a hypothetical override for that job
        (jobs not named keep their current state).  With the default
        ``as_sizes=False`` the override is the *remaining* serialized
        work, priced exactly as if ``set_remaining`` had been applied
        (virtual parallelism re-derived from the job's current task_time).
        With ``as_sizes=True`` the override is a hypothetical *total*
        phase size, priced exactly as if ``set_size`` had been applied:
        remaining becomes ``max(0, size - done)`` and the per-task time —
        hence the virtual tail — is re-derived from the new size.  On the
        torch backend all scenarios price in a single batched launch; the
        numpy backend loops, so both backends return identical values and
        this method is safe to use from policy code regardless of
        configuration.
        """
        self._materialize()
        ids, rem, caps, ws = self._state_arrays()
        if not scenarios:
            return []
        if not ids:
            return [{} for _ in scenarios]
        idx = {j: i for i, j in enumerate(ids)}
        b = len(scenarios)
        rem_b = np.tile(rem, (b, 1))
        caps_b = np.tile(caps, (b, 1))
        for s, overrides in enumerate(scenarios):
            for j, val in overrides.items():
                i = idx.get(j)
                if i is None:
                    continue
                v = self._jobs[j]
                if as_sizes:
                    r = max(0.0, val - v.done)
                    tt = (
                        max(val / v.cap, 1e-9)
                        if v.cap and math.isfinite(val)
                        else v.task_time
                    )
                else:
                    r = val
                    tt = v.task_time
                rem_b[s, i] = r
                caps_b[s, i] = float(self._whatif_ecap(v, r, tt))
        if self.project_backend == "torch":
            from repro_torch.core import vcluster_torch

            fin_b = vcluster_torch.project_finish_times_batch(
                rem_b, caps_b, np.tile(ws, (b, 1)), float(self.slots),
                float(now), device=self.device,
            )
        else:
            fin_b = np.stack(
                [
                    _project_array(rem_b[s], caps_b[s], ws, self.slots, now)
                    for s in range(b)
                ]
            )
        return [
            {j: float(f) for j, f in zip(ids, row)} for row in fin_b
        ]

    @staticmethod
    def _whatif_ecap(v: _VJob, remaining: float, task_time: float) -> int:
        """Effective cap a job WOULD have at a hypothetical remaining
        (and, for size-override scenarios, a re-derived task_time)."""
        if math.isinf(remaining) or task_time <= 0:
            return v.cap
        return max(
            1, min(v.cap, int(math.ceil(remaining / task_time - 1e-9)))
        )

    def _order_from_fin(self, fin: dict[int, float]) -> list[int]:
        return sorted(fin, key=lambda j: (fin[j], self._jobs[j].size_rank, j))

    def order_cache_cold(self) -> bool:
        """True when the next schedule_order() must run a projection."""
        return self._order_cache is None and bool(self._jobs)

    def warm_order_cache(self, fin: dict[int, float]) -> None:
        """Install a schedule order from an externally computed projection
        (the scheduler's batched cross-phase warm).  ``fin`` must be this
        cluster's own projected finish map at the current virtual time."""
        self._order_cache = self._order_from_fin(fin)
        self._pos_cache = None

    def schedule_order(self, now: float) -> list[int]:
        """Job ids sorted by projected finish time, ties by id (FIFO-ish).

        Served from cache without materializing deferred aging: aging
        preserves the projected-finish order, so a valid cache stays
        correct no matter how much un-replayed aging is queued."""
        if self._order_cache is None:
            self._order_cache = self._order_from_fin(self.projected_finish(now))
            self._pos_cache = None
        return self._order_cache

    def schedule_pos(self, now: float) -> dict[int, int]:
        """{job_id: position in schedule_order(now)} — cached together
        with the order, so steady-state passes pay O(1) for position
        lookups instead of rebuilding the map per pass."""
        if self._pos_cache is None:
            self._pos_cache = {
                j: i for i, j in enumerate(self.schedule_order(now))
            }
        return self._pos_cache
