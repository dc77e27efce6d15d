"""Multi-tenant admission control: per-user queues, token-bucket rate
limits, max-live-jobs backpressure.

Admission decides *when* a submission reaches the engine, never *what*
the engine does with it — decisions are therefore allowed to depend on
wall-clock state (token buckets) without hurting the twin property:
only the admitted arrival, with its journaled arrival time, exists as
far as replay is concerned.

Flow for one submission:

1. token bucket for the user (``rate_limit`` jobs/s, burst ``burst``)
   — empty bucket rejects immediately (``reject-rate``: the client
   should back off, queueing would defeat the limit);
2. live-jobs backpressure — at or above ``max_live_jobs`` the job is
   queued per-user (FIFO) instead of admitted; a full queue rejects
   (``reject-queue``);
3. otherwise ``admit``.

Queued work drains round-robin across users (one job per user per
cycle — a burst from one tenant cannot starve the others) whenever
capacity frees up; the master calls :meth:`AdmissionControl.drain`
from its pacer and on every completion.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class AdmissionConfig:
    #: Backpressure threshold: submissions queue once this many jobs are
    #: live (submitted, not yet complete) in the engine.
    max_live_jobs: int = 64
    #: Per-user sustained admission rate in jobs/sec (None = unlimited).
    rate_limit: float | None = None
    #: Token-bucket depth: how many jobs a user may burst above the rate.
    burst: int = 8
    #: Per-user queue depth; submissions beyond it are rejected.
    max_queue_per_user: int = 256


@dataclass
class _Bucket:
    tokens: float
    stamp: float


@dataclass
class AdmissionControl:
    cfg: AdmissionConfig = field(default_factory=AdmissionConfig)

    def __post_init__(self):
        self._buckets: dict[str, _Bucket] = {}
        self._queues: dict[str, deque] = {}
        # Round-robin pointer: users in first-queued order; drain
        # rotates through them one job at a time.
        self._rr: deque[str] = deque()

    # -- token bucket ----------------------------------------------------
    def _take_token(self, user: str, wall_now: float) -> bool:
        rate = self.cfg.rate_limit
        if rate is None:
            return True
        b = self._buckets.get(user)
        if b is None:
            b = self._buckets[user] = _Bucket(float(self.cfg.burst), wall_now)
        b.tokens = min(
            float(self.cfg.burst), b.tokens + (wall_now - b.stamp) * rate
        )
        b.stamp = wall_now
        if b.tokens < 1.0:
            return False
        b.tokens -= 1.0
        return True

    # -- admission -------------------------------------------------------
    def offer(self, user: str, item, wall_now: float, live_jobs: int) -> str:
        """One submission; returns ``"admit"`` | ``"queued"`` |
        ``"reject-rate"`` | ``"reject-queue"``.  On ``"queued"`` the
        item is held until :meth:`drain` releases it."""
        if not self._take_token(user, wall_now):
            return "reject-rate"
        if live_jobs >= self.cfg.max_live_jobs:
            q = self._queues.get(user)
            if q is None:
                q = self._queues[user] = deque()
            if len(q) >= self.cfg.max_queue_per_user:
                return "reject-queue"
            if user not in self._rr:
                self._rr.append(user)
            q.append(item)
            return "queued"
        return "admit"

    def drain(self, live_jobs: int) -> list[tuple[str, object]]:
        """Release queued submissions round-robin across users up to the
        live-jobs ceiling; returns ``[(user, item), ...]`` in admission
        order."""
        out: list[tuple[str, object]] = []
        budget = self.cfg.max_live_jobs - live_jobs
        while budget > 0 and self._rr:
            user = self._rr[0]
            q = self._queues.get(user)
            if not q:
                self._rr.popleft()
                continue
            out.append((user, q.popleft()))
            budget -= 1
            self._rr.rotate(-1)
            if not q:
                # Drop the now-empty user from rotation (it re-enters
                # on its next queued submission).
                self._rr.remove(user)
        return out

    # -- restore ---------------------------------------------------------
    def queued_items(self) -> dict[str, list]:
        """Snapshot of queued submissions (checkpointed by the master —
        queued jobs are the only state not yet in the journal)."""
        return {u: list(q) for u, q in self._queues.items() if q}

    def requeue(self, queued: dict[str, list]) -> None:
        for user, items in queued.items():
            q = self._queues.setdefault(user, deque())
            q.extend(items)
            if q and user not in self._rr:
                self._rr.append(user)

    def queued_count(self) -> int:
        return sum(len(q) for q in self._queues.values())
