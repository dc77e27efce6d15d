"""Lease protocol for distributed sweep execution (a copy of
``repro.scenarios.lease``).

A *lease* is a store row saying "worker W is computing cell
``(cell_id, spec_hash)`` until epoch second ``expires``".  Workers claim
a pending cell before computing it, renew the lease on a heartbeat while
the attempt runs, and release it after storing the result.  A worker
that dies (SIGKILL, machine loss) simply stops renewing: once the TTL
passes, any other worker's ``claim`` takes the cell over — that takeover
is a **reissue** and is counted in the store's stats so chaos tests can
assert that dead workers' cells were observably reclaimed.

Leases are an *optimization*, never a correctness mechanism: the
``(cell_id, spec_hash)`` exactly-once contract lives in the result
append (first finisher wins; duplicate appends are detected, dropped,
and counted).  A worker that loses its lease mid-compute may keep going
— the worst case is a duplicate result that the store drops.

Clocks are wall-clock epoch seconds (``time.time()``): leases must be
comparable across machines sharing a store.  TTLs should therefore be
generous relative to expected clock skew (seconds, not milliseconds).

The JSONL backend persists lease traffic as an append-only event log
(``<store>.leases``); :class:`LeaseState` folds that log into current
leases / worker beats / counters.  The fold is deterministic from the
log alone: whether a claim was a reissue is decided by the *claiming*
writer under the store lock and recorded in the claim row, so readers
never need to re-judge expiry with their own clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

#: Default lease TTL in seconds.  Three missed renewals (renew_every
#: defaults to ttl/3) before a cell is up for reclaim.
DEFAULT_TTL = 30.0

#: Counter names every backend's ``stats()`` reports (always all
#: present, zero-initialized).
COUNTERS = ("claims", "reissues", "renews", "releases", "duplicates")


def _now(now: float | None) -> float:
    return time.time() if now is None else now


@dataclass(frozen=True)
class Lease:
    """One held (or expired-but-unreclaimed) cell lease."""

    cell_id: str
    spec_hash: str
    worker: str
    expires: float  # epoch seconds

    def expired(self, now: float | None = None) -> bool:
        return _now(now) >= self.expires

    def remaining(self, now: float | None = None) -> float:
        return self.expires - _now(now)


@dataclass
class LeaseState:
    """Folded view of a lease event log.

    ``leases``: {(cell_id, spec_hash): Lease} still on the books
    (claimed or renewed, not yet released; may be expired).
    ``workers``: {worker: {"last_seen": epoch_s, "info": dict}}.
    ``counters``: see :data:`COUNTERS`.
    """

    leases: dict[tuple[str, str], Lease] = field(default_factory=dict)
    workers: dict[str, dict] = field(default_factory=dict)
    counters: dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in COUNTERS}
    )

    def _beat(self, worker: str, t: float, info: dict | None = None) -> None:
        rec = self.workers.setdefault(worker, {"last_seen": t, "info": {}})
        rec["last_seen"] = max(rec["last_seen"], t)
        if info:
            rec["info"].update(info)

    def apply(self, rec: dict) -> None:
        """Fold one event-log record (unknown ops are ignored so future
        log schema additions stay readable by old coordinators)."""
        op = rec.get("op")
        worker = rec.get("worker", "")
        t = float(rec.get("t", 0.0))
        key = (rec.get("cell_id", ""), rec.get("spec_hash", ""))
        if op == "claim":
            self.leases[key] = Lease(key[0], key[1], worker, float(rec["expires"]))
            self.counters["claims"] += 1
            if rec.get("reissue"):
                self.counters["reissues"] += 1
            self._beat(worker, t)
        elif op == "renew":
            cur = self.leases.get(key)
            if cur is not None and cur.worker == worker:
                self.leases[key] = Lease(key[0], key[1], worker, float(rec["expires"]))
            self.counters["renews"] += 1
            self._beat(worker, t)
        elif op == "release":
            cur = self.leases.get(key)
            if cur is not None and cur.worker == worker:
                del self.leases[key]
            self.counters["releases"] += 1
            self._beat(worker, t)
        elif op == "dup":
            self.counters["duplicates"] += 1
            self._beat(worker, t)
        elif op == "beat":
            self._beat(worker, t, rec.get("info"))


def fold_lease_log(records) -> LeaseState:
    """Fold an iterable of event-log dicts into a :class:`LeaseState`."""
    state = LeaseState()
    for rec in records:
        state.apply(rec)
    return state


class LeaseKeeper:
    """Renews one held lease while its cell computes.

    The worker calls :meth:`tick` from its supervision loop (it polls
    the attempt pipe a few times a second); renewal actually happens
    only every ``renew_every`` seconds.  A failed renewal means the
    lease was lost (expired and reclaimed, or released elsewhere) —
    recorded in :attr:`lost`, but the keeper keeps renewing its
    heartbeat-side effects and the worker keeps computing: the result
    append is the arbiter, a lost lease at worst yields a dropped
    duplicate.
    """

    def __init__(
        self,
        store,
        cell_id: str,
        spec_hash: str,
        worker: str,
        ttl: float,
        renew_every: float | None = None,
    ):
        self.store = store
        self.cell_id = cell_id
        self.spec_hash = spec_hash
        self.worker = worker
        self.ttl = ttl
        self.renew_every = (
            renew_every if renew_every is not None else max(ttl / 3.0, 0.05)
        )
        self.lost = False
        self.renewals = 0
        self._next = time.monotonic() + self.renew_every

    def tick(self) -> None:
        if time.monotonic() < self._next:
            return
        self._next = time.monotonic() + self.renew_every
        if self.store.renew(self.cell_id, self.spec_hash, self.worker, self.ttl):
            self.renewals += 1
        else:
            self.lost = True
