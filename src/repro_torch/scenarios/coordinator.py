"""Coordinator view over a distributed sweep's shared store (a copy of
``repro.scenarios.coordinator``).

``sweep_status`` is pure observation — it writes nothing, so it is safe
to run while workers are live.  It classifies every cell of the sweep
(done / quarantined / leased / pending), surfaces expired leases and
stale results (stored under an outdated ``spec_hash``), reports
per-worker liveness from heartbeats, and echoes the store's
coordination counters (claims / reissues / duplicates / ...).

There is deliberately no *active* reaper process: reclaim is passive
(any worker's ``claim`` takes over an expired lease, see
:mod:`repro_torch.scenarios.lease`), so a sweep with dead workers still
converges as long as one worker survives — the coordinator only makes
that degradation visible.
"""

from __future__ import annotations

import time

from repro_torch.scenarios.spec import SweepSpec
from repro_torch.scenarios.store import SweepStore, open_store

#: A worker whose last heartbeat is older than this is reported dead.
DEFAULT_DEAD_AFTER = 60.0


def sweep_status(
    sweep: SweepSpec,
    store: SweepStore | str,
    *,
    now: float | None = None,
    dead_after: float = DEFAULT_DEAD_AFTER,
) -> dict:
    """Snapshot of a sweep's progress against a shared store.

    Keys: ``cells`` (total), ``done``/``quarantined`` (cell id lists),
    ``leased`` ({cid: {worker, expires_in_s}} for live leases),
    ``expired_leases`` (cells whose lease TTL passed without release —
    reclaimable), ``pending`` (claimable now: never leased or lease
    expired), ``stale`` (a result exists for the cell id but under a
    different spec_hash — the spec changed since it was stored),
    ``workers`` ({worker: {last_seen_s, live, info}}), ``stats``
    (store coordination counters), ``converged`` (bool).
    """
    store = open_store(store)
    t = time.time() if now is None else now
    cells = sweep.expand()
    stored = store.load()
    held = store.leases()
    stored_cids = {cid for cid, _ in stored}

    done: list[str] = []
    quarantined: list[str] = []
    leased: dict[str, dict] = {}
    expired_leases: list[str] = []
    pending: list[str] = []
    stale: list[str] = []
    for cid, spec in cells:
        h = spec.spec_hash()
        rec = stored.get((cid, h))
        if rec is not None:
            (quarantined if rec.get("quarantined") else done).append(cid)
            continue
        if cid in stored_cids:
            stale.append(cid)
        lease = held.get((cid, h))
        if lease is not None and not lease.expired(t):
            leased[cid] = {
                "worker": lease.worker,
                "expires_in_s": round(lease.remaining(t), 3),
            }
        elif lease is not None:
            expired_leases.append(cid)
            pending.append(cid)  # expired lease = claimable now
        else:
            pending.append(cid)

    workers = {}
    for w, rec in sorted(store.workers().items()):
        age = t - rec["last_seen"]
        workers[w] = {
            "last_seen_s": round(age, 3),
            "live": age <= dead_after,
            "info": rec["info"],
        }

    return {
        "sweep": sweep.name,
        "cells": len(cells),
        "done": sorted(done),
        "quarantined": sorted(quarantined),
        "leased": leased,
        "expired_leases": sorted(expired_leases),
        "pending": sorted(pending),
        "stale": sorted(stale),
        "workers": workers,
        "stats": store.stats(),
        "converged": len(done) + len(quarantined) == len(cells),
    }


def format_status(status: dict) -> str:
    """Human-readable rendering of a ``sweep_status`` snapshot."""
    lines = [
        f"sweep {status['sweep']}: "
        f"{len(status['done'])}/{status['cells']} done"
        f", {len(status['quarantined'])} quarantined"
        f", {len(status['leased'])} leased"
        f", {len(status['pending'])} pending"
        + (" — converged" if status["converged"] else ""),
    ]
    for cid, lease in sorted(status["leased"].items()):
        lines.append(
            f"  leased  {cid}  -> {lease['worker']} "
            f"(expires in {lease['expires_in_s']}s)"
        )
    for cid in status["expired_leases"]:
        lines.append(f"  expired {cid}  (lease lapsed; reclaimable)")
    for cid in status["quarantined"]:
        lines.append(f"  quarantined {cid}")
    for cid in status["stale"]:
        lines.append(f"  stale   {cid}  (stored under an outdated spec_hash)")
    for w, rec in status["workers"].items():
        state = "live" if rec["live"] else "DEAD"
        lines.append(
            f"  worker  {w}  {state} (last seen {rec['last_seen_s']}s ago, "
            f"info {rec['info']})"
        )
    stats = status["stats"]
    lines.append(
        "  stats   "
        + ", ".join(f"{k}={stats[k]}" for k in sorted(stats))
    )
    return "\n".join(lines)
