"""Pluggable result stores for sweep execution.

A copy of ``repro.scenarios.store``.  Both on-disk formats are the
reference's byte for byte (JSON with sorted keys, the same sidecar event
log, the same sqlite schema), so either package can finish a store the
other began.

A store holds finished sweep cells keyed by ``(cell_id, spec_hash)``
plus the coordination rows the distributed fabric needs: TTL'd cell
leases, worker heartbeats, and monotonic counters.  Two backends:

* :class:`ResultStore` — the reference backend: append-only fsync'd
  JSONL for results (a crash loses at most a torn trailing line,
  repaired before the next append) plus an
  append-only ``<path>.leases`` event log for coordination, both guarded
  by ``flock`` so concurrent writers on one (locally shared) filesystem
  interleave safely.
* :class:`SqliteResultStore` — sqlite file safe for concurrent writers
  on a shared filesystem.  ``BEGIN IMMEDIATE`` transactions + busy
  timeout serialize writers; the default rollback journal (not WAL —
  WAL requires shared memory and is explicitly unsafe over NFS) with
  ``synchronous=FULL`` makes commits crash-atomic: a SIGKILL mid-append
  loses at most the uncommitted record, never a committed one.  Each
  operation opens its own short-lived connection, so SIGKILLing a
  worker never wedges the database (sqlite's POSIX locks die with the
  process and the next opener rolls the journal back).

Shared contract (pinned by the reference's backend-parametrized
crash-consistency tests):

* ``append`` is **exactly-once** per ``(cell_id, spec_hash)`` across any
  number of concurrent writer processes: the first finisher wins,
  duplicates are detected, dropped, and counted in ``stats()``.
* After any crash, ``load()`` parses cleanly and returns a
  duplicate-free map containing every acknowledged append.
* ``claim`` over another worker's *expired* lease succeeds and counts
  as a ``reissue``; over a live lease it fails.

``open_store`` picks the backend from the path (``.sqlite``/
``.sqlite3``/``.db`` suffix or a ``sqlite:`` prefix -> sqlite, anything
else -> JSONL), so every CLI ``--store`` flag accepts either.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from contextlib import closing
from pathlib import Path

from repro_torch.scenarios.lease import COUNTERS, Lease, LeaseState

try:  # pragma: no cover - import guard, exercised only off-POSIX
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback: no locking
    fcntl = None


def _now(now: float | None) -> float:
    return time.time() if now is None else now


def _flock(f) -> None:
    if fcntl is not None:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)


def _funlock(f) -> None:
    if fcntl is not None:
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)


class SweepStore:
    """Backend interface (see module docstring for the contract)."""

    path: Path

    # -- results ------------------------------------------------------
    def load(self) -> dict[tuple[str, str], dict]:
        """{(cell_id, spec_hash): result} for every stored cell."""
        raise NotImplementedError

    def append(self, cell_id: str, spec_hash: str, result: dict) -> bool:
        """Store one finished cell; False = duplicate detected and
        dropped (the first finisher's record is untouched)."""
        raise NotImplementedError

    # -- leases -------------------------------------------------------
    def claim(
        self,
        cell_id: str,
        spec_hash: str,
        worker: str,
        ttl: float,
        now: float | None = None,
    ) -> bool:
        """Atomically claim a cell for ``ttl`` seconds.  Fails if another
        worker holds an unexpired lease; claiming over an *expired*
        foreign lease succeeds and is counted as a reissue.  Does not
        check whether the result is already stored — racing a stored
        cell is benign (the duplicate append is dropped)."""
        raise NotImplementedError

    def renew(
        self,
        cell_id: str,
        spec_hash: str,
        worker: str,
        ttl: float,
        now: float | None = None,
    ) -> bool:
        """Extend a held lease; False if this worker no longer holds it."""
        raise NotImplementedError

    def release(self, cell_id: str, spec_hash: str, worker: str) -> None:
        """Drop a held lease (no-op if this worker does not hold it)."""
        raise NotImplementedError

    def leases(self) -> dict[tuple[str, str], Lease]:
        """All leases on the books, including expired-but-unreclaimed
        ones (callers filter with ``lease.expired(now)``)."""
        raise NotImplementedError

    # -- worker liveness ---------------------------------------------
    def heartbeat(
        self, worker: str, info: dict | None = None, now: float | None = None
    ) -> None:
        raise NotImplementedError

    def workers(self) -> dict[str, dict]:
        """{worker: {"last_seen": epoch_s, "info": dict}}."""
        raise NotImplementedError

    # -- observability ------------------------------------------------
    def stats(self) -> dict[str, int]:
        """Coordination counters (all :data:`~repro_torch.scenarios.lease.COUNTERS`
        keys always present)."""
        raise NotImplementedError


class ResultStore(SweepStore):
    """Append-only JSONL store of finished sweep cells (reference backend).

    One line per finished cell::

        {"cell_id": ..., "spec_hash": ..., "result": {scenario_report}}

    Append-only + line-granular means a crash mid-write loses at most the
    last line (a torn trailing line is detected and ignored on load).
    Appends take an exclusive ``flock`` and re-scan the file's new bytes
    (incrementally, from a per-process offset cache) before writing, so
    concurrent writers racing the same cell keep the store exactly-once.

    Coordination rows live in a sidecar event log ``<path>.leases``
    (same torn-line-tolerant JSONL discipline), folded through
    :class:`~repro_torch.scenarios.lease.LeaseState`.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.lease_path = Path(str(self.path) + ".leases")
        # Incremental duplicate-scan cache: keys seen up to byte offset
        # _scan_pos.  Only complete lines advance the offset; under the
        # append lock the cache is refreshed from the new bytes first.
        self._seen: set[tuple[str, str]] = set()
        self._scan_pos = 0
        # Incremental lease-log fold cache, same discipline.
        self._lease_state = LeaseState()
        self._lease_pos = 0

    # -- results ------------------------------------------------------
    def load(self) -> dict[tuple[str, str], dict]:
        """{(cell_id, spec_hash): result} for every intact stored line."""
        out: dict[tuple[str, str], dict] = {}
        if not self.path.exists():
            return out
        with self.path.open() as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                except json.JSONDecodeError:
                    continue  # torn trailing line from an interrupted run
                out[(rec["cell_id"], rec["spec_hash"])] = rec["result"]
        return out

    def _refresh_seen(self, f) -> set[tuple[str, str]]:
        """Fold bytes appended since the last scan into the seen-keys
        cache (caller holds the lock).  A complete-JSON tail missing its
        newline (torn by a crash after the JSON but before the ``\\n``)
        is counted as seen but does not advance the offset — the next
        append's newline repair completes it.  An out-of-band truncation
        (file shorter than the cached offset — e.g. an operator resetting
        a damaged store under a live process) invalidates the cache, so
        rebuild it from byte 0."""
        f.seek(0, os.SEEK_END)
        if f.tell() < self._scan_pos:
            self._seen.clear()
            self._scan_pos = 0
        f.seek(self._scan_pos)
        data = f.read()
        end = data.rfind(b"\n")
        lines = data[: end + 1].splitlines() if end >= 0 else []
        tail = data[end + 1 :] if end >= 0 else data
        if tail:
            lines = [*lines, tail]
        for ln in lines:
            try:
                rec = json.loads(ln)
                self._seen.add((rec["cell_id"], rec["spec_hash"]))
            except (json.JSONDecodeError, KeyError, TypeError, UnicodeDecodeError):
                continue
        if end >= 0:
            self._scan_pos += end + 1
        return self._seen

    def append(self, cell_id: str, spec_hash: str, result: dict) -> bool:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        rec = {"cell_id": cell_id, "spec_hash": spec_hash, "result": result}
        with self.path.open("a+b") as f:
            _flock(f)
            try:
                if (cell_id, spec_hash) in self._refresh_seen(f):
                    self._count_dup(cell_id, spec_hash)
                    return False
                # A crash can lose the previous record's trailing newline
                # while its JSON survived (load() still recovers it);
                # appending onto that unterminated line would corrupt
                # BOTH records, so repair the newline first.
                f.seek(0, os.SEEK_END)
                lead = b""
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        lead = b"\n"
                f.seek(0, os.SEEK_END)
                f.write(lead + (json.dumps(rec, sort_keys=True) + "\n").encode())
                f.flush()
                os.fsync(f.fileno())
                self._seen.add((cell_id, spec_hash))
            finally:
                _funlock(f)
        return True

    # -- lease event log ----------------------------------------------
    def _with_leases(self, fn):
        """Run ``fn(f)`` with the lease log open, locked, and the fold
        cache refreshed to its current end."""
        self.lease_path.parent.mkdir(parents=True, exist_ok=True)
        with self.lease_path.open("a+b") as f:
            _flock(f)
            try:
                self._refresh_lease_state(f)
                return fn(f)
            finally:
                _funlock(f)

    def _refresh_lease_state(self, f) -> None:
        f.seek(0, os.SEEK_END)
        if f.tell() < self._lease_pos:
            self._lease_state = LeaseState()
            self._lease_pos = 0
        f.seek(self._lease_pos)
        data = f.read()
        end = data.rfind(b"\n")
        if end < 0:
            return
        for ln in data[: end + 1].splitlines():
            try:
                self._lease_state.apply(json.loads(ln))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                continue
        self._lease_pos += end + 1

    def _lease_append(self, f, rec: dict) -> None:
        f.seek(0, os.SEEK_END)
        lead = b""
        if f.tell() > 0:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                lead = b"\n"
        f.seek(0, os.SEEK_END)
        f.write(lead + (json.dumps(rec, sort_keys=True) + "\n").encode())
        f.flush()
        os.fsync(f.fileno())
        self._lease_state.apply(rec)
        self._lease_pos = f.tell()

    def _count_dup(self, cell_id: str, spec_hash: str) -> None:
        self._with_leases(
            lambda f: self._lease_append(
                f,
                {
                    "op": "dup",
                    "cell_id": cell_id,
                    "spec_hash": spec_hash,
                    "worker": "",
                    "t": time.time(),
                },
            )
        )

    # -- leases -------------------------------------------------------
    def claim(self, cell_id, spec_hash, worker, ttl, now=None) -> bool:
        t = _now(now)

        def do(f):
            key = (cell_id, spec_hash)
            cur = self._lease_state.leases.get(key)
            reissue = False
            if cur is not None and cur.worker != worker:
                if not cur.expired(t):
                    return False
                reissue = True
            self._lease_append(
                f,
                {
                    "op": "claim",
                    "cell_id": cell_id,
                    "spec_hash": spec_hash,
                    "worker": worker,
                    "expires": t + ttl,
                    "t": t,
                    "reissue": reissue,
                },
            )
            return True

        return self._with_leases(do)

    def renew(self, cell_id, spec_hash, worker, ttl, now=None) -> bool:
        t = _now(now)

        def do(f):
            cur = self._lease_state.leases.get((cell_id, spec_hash))
            if cur is None or cur.worker != worker:
                return False
            self._lease_append(
                f,
                {
                    "op": "renew",
                    "cell_id": cell_id,
                    "spec_hash": spec_hash,
                    "worker": worker,
                    "expires": t + ttl,
                    "t": t,
                },
            )
            return True

        return self._with_leases(do)

    def release(self, cell_id, spec_hash, worker) -> None:
        def do(f):
            cur = self._lease_state.leases.get((cell_id, spec_hash))
            if cur is None or cur.worker != worker:
                return
            self._lease_append(
                f,
                {
                    "op": "release",
                    "cell_id": cell_id,
                    "spec_hash": spec_hash,
                    "worker": worker,
                    "t": time.time(),
                },
            )

        self._with_leases(do)

    def leases(self) -> dict[tuple[str, str], Lease]:
        if not self.lease_path.exists():
            return {}
        self._with_leases(lambda f: None)
        return dict(self._lease_state.leases)

    # -- worker liveness ---------------------------------------------
    def heartbeat(self, worker, info=None, now=None) -> None:
        t = _now(now)
        rec = {"op": "beat", "worker": worker, "t": t}
        if info:
            rec["info"] = info
        self._with_leases(lambda f: self._lease_append(f, rec))

    def workers(self) -> dict[str, dict]:
        if not self.lease_path.exists():
            return {}
        self._with_leases(lambda f: None)
        return {
            w: {"last_seen": rec["last_seen"], "info": dict(rec["info"])}
            for w, rec in self._lease_state.workers.items()
        }

    # -- observability ------------------------------------------------
    def stats(self) -> dict[str, int]:
        if self.lease_path.exists():
            self._with_leases(lambda f: None)
        return dict(self._lease_state.counters)


class SqliteResultStore(SweepStore):
    """Sqlite-backed store safe for concurrent writers on a shared
    filesystem (see module docstring for the crash/concurrency model).
    """

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS results (
        cell_id   TEXT NOT NULL,
        spec_hash TEXT NOT NULL,
        result    TEXT NOT NULL,
        PRIMARY KEY (cell_id, spec_hash)
    );
    CREATE TABLE IF NOT EXISTS leases (
        cell_id   TEXT NOT NULL,
        spec_hash TEXT NOT NULL,
        worker    TEXT NOT NULL,
        expires   REAL NOT NULL,
        PRIMARY KEY (cell_id, spec_hash)
    );
    CREATE TABLE IF NOT EXISTS workers (
        worker    TEXT PRIMARY KEY,
        last_seen REAL NOT NULL,
        info      TEXT NOT NULL DEFAULT '{}'
    );
    CREATE TABLE IF NOT EXISTS counters (
        name  TEXT PRIMARY KEY,
        value INTEGER NOT NULL DEFAULT 0
    );
    """

    def __init__(self, path: str | Path, busy_timeout: float = 30.0):
        self.path = Path(path)
        self.busy_timeout = busy_timeout

    def _connect(self) -> sqlite3.Connection:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        conn = sqlite3.connect(str(self.path), timeout=self.busy_timeout)
        conn.isolation_level = None  # explicit BEGIN/COMMIT below
        conn.execute("PRAGMA synchronous=FULL")
        conn.executescript(self._SCHEMA)
        return conn

    @staticmethod
    def _bump(conn: sqlite3.Connection, name: str, by: int = 1) -> None:
        conn.execute(
            "INSERT INTO counters (name, value) VALUES (?, ?) "
            "ON CONFLICT(name) DO UPDATE SET value = value + ?",
            (name, by, by),
        )

    @staticmethod
    def _beat(conn, worker: str, t: float, info: dict | None = None) -> None:
        row = conn.execute(
            "SELECT last_seen, info FROM workers WHERE worker = ?", (worker,)
        ).fetchone()
        merged = json.loads(row[1]) if row else {}
        if info:
            merged.update(info)
        last = max(t, row[0]) if row else t
        conn.execute(
            "INSERT OR REPLACE INTO workers (worker, last_seen, info) "
            "VALUES (?, ?, ?)",
            (worker, last, json.dumps(merged, sort_keys=True)),
        )

    # -- results ------------------------------------------------------
    def load(self) -> dict[tuple[str, str], dict]:
        if not self.path.exists():
            return {}
        with closing(self._connect()) as conn:
            rows = conn.execute(
                "SELECT cell_id, spec_hash, result FROM results"
            ).fetchall()
        return {(cid, h): json.loads(res) for cid, h, res in rows}

    def append(self, cell_id, spec_hash, result) -> bool:
        with closing(self._connect()) as conn:
            conn.execute("BEGIN IMMEDIATE")
            cur = conn.execute(
                "INSERT OR IGNORE INTO results (cell_id, spec_hash, result) "
                "VALUES (?, ?, ?)",
                (cell_id, spec_hash, json.dumps(result, sort_keys=True)),
            )
            stored = cur.rowcount == 1
            if not stored:
                self._bump(conn, "duplicates")
            conn.execute("COMMIT")
        return stored

    # -- leases -------------------------------------------------------
    def claim(self, cell_id, spec_hash, worker, ttl, now=None) -> bool:
        t = _now(now)
        with closing(self._connect()) as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT worker, expires FROM leases "
                "WHERE cell_id = ? AND spec_hash = ?",
                (cell_id, spec_hash),
            ).fetchone()
            reissue = False
            if row is not None and row[0] != worker:
                if row[1] > t:
                    conn.execute("COMMIT")
                    return False
                reissue = True
            conn.execute(
                "INSERT OR REPLACE INTO leases "
                "(cell_id, spec_hash, worker, expires) VALUES (?, ?, ?, ?)",
                (cell_id, spec_hash, worker, t + ttl),
            )
            self._bump(conn, "claims")
            if reissue:
                self._bump(conn, "reissues")
            self._beat(conn, worker, t)
            conn.execute("COMMIT")
        return True

    def renew(self, cell_id, spec_hash, worker, ttl, now=None) -> bool:
        t = _now(now)
        with closing(self._connect()) as conn:
            conn.execute("BEGIN IMMEDIATE")
            cur = conn.execute(
                "UPDATE leases SET expires = ? "
                "WHERE cell_id = ? AND spec_hash = ? AND worker = ?",
                (t + ttl, cell_id, spec_hash, worker),
            )
            renewed = cur.rowcount == 1
            if renewed:
                self._bump(conn, "renews")
                self._beat(conn, worker, t)
            conn.execute("COMMIT")
        return renewed

    def release(self, cell_id, spec_hash, worker) -> None:
        with closing(self._connect()) as conn:
            conn.execute("BEGIN IMMEDIATE")
            cur = conn.execute(
                "DELETE FROM leases "
                "WHERE cell_id = ? AND spec_hash = ? AND worker = ?",
                (cell_id, spec_hash, worker),
            )
            if cur.rowcount == 1:
                self._bump(conn, "releases")
            conn.execute("COMMIT")

    def leases(self) -> dict[tuple[str, str], Lease]:
        if not self.path.exists():
            return {}
        with closing(self._connect()) as conn:
            rows = conn.execute(
                "SELECT cell_id, spec_hash, worker, expires FROM leases"
            ).fetchall()
        return {(c, h): Lease(c, h, w, e) for c, h, w, e in rows}

    # -- worker liveness ---------------------------------------------
    def heartbeat(self, worker, info=None, now=None) -> None:
        t = _now(now)
        with closing(self._connect()) as conn:
            conn.execute("BEGIN IMMEDIATE")
            self._beat(conn, worker, t, info)
            conn.execute("COMMIT")

    def workers(self) -> dict[str, dict]:
        if not self.path.exists():
            return {}
        with closing(self._connect()) as conn:
            rows = conn.execute(
                "SELECT worker, last_seen, info FROM workers"
            ).fetchall()
        return {
            w: {"last_seen": t, "info": json.loads(info)} for w, t, info in rows
        }

    # -- observability ------------------------------------------------
    def stats(self) -> dict[str, int]:
        out = {k: 0 for k in COUNTERS}
        if not self.path.exists():
            return out
        with closing(self._connect()) as conn:
            rows = conn.execute("SELECT name, value FROM counters").fetchall()
        out.update(dict(rows))
        return out


#: Path suffixes routed to the sqlite backend by :func:`open_store`.
_SQLITE_SUFFIXES = (".sqlite", ".sqlite3", ".db")


def open_store(
    path: SweepStore | str | Path, backend: str | None = None
) -> SweepStore:
    """Coerce a path (or pass through an existing store) to a backend.

    ``backend`` forces ``"jsonl"`` or ``"sqlite"``; otherwise a
    ``sqlite:`` prefix or a ``.sqlite``/``.sqlite3``/``.db`` suffix
    selects sqlite and anything else gets the JSONL reference backend.
    """
    if isinstance(path, SweepStore):
        return path
    p = str(path)
    if backend is None:
        if p.startswith("sqlite:"):
            backend, p = "sqlite", p[len("sqlite:") :]
        elif Path(p).suffix.lower() in _SQLITE_SUFFIXES:
            backend = "sqlite"
        else:
            backend = "jsonl"
    if backend == "sqlite":
        return SqliteResultStore(p)
    if backend == "jsonl":
        return ResultStore(p)
    raise ValueError(f"unknown store backend {backend!r}")
