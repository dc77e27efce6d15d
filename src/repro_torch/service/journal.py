"""Write-ahead journal: a live session recorded as a repro-trace.

Every external stimulus the master applies to its engine is appended
here *before* the effect is acknowledged (fsync per append — a crash
after the ack can always be replayed past).  The file is a valid
:mod:`repro_torch.scenarios.trace` JSONL trace — header line, then job
lines in the exact ``_job_record`` schema — interleaved with event lines:

* ``{"event": "advance", "t": T}`` — the engine ran ``run(until=T)``
  and processed at least one event.  Advance barriers are part of the
  determinism contract: with ``event_epsilon > 0`` a barrier flushes
  the open coalescing window, so pass placement depends on where the
  barriers fell — the twin must replay the recorded barriers, not
  recompute them from a clock.
* ``{"event": "crash"|"recover", "t": T, "machine": M}`` — scripted
  machine fault (worker death / rejoin), mapped onto
  ``Simulator.inject_fault``.
* ``{"event": "eps", "t": T, "value": E}`` — the auto-epsilon
  controller retuned the coalescing window.

Job lines may carry two extra keys the trace loader ignores:
``"user"`` (admission accounting) and ``"tag"`` (client-supplied
idempotency token — the restore path rebuilds its dedup map from
these, which is what makes submit exactly-once across a master crash).

Because :func:`repro_torch.scenarios.trace.load_trace` skips event
lines, a journal also doubles as a plain workload trace: the recorded
arrivals can be re-run offline as a scenario cell
(``WorkloadAxis(kind="trace", trace_path=<journal>)``).

The bytes are those the JAX package's ``repro.service.journal`` writes
(``json.dumps(..., sort_keys=True)`` per line, the same header, the same
torn-tail repair), and neither the device nor the virtual-cluster backend
is ever written: either package replays the other's journal.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from repro_torch.core.types import JobSpec
from repro_torch.scenarios.trace import TRACE_KIND, TRACE_VERSION, job_record

#: Event kinds a journal may contain, in the schema above.
EVENT_KINDS = ("advance", "crash", "recover", "eps")


def read_journal(path: str | Path) -> tuple[dict, list[dict]]:
    """Read a journal; returns ``(meta, entries)``.

    ``entries`` preserves file order and mixes job records with event
    records (distinguished by the ``"event"`` key).  A torn final line
    (partial write from a crash mid-append) is dropped — write-ahead
    ordering guarantees a torn line was never acknowledged.
    """
    path = Path(path)
    with path.open() as f:
        first = f.readline()
        if not first.strip():
            raise ValueError(f"{path}: empty journal")
        header = json.loads(first)
        if header.get("kind") != TRACE_KIND:
            raise ValueError(
                f"{path}: not a {TRACE_KIND} file (kind={header.get('kind')!r})"
            )
        if header.get("version") != TRACE_VERSION:
            raise ValueError(
                f"{path}: version {header.get('version')!r} != "
                f"supported {TRACE_VERSION}"
            )
        meta = header.get("meta", {})
        if not meta.get("journal"):
            raise ValueError(f"{path}: trace is not a service journal")
        entries = []
        for ln in f:
            if not ln.endswith("\n"):
                break  # torn tail: never acknowledged, never replayed
            ln = ln.strip()
            if not ln:
                continue
            try:
                d = json.loads(ln)
            except json.JSONDecodeError:
                break  # torn tail with a trailing newline from a later write
            ev = d.get("event")
            if ev is not None and ev not in EVENT_KINDS:
                raise ValueError(f"{path}: unknown journal event {ev!r}")
            entries.append(d)
    return meta, entries


class Journal:
    """Append-side of the journal (the read side is :func:`read_journal`).

    Opening a fresh path writes the header; opening an existing journal
    *repairs* it — the torn tail, if any, is truncated away so appends
    continue on a clean line boundary — and continues appending.
    """

    def __init__(self, path: str | Path, *, meta: dict | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists() and self.path.stat().st_size > 0:
            self._repair()
            # Validate + remember the existing header's meta.
            self.meta, _ = read_journal(self.path)
            self._f = self.path.open("a")
        else:
            if meta is None:
                raise ValueError("new journal needs meta (policy/cluster/...)")
            self.meta = dict(meta)
            self.meta["journal"] = True
            self._f = self.path.open("w")
            self._append(
                {
                    "kind": TRACE_KIND,
                    "version": TRACE_VERSION,
                    "meta": self.meta,
                }
            )

    def _repair(self) -> None:
        """Truncate a torn final line left by a crash mid-append."""
        with self.path.open("r+b") as f:
            data = f.read()
            keep = len(data)
            nl = data.rfind(b"\n")
            if nl != len(data) - 1:
                keep = nl + 1  # drop the partial line (or everything if no \n)
            else:
                # Complete lines only — but the last one may still be
                # syntactically torn if the crash interleaved writes;
                # drop trailing lines until the remainder parses.
                lines = data.decode().splitlines(keepends=True)
                while lines:
                    try:
                        json.loads(lines[-1])
                        break
                    except json.JSONDecodeError:
                        keep -= len(lines.pop().encode())
            if keep != len(data):
                f.truncate(keep)

    def _append(self, obj: dict) -> None:
        self._f.write(json.dumps(obj, sort_keys=True) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    # -- write-ahead appends (each durable before the caller proceeds) --
    def append_job(
        self, spec: JobSpec, *, user: str | None = None, tag: str | None = None
    ) -> None:
        rec = job_record(spec)
        if user is not None:
            rec["user"] = user
        if tag is not None:
            rec["tag"] = tag
        self._append(rec)

    def append_event(self, event: dict) -> None:
        if event.get("event") not in EVENT_KINDS:
            raise ValueError(f"unknown journal event {event.get('event')!r}")
        self._append(event)

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
