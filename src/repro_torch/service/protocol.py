"""Line-JSON wire protocol: one JSON object per ``\\n``-terminated line.

Both clients and workers speak it over a plain TCP stream — asyncio on
the master side, and a small blocking client here for tests, scripts
and the CLI (no extra dependency either way).

Client ops (request -> one reply):

* ``{"op": "submit", "user": U, "tag": T, "job": {...}}`` ->
  ``{"ok": true, "job_id": N, "decision": "admit"|"queued"}`` or
  ``{"ok": false, "error": "reject-rate"|"reject-queue"}``.  ``job``
  uses the repro-trace task schema (``map``/``reduce`` lists of
  ``[duration, input_hosts, state_bytes]`` plus ``name``/``weight``/
  ``reduce_slowstart``); ``tag`` is an idempotency token — resubmitting
  the same tag returns the original job id instead of a duplicate.
* ``{"op": "job", "job_id": N}`` -> ``{"ok": true, "state":
  "queued"|"live"|"done", "completion_t": ...}``
* ``{"op": "status"}`` -> one telemetry snapshot
  (:meth:`repro_torch.service.telemetry.Telemetry.snapshot`).
* ``{"op": "telemetry", "ticks": K, "interval": s}`` -> streams K
  snapshot lines, ``interval`` wall-seconds apart (the live metrics
  feed).
* ``{"op": "checkpoint"}`` -> forces a checkpoint write.
* ``{"op": "shutdown"}`` -> graceful stop.

Worker ops (persistent duplex connection, no request pairing):

* worker -> master: ``{"op": "register", "machine": M}``,
  ``{"op": "heartbeat", "machine": M}``, ``{"op": "task_done", ...}``
  (advisory — the engine's completions are authoritative);
* master -> worker: ``{"op": "launch", "key": [...], "machine": M,
  "wall_s": s}``, ``{"op": "suspend"|"resume"|"kill", "key": [...]}``.
"""

from __future__ import annotations

import json
import socket

MAX_LINE = 1 << 20


def encode(obj: dict) -> bytes:
    return (json.dumps(obj, sort_keys=True) + "\n").encode()


def decode(line: bytes) -> dict:
    return json.loads(line.decode())


async def send(writer, obj: dict) -> None:
    writer.write(encode(obj))
    await writer.drain()


async def recv(reader) -> dict | None:
    """One message, or None on EOF/oversize (treat both as disconnect)."""
    try:
        line = await reader.readline()
    except (ConnectionError, ValueError):
        return None
    if not line or len(line) > MAX_LINE:
        return None
    try:
        return decode(line)
    except json.JSONDecodeError:
        return None


class ServiceClient:
    """Blocking request/reply client (tests, scripts, CLI)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self._sock.makefile("rwb")

    def call(self, msg: dict) -> dict:
        self._f.write(encode(msg))
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("master closed the connection")
        return decode(line)

    def read_line(self) -> dict | None:
        """Next pushed line (telemetry streaming)."""
        line = self._f.readline()
        return decode(line) if line else None

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
