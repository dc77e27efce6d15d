"""Worker agents: heartbeat + advisory task execution.

A worker represents one machine of the cluster.  It registers with the
master, heartbeats on a wall-clock period, and *mimes* the tasks the
master dispatches to it (sleeping ``duration / time_scale`` wall
seconds, then reporting ``task_done``).  The mime is advisory by
design: the engine's discrete-event completions are authoritative (the
simulator is the source of truth the twin replays), so a slow, dead or
lying worker can never corrupt scheduling state — it can only *fail to
heartbeat*, which the master turns into a journaled scripted ``crash``
(and a later rejoin into ``recover``), exactly the fault model the
offline suite tests.

Two deployments of the same agent:

* :class:`WorkerAgent` — in-process asyncio task (tests, smoke runs);
  ``die()`` kills it silently (no unregister) to exercise the
  dead-worker path.
* ``python -m repro_torch.service worker --connect HOST:PORT --machine M``
  — subprocess runner wrapping the same class (see __main__.py).
"""

from __future__ import annotations

import asyncio

from repro_torch.service import protocol


class WorkerAgent:
    def __init__(
        self,
        host: str,
        port: int,
        machine: int,
        *,
        heartbeat_wall: float = 0.05,
    ):
        self.host, self.port, self.machine = host, port, machine
        self.heartbeat_wall = heartbeat_wall
        self._tasks: dict[tuple, asyncio.Task] = {}
        self._runner: asyncio.Task | None = None
        self._writer = None
        self.launched = 0
        self.done = 0
        self.preempted = 0

    async def start(self) -> None:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        self._writer = writer
        await protocol.send(writer, {"op": "register", "machine": self.machine})
        self._runner = asyncio.gather(
            self._heartbeats(writer), self._serve(reader, writer)
        )

    async def _heartbeats(self, writer) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_wall)
            await protocol.send(
                writer, {"op": "heartbeat", "machine": self.machine}
            )

    async def _serve(self, reader, writer) -> None:
        while True:
            msg = await protocol.recv(reader)
            if msg is None:
                break
            op = msg.get("op")
            key = tuple(msg.get("key", ()))
            if op == "launch":
                self.launched += 1
                self._tasks[key] = asyncio.ensure_future(
                    self._mime(writer, key, float(msg.get("wall_s", 0.0)))
                )
            elif op in ("suspend", "kill"):
                t = self._tasks.pop(key, None)
                if t is not None:
                    t.cancel()
                    self.preempted += 1
            # "resume" arrives as a fresh launch (the master re-sends
            # the remaining wall time), so no separate handler.

    async def _mime(self, writer, key: tuple, wall_s: float) -> None:
        try:
            await asyncio.sleep(wall_s)
            self.done += 1
            await protocol.send(
                writer,
                {"op": "task_done", "machine": self.machine, "key": list(key)},
            )
        except asyncio.CancelledError:
            pass
        finally:
            self._tasks.pop(key, None)

    async def stop(self) -> None:
        """Graceful stop: cancel everything and close the connection."""
        await self.die()

    async def die(self) -> None:
        """Silent death — no unregister, heartbeats just stop, and the
        master's deadline check turns the silence into a crash event."""
        if self._runner is not None:
            self._runner.cancel()
            try:
                await self._runner
            except (asyncio.CancelledError, Exception):
                pass
            self._runner = None
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()
        if self._writer is not None:
            self._writer.close()
            self._writer = None


async def run_worker(
    host: str, port: int, machine: int, heartbeat_wall: float = 0.05
) -> None:
    """Subprocess entry: run one agent until the connection drops."""
    agent = WorkerAgent(host, port, machine, heartbeat_wall=heartbeat_wall)
    await agent.start()
    try:
        await agent._runner
    except (asyncio.CancelledError, ConnectionError):
        pass
