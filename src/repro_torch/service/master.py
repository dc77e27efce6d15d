"""Asyncio master: admission, dispatch, heartbeats, checkpointing.

Single-threaded by construction: every mutation of the engine happens
on the event loop (message handlers and the pacer), so the journaled
stimulus order is a total order — the property the twin replay depends
on.  The master's responsibilities around the engine:

* **clients** — line-JSON request/reply (see protocol.py): submit with
  idempotency tags, job state queries, telemetry pull/stream,
  checkpoint, graceful shutdown;
* **admission** — token-bucket rate limits and max-live-jobs
  backpressure (admission.py); queued jobs drain on completions and
  pacer ticks;
* **workers** — registration, heartbeat deadlines (a silent worker
  becomes a journaled scripted ``crash``; a re-registration becomes
  ``recover``), and advisory dispatch: every Start/Resume/Suspend/Kill
  the engine applies is mirrored to the worker owning that machine;
* **checkpointing** — the journal already *is* the scheduler+estimator
  checkpoint (log-structured; replay reconstructs state
  bit-identically).  The periodic checkpoint file only snapshots what
  the journal cannot know: submissions still queued in admission
  control.  Restore = repair journal, replay, requeue, resume clock.

Three deliberate divergences from the JAX package's master, each
marked in the code:

(a) ``stop()`` returns with connections open.  Since Python 3.12.1
    ``Server.wait_closed()`` waits until every accepted connection has
    closed, and a worker closes its connection only after the master has
    stopped: the master keeps every stream it accepts and closes them
    before waiting.  No journal line and no schedule changes.
(b) A failing engine ends the master.  An exception in the pacer (the
    only caller of the wall-clock advance) stops the master and
    :meth:`Master.serve_forever` re-raises it; so does a device failure
    (:func:`repro_torch.is_device_failure`) in a request handler.
    Nothing is retried.
(c) A frame may be as long as the protocol allows (``protocol.MAX_LINE``,
    1 MiB).  The JAX package's server keeps asyncio's 64 KiB line limit,
    so it drops the connection of a client that submits a job of more than
    ~1400 tasks (three of the paper's 100 FB jobs).
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch import is_device_failure
from repro_torch.core.scheduler import Kill, Resume, Start, Suspend
from repro_torch.scenarios.trace import job_from_record
from repro_torch.service import protocol
from repro_torch.service.admission import AdmissionConfig, AdmissionControl
from repro_torch.service.engine import LiveEngine
from repro_torch.service.journal import read_journal
from repro_torch.service.telemetry import Telemetry

CHECKPOINT_KIND = "repro-service-checkpoint"


@dataclass
class MasterConfig:
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral; resolved port in Master.port
    #: Pacer period (wall seconds): advance cadence and heartbeat check.
    pace_wall: float = 0.02
    #: Wall seconds of heartbeat silence after which a worker is dead.
    worker_dead_wall: float = 0.5
    checkpoint_path: str | None = None
    checkpoint_every_wall: float = 0.25
    #: Re-run the auto-epsilon controller this often (0 = never).  On
    #: by default: the service's batching window tracks observed
    #: arrival burstiness (auto_event_epsilon), with every retune
    #: journaled so the twin replays it.
    eps_auto_every_wall: float = 0.25
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)


@dataclass
class _Worker:
    machine: int
    queue: asyncio.Queue
    alive: bool = True
    last_hb: float = 0.0
    sender: asyncio.Task | None = None


class Master:
    def __init__(self, engine: LiveEngine, cfg: MasterConfig | None = None):
        self.engine = engine
        self.cfg = cfg or MasterConfig()
        self.admission = AdmissionControl(self.cfg.admission)
        self.telemetry = Telemetry(engine)
        self.workers: dict[int, _Worker] = {}
        #: tag -> job_id (admitted) or "queued" (held in admission).
        self.tags: dict[str, object] = {}
        self._waiters: dict[int, list[asyncio.Future]] = {}
        self._server: asyncio.AbstractServer | None = None
        self._pacer: asyncio.Task | None = None
        self._stopping = asyncio.Event()
        # Divergence (a): every stream the server accepted and has not
        # closed yet, so that stop() can close them before waiting.
        self._streams: set[asyncio.StreamWriter] = set()
        # Divergence (b): the engine failure that stopped the master.
        self.failure: BaseException | None = None
        self.port: int | None = None
        engine.sim.action_listener = self._on_action
        engine.sim.completion_listener = self._on_completion
        self._seed_from_journal()

    # -- restore glue ----------------------------------------------------
    def _seed_from_journal(self) -> None:
        """Rebuild the tag-dedup map and telemetry sizes from the
        journal (restore path; a fresh journal has no job lines)."""
        _, entries = read_journal(self.engine.journal.path)
        for d in entries:
            if d.get("event") is not None:
                continue
            spec = job_from_record(d)
            self.telemetry.note_job(spec)
            if "tag" in d:
                self.tags[d["tag"]] = spec.job_id
        # telemetry "submitted" must match the engine's journal count.
        self.telemetry.counters["submitted"] = self.engine.submitted

    def load_checkpoint(self) -> None:
        """Requeue admission state from the checkpoint file (if any).
        Tags already admitted per the journal win over the checkpoint's
        queue snapshot — a job must never be admitted twice."""
        path = self.cfg.checkpoint_path
        if not path or not Path(path).exists():
            return
        ck = json.loads(Path(path).read_text())
        if ck.get("kind") != CHECKPOINT_KIND:
            raise ValueError(f"{path}: not a {CHECKPOINT_KIND} file")
        queued: dict[str, list] = {}
        for user, items in ck.get("queued", {}).items():
            keep = []
            for item in items:
                tag = item.get("tag")
                if tag is not None and tag in self.tags:
                    continue  # journal says it was admitted before the crash
                if tag is not None:
                    self.tags[tag] = "queued"
                keep.append(item)
            if keep:
                queued[user] = keep
        self.admission.requeue(queued)

    def checkpoint(self) -> None:
        path = self.cfg.checkpoint_path
        if not path:
            return
        ck = {
            "kind": CHECKPOINT_KIND,
            "version": 1,
            "v_now": self.engine.virtual_now(),
            "journal": str(self.engine.journal.path),
            "queued": self.admission.queued_items(),
        }
        tmp = Path(path).with_suffix(".tmp")
        tmp.write_text(json.dumps(ck, sort_keys=True))
        tmp.replace(path)  # atomic: a crash mid-write never corrupts

    # -- engine listeners (called synchronously inside sim.run) ----------
    def _on_action(self, action, now: float) -> None:
        if isinstance(action, (Start, Resume)):
            machine = action.slot.machine
            att = action.attempt
            rem = att.remaining
            if att.rate != 1.0:
                rem = rem / att.rate
            msg = {
                "op": "launch",
                "key": list(att.spec.key),
                "machine": machine,
                "wall_s": rem / self.engine.time_scale,
            }
        elif isinstance(action, (Suspend, Kill)):
            att = action.attempt
            machine = att.machine
            msg = {
                "op": "suspend" if isinstance(action, Suspend) else "kill",
                "key": list(att.spec.key),
            }
        else:  # pragma: no cover - future action kinds are advisory too
            return
        w = self.workers.get(machine)
        if w is not None and w.alive:
            w.queue.put_nowait(msg)

    def _on_completion(self, job_id: int, now: float) -> None:
        for fut in self._waiters.pop(job_id, ()):
            if not fut.done():
                fut.set_result(now)

    # -- lifecycle -------------------------------------------------------
    async def start(self) -> None:
        self.load_checkpoint()
        self._server = await asyncio.start_server(
            self._handle, self.cfg.host, self.cfg.port,
            limit=protocol.MAX_LINE,  # divergence (c)
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._pacer = asyncio.ensure_future(self._pace())
        self._pacer.add_done_callback(self._on_pacer_done)

    async def serve_forever(self) -> None:
        """Serve until shutdown; re-raises the engine failure that
        stopped the master, if one did (divergence (b))."""
        await self._stopping.wait()
        await self.stop()
        if self.failure is not None:
            raise self.failure

    def _fail(self, exc: BaseException) -> None:
        """Divergence (b): an engine failure stops the master."""
        if self.failure is None:
            self.failure = exc
        self._stopping.set()

    def _on_pacer_done(self, task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            self._fail(task.exception())

    async def stop(self) -> None:
        self._stopping.set()
        if self._pacer is not None and not self._pacer.done():
            self._pacer.cancel()
            try:
                await self._pacer
            except asyncio.CancelledError:
                pass
        for w in self.workers.values():
            if w.sender is not None:
                w.sender.cancel()
        if self._server is not None:
            self._server.close()
            # Divergence (a): close the open streams first, or
            # wait_closed() waits for peers that wait for us.
            for writer in list(self._streams):
                writer.close()
            await self._server.wait_closed()
        self.checkpoint()
        self.engine.journal.close()

    # -- pacer -----------------------------------------------------------
    async def _pace(self) -> None:
        cfg = self.cfg
        last_eps = last_ck = time.monotonic()
        while True:
            await asyncio.sleep(cfg.pace_wall)
            wall = time.monotonic()
            self.engine.advance()
            self.engine.sim.scheduler.on_wall_tick(wall, self.engine.sim._now)
            self._check_worker_deadlines(wall)
            self._drain_admission()
            if (
                cfg.eps_auto_every_wall > 0
                and wall - last_eps >= cfg.eps_auto_every_wall
            ):
                last_eps = wall
                self.engine.retune_epsilon()
            if (
                cfg.checkpoint_path
                and wall - last_ck >= cfg.checkpoint_every_wall
            ):
                last_ck = wall
                self.checkpoint()

    def _check_worker_deadlines(self, wall: float) -> None:
        for w in self.workers.values():
            if w.alive and wall - w.last_hb > self.cfg.worker_dead_wall:
                w.alive = False
                self.telemetry.counters["worker_crashes"] += 1
                self.engine.inject("crash", w.machine)

    def _drain_admission(self) -> None:
        for user, item in self.admission.drain(self.engine.live_jobs()):
            self._admit(user, item)

    def _admit(self, user: str, item: dict) -> int:
        spec = self.engine.submit(
            item["job"], user=user, tag=item.get("tag")
        )
        self.telemetry.note_job(spec)
        if item.get("tag") is not None:
            self.tags[item["tag"]] = spec.job_id
        return spec.job_id

    # -- connections -----------------------------------------------------
    async def _handle(self, reader, writer) -> None:
        self._streams.add(writer)
        try:
            while True:
                msg = await protocol.recv(reader)
                if msg is None:
                    return
                op = msg.get("op")
                if op == "register":
                    await self._worker_loop(msg, reader, writer)
                    return
                reply = await self._dispatch(op, msg, writer)
                if reply is not None:
                    await protocol.send(writer, reply)
        except (ConnectionError, asyncio.CancelledError):
            pass
        except Exception as exc:
            if not is_device_failure(exc):
                raise
            self._fail(exc)  # divergence (b): serve_forever re-raises it
        finally:
            self._streams.discard(writer)
            writer.close()

    async def _dispatch(self, op: str, msg: dict, writer) -> dict | None:
        if op == "submit":
            return self._op_submit(msg)
        if op == "job":
            return self._op_job(msg)
        if op == "status":
            return {"ok": True, **self.telemetry.snapshot(
                workers=self._worker_block())}
        if op == "telemetry":
            ticks = int(msg.get("ticks", 1))
            interval = float(msg.get("interval", 0.1))
            for i in range(ticks):
                if i:
                    await asyncio.sleep(interval)
                await protocol.send(
                    writer,
                    {"ok": True, "tick": i, **self.telemetry.snapshot(
                        workers=self._worker_block())},
                )
            return None
        if op == "wait":
            return await self._op_wait(msg)
        if op == "checkpoint":
            self.checkpoint()
            return {"ok": True}
        if op == "shutdown":
            self._stopping.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _op_submit(self, msg: dict) -> dict:
        user = str(msg.get("user", "anonymous"))
        tag = msg.get("tag")
        if tag is not None and tag in self.tags:
            self.telemetry.counters["deduped"] += 1
            known = self.tags[tag]
            if known == "queued":
                return {"ok": True, "decision": "queued", "job_id": None}
            return {"ok": True, "decision": "dedup", "job_id": known}
        item = {"job": msg.get("job", {}), "tag": tag}
        verdict = self.admission.offer(
            user, item, time.monotonic(), self.engine.live_jobs()
        )
        if verdict == "admit":
            return {
                "ok": True,
                "decision": "admit",
                "job_id": self._admit(user, item),
            }
        if verdict == "queued":
            self.telemetry.counters["queued"] += 1
            if tag is not None:
                self.tags[tag] = "queued"
            return {"ok": True, "decision": "queued", "job_id": None}
        self.telemetry.counters["rejected"] += 1
        return {"ok": False, "error": verdict}

    def _op_job(self, msg: dict) -> dict:
        jid = msg.get("job_id")
        res = self.engine.sim.result
        if jid in res.completion:
            return {"ok": True, "state": "done",
                    "completion_t": res.completion[jid]}
        if jid is not None and jid < self.engine.next_job_id:
            return {"ok": True, "state": "live"}
        return {"ok": False, "error": f"unknown job {jid!r}"}

    async def _op_wait(self, msg: dict) -> dict:
        jid = int(msg.get("job_id", -1))
        res = self.engine.sim.result
        if jid in res.completion:
            return {"ok": True, "state": "done",
                    "completion_t": res.completion[jid]}
        if jid >= self.engine.next_job_id:
            return {"ok": False, "error": f"unknown job {jid}"}
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(jid, []).append(fut)
        try:
            t = await asyncio.wait_for(fut, float(msg.get("timeout", 30.0)))
        except asyncio.TimeoutError:
            return {"ok": False, "error": "timeout"}
        return {"ok": True, "state": "done", "completion_t": t}

    # -- worker handling -------------------------------------------------
    def _worker_block(self) -> dict:
        return {
            str(m): {"alive": w.alive}
            for m, w in sorted(self.workers.items())
        }

    async def _worker_loop(self, register: dict, reader, writer) -> None:
        machine = int(register["machine"])
        if not 0 <= machine < self.engine.sim.spec.num_machines:
            await protocol.send(
                writer, {"ok": False, "error": f"unknown machine {machine}"}
            )
            return
        now = time.monotonic()
        prior = self.workers.get(machine)
        if prior is not None:
            if prior.sender is not None:
                prior.sender.cancel()
            if not prior.alive:
                # Rejoin after a declared death: journaled recover, and
                # the fault layer's readmission machinery takes it back.
                self.telemetry.counters["worker_rejoins"] += 1
                self.engine.inject("recover", machine)
        w = _Worker(machine=machine, queue=asyncio.Queue(), last_hb=now)
        w.sender = asyncio.ensure_future(self._worker_sender(w, writer))
        self.workers[machine] = w
        while True:
            msg = await protocol.recv(reader)
            if msg is None:
                break  # silence -> the deadline check declares the crash
            if msg.get("op") == "heartbeat":
                w.last_hb = time.monotonic()
            # task_done is advisory: engine completions are authoritative.

    async def _worker_sender(self, w: _Worker, writer) -> None:
        try:
            while True:
                msg = await w.queue.get()
                await protocol.send(writer, msg)
        except (asyncio.CancelledError, ConnectionError):
            pass


async def run_master(
    engine: LiveEngine,
    cfg: MasterConfig,
    *,
    ready_cb=None,
) -> Master:
    """Start a master and serve until shutdown; returns the master."""
    master = Master(engine, cfg)
    await master.start()
    if ready_cb is not None:
        ready_cb(master)
    await master.serve_forever()
    return master
