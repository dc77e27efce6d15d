"""LiveEngine: one Simulator driven by wall-clock time, journaled so a
twin replay reproduces it bit-for-bit.

Clock mapping
-------------
``virtual_now = v0 + (wall - w0) * time_scale``.  ``time_scale`` exists
so tests and smoke runs compress hours of simulated workload into
sub-second wall time; production would run at 1.0.  All *scheduling*
happens in virtual time — the wall clock only decides *when* the master
bothers to advance, and each advance that processes events is journaled
with its virtual barrier time, making the wall clock's jitter part of
the recorded history instead of a source of divergence.

Determinism contract (the twin property)
----------------------------------------
The engine touches its Simulator exclusively through four journaled
operations, in journal order:

1. ``run(until=T)``        <- ``{"event": "advance", "t": T}``
2. ``submit(job)``         <- a job line (repro-trace schema)
3. ``inject_fault(T,k,m)`` <- ``{"event": "crash"|"recover", ...}``
4. ``set_event_epsilon``   <- ``{"event": "eps", ...}``

:func:`replay_journal` makes the identical call sequence on a fresh
Simulator, so every heap push happens in the same relative order with
the same timestamps — completions, preemptions and fault handling are
bit-identical, and ``completion_fingerprint`` of live and twin match.
The advance lines are written *ahead* of the run (an advance is
journaled only when the heap holds an event at or before the barrier,
i.e. exactly when the run will do work): if the master dies mid-pass,
the restored engine replays the advance to completion instead of
losing it.

Device
------
Under the size-based disciplines (hfsp, srpt, las, psbs) the virtual
clusters' water-fill and projection run on ``device`` ("cuda" unless the
caller asks for "cpu"), on the backend that ``$REPRO_VC_BACKEND`` picks
in this process (:func:`repro_torch.core.vcluster.resolve_backend`).
Neither the device nor the backend enters the journal: the backends give
bit-identical schedules, so a journal replays to the same fingerprint on
either, and in either package.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import asdict

from repro_torch import resolve_device
from repro_torch.core import disciplines
from repro_torch.core.faults import FaultModel
from repro_torch.core.simulator import SimConfig, Simulator, auto_event_epsilon
from repro_torch.core.types import ClusterSpec, JobSpec
from repro_torch.scenarios.report import completion_fingerprint
from repro_torch.scenarios.trace import job_from_record
from repro_torch.service.journal import Journal, read_journal

#: Arrival-history window the auto-epsilon controller measures over.
EPS_HISTORY = 64


def live_fingerprint(sim: Simulator) -> int:
    """Order-insensitive completion-schedule fingerprint (the same
    reduction scenario reports record, shared so live, twin and offline
    runs compare directly)."""
    return completion_fingerprint(sim.result)


#: Scheduler kwargs a journal never holds: they belong to the process
#: that runs it, not to the session it records.
_PROCESS_KWARGS = ("vc_backend", "vc_device")


def _build_sim(meta: dict, device: str) -> Simulator:
    """Fresh Simulator from journal meta — shared by first boot, crash
    restore and the offline twin so all three are the same machine.
    ``device`` reaches the virtual clusters (``HFSPConfig.vc_device``)."""
    cluster = ClusterSpec(**meta["cluster"])
    scheduler = disciplines.build_scheduler(
        meta["policy"], cluster, vc_device=device,
        **meta.get("scheduler_kwargs", {})
    )
    return Simulator(
        cluster,
        scheduler,
        [],
        config=SimConfig(
            heartbeat=meta.get("heartbeat", 3.0),
            event_epsilon=meta.get("event_epsilon", 0.0),
            faults=FaultModel(external=True),
        ),
    )


def replay_journal(path, *, device: str = "cuda") -> Simulator:
    """Deterministic twin: drive a fresh Simulator through the recorded
    stimulus sequence and return it (fully advanced to the last
    journaled barrier).  Raises :class:`repro_torch.DeviceError` if
    ``device`` is CUDA and this process has none."""
    device = str(resolve_device(device))
    meta, entries = read_journal(path)
    sim = _build_sim(meta, device)
    for d in entries:
        ev = d.get("event")
        if ev is None:
            sim.submit(job_from_record(d))
        elif ev == "advance":
            sim.run(until=d["t"])
        elif ev in ("crash", "recover"):
            sim.inject_fault(d["t"], ev, d["machine"])
        elif ev == "eps":
            sim.set_event_epsilon(d["value"])
    return sim


class LiveEngine:
    """Wall-clock driver around one journaled Simulator."""

    def __init__(
        self,
        sim: Simulator,
        journal: Journal,
        *,
        time_scale: float = 1.0,
        v0: float = 0.0,
        next_job_id: int = 0,
        submitted: int = 0,
    ):
        self.sim = sim
        self.journal = journal
        self.time_scale = float(time_scale)
        self.v0 = float(v0)
        self.w0 = time.monotonic()
        self.next_job_id = next_job_id
        self.submitted = submitted
        #: Wall seconds per work-doing advance (scheduling passes +
        #: event mutation) — telemetry reports p50/p95/p99 of these.
        self.decision_latency_s: list[float] = []
        self._arrival_history: deque[float] = deque(maxlen=EPS_HISTORY)

    # -- construction ---------------------------------------------------
    @classmethod
    def create(
        cls,
        journal_path,
        policy: str,
        cluster: ClusterSpec,
        *,
        heartbeat: float = 3.0,
        event_epsilon: float | str = 0.0,
        time_scale: float = 1.0,
        scheduler_kwargs: dict | None = None,
        device: str = "cuda",
    ) -> "LiveEngine":
        """Fresh service: new journal, empty simulator.  A missing CUDA
        device raises :class:`repro_torch.DeviceError` before the journal
        is written."""
        device = str(resolve_device(device))
        bad = sorted(set(scheduler_kwargs or ()) & set(_PROCESS_KWARGS))
        if bad:
            raise ValueError(
                f"scheduler_kwargs {bad} are not journaled: the device is "
                "the device argument, the backend $REPRO_VC_BACKEND"
            )
        eps0 = 0.0 if event_epsilon == "auto" else float(event_epsilon)
        meta = {
            "policy": policy,
            "cluster": asdict(cluster),
            "heartbeat": heartbeat,
            "event_epsilon": eps0,
            "time_scale": time_scale,
        }
        if scheduler_kwargs:
            meta["scheduler_kwargs"] = dict(scheduler_kwargs)
        journal = Journal(journal_path, meta=meta)
        return cls(_build_sim(meta, device), journal, time_scale=time_scale)

    @classmethod
    def restore(
        cls, journal_path, *, time_scale: float | None = None,
        device: str = "cuda",
    ) -> "LiveEngine":
        """Crash restore: replay the (repaired) journal into a fresh
        simulator and resume the virtual clock at the recorded
        high-water mark.

        Scheduler and estimator state need no snapshot of their own —
        the journal *is* the checkpoint (log-structured): replaying it
        reconstructs every internal table bit-identically, which is the
        same property the twin tests assert.  A missing CUDA device
        raises :class:`repro_torch.DeviceError` before the journal is
        opened.
        """
        device = str(resolve_device(device))
        journal = Journal(journal_path)  # repairs any torn tail
        meta, entries = read_journal(journal_path)
        sim = _build_sim(meta, device)
        hwm = 0.0
        next_id = 0
        submitted = 0
        arrivals = deque(maxlen=EPS_HISTORY)
        for d in entries:
            ev = d.get("event")
            if ev is None:
                sim.submit(job_from_record(d))
                hwm = max(hwm, d["arrival_time"])
                next_id = max(next_id, int(d["job_id"]) + 1)
                submitted += 1
                arrivals.append(float(d["arrival_time"]))
            elif ev == "advance":
                sim.run(until=d["t"])
                hwm = max(hwm, d["t"])
            elif ev in ("crash", "recover"):
                sim.inject_fault(d["t"], ev, d["machine"])
                hwm = max(hwm, d["t"])
            elif ev == "eps":
                sim.set_event_epsilon(d["value"])
        eng = cls(
            sim,
            journal,
            time_scale=(
                time_scale if time_scale is not None
                else meta.get("time_scale", 1.0)
            ),
            v0=hwm,
            next_job_id=next_id,
            submitted=submitted,
        )
        eng._arrival_history = arrivals
        return eng

    # -- clock ----------------------------------------------------------
    def virtual_now(self) -> float:
        return self.v0 + (time.monotonic() - self.w0) * self.time_scale

    # -- journaled operations -------------------------------------------
    def advance(self, v: float | None = None) -> bool:
        """Catch the simulator up to virtual time ``v`` (default: now).

        Journals the barrier (write-ahead) only when the heap holds an
        event due by ``v`` — idle ticks leave no trace, so the journal
        records history, not the pacer's polling rate.  Returns whether
        work was done.
        """
        if v is None:
            v = self.virtual_now()
        heap = self.sim._heap
        if not (heap and heap[0][0] <= v):
            return False
        self.journal.append_event({"event": "advance", "t": v})
        t0 = time.perf_counter()
        self.sim.run(until=v)
        self.decision_latency_s.append(time.perf_counter() - t0)
        return True

    def submit(
        self, payload: dict, *, user: str | None = None, tag: str | None = None
    ) -> JobSpec:
        """Admit one job now: assign id + arrival time, journal, inject."""
        v = self.virtual_now()
        self.advance(v)
        rec = dict(payload)
        rec["job_id"] = self.next_job_id
        rec["arrival_time"] = v
        spec = job_from_record(rec)
        self.journal.append_job(spec, user=user, tag=tag)
        self.next_job_id += 1
        self.submitted += 1
        self._arrival_history.append(v)
        self.sim.submit(spec)
        return spec

    def inject(self, kind: str, machine: int) -> float:
        """Scripted fault now (worker death -> crash, rejoin -> recover)."""
        v = self.virtual_now()
        self.advance(v)
        self.journal.append_event({"event": kind, "t": v, "machine": machine})
        self.sim.inject_fault(v, kind, machine)
        return v

    def retune_epsilon(self) -> float:
        """Auto-epsilon controller: re-derive the coalescing window from
        recent arrival burstiness; journal the retune iff it changed."""
        v = self.virtual_now()
        self.advance(v)
        eps = auto_event_epsilon(list(self._arrival_history), self.sim.heartbeat)
        if eps != self.sim.event_epsilon:
            self.journal.append_event({"event": "eps", "t": v, "value": eps})
            self.sim.set_event_epsilon(eps)
        return eps

    # -- observability ---------------------------------------------------
    def live_jobs(self) -> int:
        """Jobs submitted but not yet complete (admission backpressure)."""
        return self.submitted - len(self.sim.result.completion)

    def fingerprint(self) -> int:
        return live_fingerprint(self.sim)
