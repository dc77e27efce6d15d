"""The port's live service (repro_torch.service) against the reference's
(repro.service), on the CPU (``device="cpu"``).

* protocol frames are byte-equal to ``repro.service.protocol.encode``;
* one scripted session (jobs with user and tag, advance barriers, a
  crash, a recover, an epsilon retune) written through both packages'
  ``Journal`` gives the same bytes, and the torn-tail repair leaves the
  same bytes;
* each package's ``replay_journal`` of that journal gives the same
  fingerprint and completions for fifo, hfsp and psbs, the port's with
  numpy and with torch virtual clusters;
* a live session in-process (2 machines, 16 jobs, machine 1's worker
  killed and rejoined, as reference tests/test_service.py runs it) for
  fifo, hfsp and psbs with torch virtual clusters: the port's twin (numpy
  virtual clusters) and the reference's ``replay_journal`` of the port's
  journal both equal the live fingerprint and completions;
* the master's three divergences: ``Master.stop()`` returns with worker
  connections open; an engine failure ends ``serve_forever`` with that
  error (a ``KernelError`` in the pacer, a ``DeviceError`` in a request
  handler); a submit frame longer than asyncio's 64 KiB line limit (a
  3000-task job, as the paper's FB workload holds) is taken; over the CLI, a ``shutdown`` ends a master whose
  client and workers are still connected, and ``--device cuda`` without a
  card exits 1 before anything is written;
* admission decisions and drains equal the reference's for the same
  offers; telemetry snapshots of each package's restore of one journal
  are equal (decision latency aside); the device and the backend never
  reach a journal.

Every asyncio session runs under ``asyncio.wait_for(..., SESSION_S)`` and
every subprocess under a timeout, so a hang fails a test instead of
holding the run.  The reference's master is never started: its
``stop()`` does not return on Python >= 3.12.1 while workers are
connected (repro/service/master.py:201-202).
"""

import asyncio
import json
import os
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro.scenarios.trace import job_from_record as ref_job_from_record
from repro.service import admission as ref_admission
from repro.service import engine as ref_engine
from repro.service import journal as ref_journal
from repro.service import master as ref_master
from repro.service import protocol as ref_protocol
from repro_torch import DeviceError, KernelError
from repro_torch.core import vcluster_torch
from repro_torch.core.types import ClusterSpec
from repro_torch.scenarios.trace import job_from_record, load_trace
from repro_torch.service import (
    AdmissionConfig,
    AdmissionControl,
    Journal,
    LiveEngine,
    Master,
    MasterConfig,
    WorkerAgent,
    live_fingerprint,
    read_journal,
    replay_journal,
)
from repro_torch.service import protocol
from repro_torch.service.protocol import ServiceClient

SRC = Path(__file__).resolve().parents[1] / "src"
POLICIES = ("fifo", "hfsp", "psbs")
CLUSTER = dict(
    num_machines=2, map_slots_per_machine=2, reduce_slots_per_machine=1
)
#: 1 wall ms = 1 virtual second, as in the reference's tests.
TIME_SCALE = 1000.0
#: Wall bound of every asyncio session of this file.
SESSION_S = 30.0


def mk_job(i: int, scale: float = 1.0) -> dict:
    """The reference test's deterministic job payload (trace schema)."""
    return {
        "name": f"job-{i}",
        "map": [[scale * (20.0 + 7.0 * ((i + k) % 5)), [], 0]
                for k in range(2 + i % 3)],
        "reduce": [[scale * 15.0, [], 0]] if i % 2 else [],
        "weight": 1.0,
        "reduce_slowstart": 1.0,
    }


def meta(policy: str) -> dict:
    return {"policy": policy, "cluster": dict(CLUSTER), "heartbeat": 3.0,
            "event_epsilon": 0.0, "time_scale": 1.0}


def stimuli() -> list:
    """A scripted session in journal order: ("job", record, user, tag)
    or ("event", event).  Machine 1 crashes at 85 s and recovers at 187."""
    out = []
    for i in range(12):
        t = 25.0 * i
        out.append(("job", dict(mk_job(i), job_id=i, arrival_time=t),
                    f"u{i % 3}", f"tag-{i}"))
        out.append(("event", {"event": "advance", "t": t + 10.0}))
        if i == 3:
            out.append(("event", {"event": "crash", "t": t + 10.0,
                                  "machine": 1}))
        if i == 5:
            out.append(("event", {"event": "eps", "t": t + 10.0,
                                  "value": 0.5}))
        if i == 7:
            out.append(("event", {"event": "recover", "t": t + 12.0,
                                  "machine": 1}))
    out.append(("event", {"event": "advance", "t": 1e6}))
    return out


def write_journal(path: Path, policy: str, journal_cls, from_record) -> Path:
    j = journal_cls(path, meta=meta(policy))
    for kind, *rest in stimuli():
        if kind == "job":
            rec, user, tag = rest
            j.append_job(from_record(rec), user=user, tag=tag)
        else:
            j.append_event(rest[0])
    j.close()
    return path


@pytest.fixture
def scripted(tmp_path):
    """policy -> the scripted journal written by the port."""
    return lambda policy: write_journal(
        tmp_path / f"{policy}.jsonl", policy, Journal, job_from_record)


def run_session(coro):
    return asyncio.run(asyncio.wait_for(coro, SESSION_S))


def twin_of(sim) -> tuple[int, dict]:
    return live_fingerprint(sim), dict(sim.result.completion)


# ---------------------------------------------------------------------------
# Protocol and journal bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("msg", [
    {"op": "submit", "user": "alice", "tag": "t-1", "job": mk_job(3)},
    {"op": "launch", "key": [4, "map", 2], "machine": 7, "wall_s": 0.125},
    {"z": 1.0e-300, "a": [float("inf"), -0.0, 1 / 3], "u": "naïve ✓"},
    {"ok": False, "error": "reject-rate"},
])
def test_protocol_frames_are_the_references(msg):
    frame = protocol.encode(msg)
    assert frame == ref_protocol.encode(msg)
    assert frame.endswith(b"\n") and frame.count(b"\n") == 1
    assert protocol.decode(frame) == ref_protocol.decode(frame)
    assert protocol.MAX_LINE == ref_protocol.MAX_LINE


@pytest.mark.parametrize("policy", POLICIES)
def test_journal_bytes_equal_the_references(tmp_path, policy):
    ours = write_journal(tmp_path / "ours.jsonl", policy, Journal,
                         job_from_record)
    theirs = write_journal(tmp_path / "theirs.jsonl", policy,
                           ref_journal.Journal, ref_job_from_record)
    assert ours.read_bytes() == theirs.read_bytes()
    assert read_journal(ours) == ref_journal.read_journal(theirs)
    assert read_journal(ours)[1][0]["user"] == "u0"


@pytest.mark.parametrize("torn", [
    '{"event": "crash", "t": 2.0, "mach',      # no newline
    '{"event": "adva\n',                       # a whole line, torn inside
    '{"event": "advance", "t": 9}\n{"ev',      # a good line, then a torn one
])
def test_torn_tail_repair_leaves_the_references_bytes(scripted, tmp_path,
                                                      torn):
    src = scripted("hfsp")
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    for path in (ours, theirs):
        shutil.copy(src, path)
        with open(path, "a") as f:
            f.write(torn)
    assert read_journal(ours) == ref_journal.read_journal(theirs)
    for cls, path in ((Journal, ours), (ref_journal.Journal, theirs)):
        j = cls(path)  # reopening repairs the tail
        j.append_event({"event": "advance", "t": 2e6})
        j.close()
    assert ours.read_bytes() == theirs.read_bytes()
    assert read_journal(ours)[1][-1] == {"event": "advance", "t": 2e6}


# ---------------------------------------------------------------------------
# Cross-package replay
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
def test_each_package_replays_the_others_journal(scripted, tmp_path,
                                                 monkeypatch, policy):
    ours = scripted(policy)
    theirs = write_journal(tmp_path / "theirs.jsonl", policy,
                           ref_journal.Journal, ref_job_from_record)
    want = twin_of(ref_engine.replay_journal(ours))
    assert len(want[1]) == 12
    assert twin_of(ref_engine.replay_journal(theirs)) == want
    monkeypatch.delenv("REPRO_VC_BACKEND", raising=False)
    assert twin_of(replay_journal(theirs, device="cpu")) == want
    monkeypatch.setenv("REPRO_VC_BACKEND", "torch")
    assert twin_of(replay_journal(theirs, device="cpu")) == want
    assert twin_of(replay_journal(ours, device="cpu")) == want


# ---------------------------------------------------------------------------
# Live sessions
# ---------------------------------------------------------------------------
async def boot(tmp_path, policy, **cfg_kw):
    engine = LiveEngine.create(
        tmp_path / "live.jsonl", policy, ClusterSpec(**CLUSTER),
        time_scale=TIME_SCALE, device="cpu",
    )
    cfg_kw.setdefault("pace_wall", 0.005)
    cfg_kw.setdefault("worker_dead_wall", 0.15)
    master = Master(engine, MasterConfig(**cfg_kw))
    await master.start()
    workers = []
    for m in range(CLUSTER["num_machines"]):
        w = WorkerAgent("127.0.0.1", master.port, m, heartbeat_wall=0.03)
        await w.start()
        workers.append(w)
    return engine, master, workers


def client_submit(port: int, jobs: list[dict], user="u0") -> list[int]:
    with ServiceClient("127.0.0.1", port) as c:
        out = []
        for i, job in enumerate(jobs):
            r = c.call({"op": "submit", "user": user,
                        "tag": f"{user}-{i}", "job": job})
            assert r["ok"], r
            out.append(r["job_id"])
        return out


async def wait_until(cond, what: str, timeout: float = 10.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what} not within {timeout} s")
        await asyncio.sleep(0.01)


@pytest.mark.parametrize("policy", POLICIES)
def test_live_session_replays_in_both_packages(tmp_path, monkeypatch,
                                               policy):
    """Reference test_service.py's live session over the port, with the
    torch virtual clusters on the CPU: a worker dies mid-task and
    rejoins; the port's twin and the reference's replay of the journal
    give the live fingerprint."""
    monkeypatch.setenv("REPRO_VC_BACKEND", "torch")
    calls = vcluster_torch.calls
    calls.update(water_fill=0, project=0)

    async def session():
        engine, master, workers = await boot(tmp_path, policy)
        loop = asyncio.get_running_loop()
        jobs = [mk_job(i, scale=3.0) for i in range(16)]
        await loop.run_in_executor(None, client_submit, master.port, jobs)
        completion = engine.sim.result.completion
        await wait_until(lambda: len(completion) >= 2, "2 completions")
        await workers[1].die()
        counters = master.telemetry.counters
        await wait_until(lambda: counters["worker_crashes"] > 0, "crash")
        w = WorkerAgent("127.0.0.1", master.port, 1, heartbeat_wall=0.03)
        await w.start()
        await wait_until(lambda: counters["worker_rejoins"] > 0, "rejoin")
        await wait_until(lambda: len(completion) >= 16, "16 completions")
        live = twin_of(engine.sim)
        await master.stop()
        for wk in (w, *workers):
            await wk.die()
        return live

    live = run_session(session())
    assert len(live[1]) == 16
    # The size-based disciplines' virtual clusters ran on the torch side.
    assert (min(calls.values()) > 0) == (policy != "fifo"), calls
    path = tmp_path / "live.jsonl"
    monkeypatch.delenv("REPRO_VC_BACKEND")  # the reference knows no torch
    assert twin_of(ref_engine.replay_journal(path)) == live
    assert twin_of(replay_journal(path, device="cpu")) == live
    _, entries = read_journal(path)
    kinds = {e.get("event") for e in entries}
    assert {"advance", "crash", "recover"} <= kinds
    # The journal is a plain trace too, and names no device or backend.
    jobs, _, journal_meta = load_trace(path)
    assert len(jobs) == 16 and journal_meta["journal"] is True
    text = path.read_text()
    for word in ("cpu", "cuda", "torch", "numpy", "device", "vc_backend"):
        assert word not in text, word


def test_master_stop_returns_with_workers_connected(tmp_path):
    """Divergence (a): with two worker connections open, stop() returns
    (the reference's waits for them on Python >= 3.12.1)."""

    async def session():
        engine, master, workers = await boot(tmp_path, "fifo")
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            None, client_submit, master.port, [mk_job(i) for i in range(3)])
        await wait_until(lambda: len(master.workers) == 2, "registration")
        t0 = time.monotonic()
        await asyncio.wait_for(master.stop(), 5.0)
        stopped_s = time.monotonic() - t0
        for w in workers:
            await w.die()
        return stopped_s, engine.journal._f.closed

    stopped_s, journal_closed = run_session(session())
    assert stopped_s < 5.0 and journal_closed
    _, entries = read_journal(tmp_path / "live.jsonl")
    assert sum("event" not in e for e in entries) == 3


@pytest.mark.parametrize("where,error", [("pacer", KernelError),
                                         ("handler", DeviceError)])
def test_engine_failure_ends_serve_forever(tmp_path, where, error):
    """Divergence (b): a failing engine stops the master and
    serve_forever raises the failure."""

    async def session():
        engine, master, workers = await boot(tmp_path, "hfsp")

        def fail(*args, **kwargs):
            raise error(f"injected in the {where}")

        client = None
        if where == "pacer":
            engine.advance = fail
        else:
            engine.submit = fail
            client = asyncio.get_running_loop().run_in_executor(
                None, submit_expecting_close, master.port)
        try:
            with pytest.raises(error, match=f"injected in the {where}"):
                await asyncio.wait_for(master.serve_forever(), 5.0)
            if client is not None:
                await client
        finally:
            for w in workers:
                await w.die()
        return master, engine

    master, engine = run_session(session())
    assert isinstance(master.failure, error)
    assert engine.journal._f.closed


def test_master_takes_frames_up_to_max_line(tmp_path):
    """Divergence (c): a job of 3000 tasks (a frame of ~100 KB; the
    paper's largest FB jobs make 137 KB) is admitted over the wire."""
    big = dict(mk_job(0), map=[[5.0 + k / 7, [k % 2, (k + 1) % 2], 0]
                               for k in range(3000)])
    frame = protocol.encode({"op": "submit", "user": "u0", "job": big})
    assert 1 << 16 < len(frame) < protocol.MAX_LINE

    async def session():
        engine, master, workers = await boot(tmp_path, "fifo")
        loop = asyncio.get_running_loop()
        ids = await loop.run_in_executor(None, client_submit, master.port,
                                         [big, mk_job(1)])
        await master.stop()
        for w in workers:
            await w.die()
        return ids

    assert run_session(session()) == [0, 1]
    _, entries = read_journal(tmp_path / "live.jsonl")
    assert len(entries[0]["map"]) == 3000


def submit_expecting_close(port: int) -> None:
    with ServiceClient("127.0.0.1", port, timeout=5.0) as c:
        with pytest.raises(ConnectionError):
            c.call({"op": "submit", "user": "u0", "job": mk_job(0)})


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def service_cli(*args: str, **kw) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", *args],
        env={**os.environ, "PYTHONPATH": str(SRC)}, text=True, **kw)


def test_cli_shutdown_ends_a_master_with_connections_open(tmp_path):
    """A ``shutdown`` ends ``python -m repro_torch.service master`` with a
    client and two worker processes still connected, and ``replay``
    prints the reference CLI's JSON for the journal."""
    journal = tmp_path / "live.jsonl"
    procs = [service_cli(
        "master", "--journal", str(journal), "--device", "cpu",
        "--machines", "2", "--map-slots", "2", "--reduce-slots", "1",
        "--time-scale", str(TIME_SCALE), stdout=subprocess.PIPE)]
    try:
        port = int(procs[0].stdout.readline().split()[1])
        procs += [service_cli("worker", "--connect", f"127.0.0.1:{port}",
                              "--machine", str(m)) for m in (0, 1)]
        with ServiceClient("127.0.0.1", port) as c:
            t0 = time.monotonic()
            while len(c.call({"op": "status"})["workers"]) < 2:
                assert time.monotonic() - t0 < 20.0, "workers never came"
                time.sleep(0.05)
            for i in range(4):
                assert c.call({"op": "submit", "user": "u0", "tag": f"t{i}",
                               "job": mk_job(i)})["ok"]
            t0 = time.monotonic()
            while c.call({"op": "status"})["jobs"]["completed"] < 4:
                assert time.monotonic() - t0 < 20.0
                time.sleep(0.05)
            assert c.call({"op": "shutdown"}) == {"ok": True}
            assert procs[0].wait(timeout=20) == 0
        for p in procs[1:]:
            assert p.wait(timeout=20) == 0
    finally:
        for p in procs:
            p.kill()
            p.communicate(timeout=20)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    printed = [json.loads(subprocess.run(
        [sys.executable, "-m", pkg, "replay", "--journal", str(journal),
         *extra], env=env, capture_output=True, text=True, check=True,
        timeout=60).stdout) for pkg, extra in (
            ("repro_torch.service", ("--device", "cpu")),
            ("repro.service", ()))]
    assert printed[0] == printed[1]
    assert printed[0]["jobs_completed"] == 4


@pytest.mark.parametrize("cmd", ["master", "replay"])
def test_cli_without_the_card_exits_1_and_writes_nothing(scripted, tmp_path,
                                                         cmd):
    journal = (tmp_path / "new.jsonl" if cmd == "master"
               else scripted("hfsp"))
    before = journal.read_bytes() if journal.exists() else None
    proc = service_cli(cmd, "--journal", str(journal), "--device", "cuda",
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 1
    assert "LISTENING" not in out and out == ""
    assert "DeviceError" in err and "torch.cuda.is_available() is False" in err
    assert (journal.read_bytes() if journal.exists() else None) == before


def test_engine_entry_points_check_the_device_first(scripted, tmp_path):
    path = tmp_path / "never.jsonl"
    cluster = ClusterSpec(**CLUSTER)
    with pytest.raises(DeviceError):
        LiveEngine.create(path, "hfsp", cluster)
    with pytest.raises(ValueError, match="not journaled"):
        LiveEngine.create(path, "hfsp", cluster, device="cpu",
                          scheduler_kwargs={"vc_backend": "torch"})
    assert not path.exists()
    journal = scripted("hfsp")
    before = journal.read_bytes()
    with pytest.raises(DeviceError):
        LiveEngine.restore(journal)
    with pytest.raises(DeviceError):
        replay_journal(journal)
    assert journal.read_bytes() == before


# ---------------------------------------------------------------------------
# Admission and telemetry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(max_live_jobs=2, rate_limit=10.0, burst=3, max_queue_per_user=2),
    dict(max_live_jobs=4, rate_limit=None, burst=8, max_queue_per_user=3),
    dict(max_live_jobs=3, rate_limit=2.5, burst=1, max_queue_per_user=256),
])
def test_admission_equals_the_references(cfg):
    rng = random.Random(2013)
    ours = AdmissionControl(AdmissionConfig(**cfg))
    theirs = ref_admission.AdmissionControl(
        ref_admission.AdmissionConfig(**cfg))
    wall, live = 0.0, 0
    for n in range(400):
        wall += rng.choice((0.0, 0.01, 0.1, 0.5))
        if rng.random() < 0.7:
            user, item = f"u{rng.randrange(4)}", f"job-{n}"
            got = ours.offer(user, item, wall, live)
            assert got == theirs.offer(user, item, wall, live), n
            live += got == "admit"
        else:
            live = max(0, live - rng.randrange(3))
            got = ours.drain(live)
            assert got == theirs.drain(live), n
            live += len(got)
        assert ours.queued_items() == theirs.queued_items()
        assert ours.queued_count() == theirs.queued_count()
    ours.requeue({"u9": ["x", "y"]})
    theirs.requeue({"u9": ["x", "y"]})
    assert ours.drain(0) == theirs.drain(0)


@pytest.mark.parametrize("policy", POLICIES)
def test_telemetry_of_restored_journals_is_equal(scripted, tmp_path, policy):
    src = scripted(policy)
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    shutil.copy(src, ours)
    shutil.copy(src, theirs)
    # time_scale 0 holds the virtual clock at the journal's high-water
    # mark, so the snapshots' v_now compare too.
    ours_eng = LiveEngine.restore(ours, time_scale=0.0, device="cpu")
    theirs_eng = ref_engine.LiveEngine.restore(theirs, time_scale=0.0)
    snaps = []
    for eng, master_cls in ((ours_eng, Master),
                            (theirs_eng, ref_master.Master)):
        master = master_cls(eng)
        snap = master.telemetry.snapshot()
        snap.pop("decision_latency_ms")
        snaps.append((snap, master.tags, eng.next_job_id, eng.submitted,
                      eng.v0))
        eng.journal.close()
    assert snaps[0] == snaps[1]
    assert snaps[0][0]["jobs"]["completed"] == 12
    assert ours.read_bytes() == src.read_bytes() == theirs.read_bytes()
