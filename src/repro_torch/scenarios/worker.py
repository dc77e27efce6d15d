"""Distributed sweep worker: lease-claiming cell executor.

A copy of ``repro.scenarios.worker``.  ``run_worker`` is the standalone
counterpart of the local self-healing supervisor in
:mod:`repro_torch.scenarios.sweep` — any number of workers on any number
of machines point at one shared store
(``python -m repro_torch.scenarios worker <preset> --store ...``) and the
sweep converges exactly-once:

1. **claim** — pick the first pending cell (deterministic spec order)
   not covered by a live foreign lease and claim it with a TTL'd lease
   row; losing a claim race just moves on to the next cell.
2. **compute** — run the cell in a spawned per-attempt process with the
   self-healing semantics of the local supervisor: per-attempt
   wall-clock ``timeout`` kill, bounded retry with capped exponential
   backoff, quarantine record past the retry budget.  The lease is
   renewed every ``renew_every`` seconds while the attempt runs (and
   across retry backoffs), so only a *dead* worker's lease expires.
3. **store** — append the result; a duplicate (some other worker won a
   race on this cell) is detected by the store, dropped, and counted.
   Then release the lease.
4. **converge** — loop until every cell of the sweep is stored.  With
   cells left but nothing claimable (live foreign leases), idle-poll;
   workers heartbeat each loop so ``sweep-status`` can report liveness.

A SIGKILLed worker stops renewing; once its lease TTL passes, any other
worker's claim takes the cell over (a counted *reissue*).  The attempt
child it may have left behind is harmless: results are only appended by
worker loops, and an orphaned child dies on its broken result pipe.

The port adds ``device``: where every cell's kernels run (``"cuda"``
unless the caller asks for ``"cpu"``).  It reaches each spawned attempt
as an argument and never enters a spec dict or a store record.  Unlike
the reference, a failure of the card or of a kernel of the port
(:func:`repro_torch.is_device_failure`: a missing device, a failed
``nvcc`` build, a failed launch) is never retried, quarantined or
demoted to the Python path: it releases the worker's leases and raises,
so the run ends non-zero and a cell is never recorded as poison for a
fault of the machine.

This module also owns the per-attempt primitives (spawned process entry
point, test-fault hooks, quarantine record) shared with the local
supervisor — attempts use the ``spawn`` start method because the parent
holds CUDA state, which does not survive ``fork``.
"""

from __future__ import annotations

import json
import os
import socket
import time
from pathlib import Path

from repro_torch import (
    DeviceError,
    KernelError,
    is_device_failure,
    resolve_device,
)
from repro_torch.scenarios.lease import DEFAULT_TTL, LeaseKeeper
from repro_torch.scenarios.runner import run_scenario
from repro_torch.scenarios.spec import ScenarioSpec, SweepSpec
from repro_torch.scenarios.store import SweepStore, open_store

#: Env var naming a JSON file of test-only worker fault hooks —
#: ``{"hang_once": [cell_ids], "fail_always": [cell_ids], "kernel_error":
#: [cell_ids], "slow_once": {"cells": [...] | "*", "seconds": s},
#: "launch_counts": bool, "state_dir": path}`` — read inside the
#: *spawned* attempt process (a spawn child cannot see parent
#: monkeypatches, so the self-healing and chaos tests inject
#: hangs/failures/delays through the environment instead).
#: ``kernel_error`` raises the port's :class:`KernelError`, as a failed
#: build or launch would.  ``launch_counts`` writes each attempt's kernel
#: launches and virtual-cluster calls to ``state_dir`` (see
#: :func:`_record_launches`), the counters dying with the process.
_TEST_HOOK_ENV = "_REPRO_SWEEP_TEST_HOOK"

#: The kernels a cell can launch: K1 (the accel batch and the virtual
#: clusters' water-fill) and the virtual clusters' projection.
_CELL_KERNELS = ("waterfill", "project")


def _quarantine_record(cid: str, error: str, attempts: int) -> dict:
    """The poison-cell record stored in place of a scenario report."""
    return {
        "quarantined": True,
        "cell_id": cid,
        "error": error,
        "attempts": attempts,
    }


def prebuild_kernels(device) -> None:
    """Resolve ``device`` (raises without CUDA when asked for it) and, on
    a CUDA device, build the kernels a cell can launch before any cell is
    claimed: a cold ``nvcc`` can outlast a lease's TTL, and spawned
    attempts then load the libraries instead of each compiling them."""
    if resolve_device(device).type == "cuda":
        from repro_torch import _build

        _build.build_all(_CELL_KERNELS)


def _run_cell(payload: tuple[str, dict], device: str) -> tuple[str, dict]:
    """Compute one cell from its serialized spec."""
    cid, spec_dict = payload
    return cid, run_scenario(ScenarioSpec.from_dict(spec_dict), device=device)


def _test_hook() -> dict:
    path = os.environ.get(_TEST_HOOK_ENV)
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


def _apply_test_hook(cid: str, hook: dict) -> None:
    if cid in hook.get("fail_always", ()):
        raise RuntimeError(f"sweep test hook: cell {cid!r} fails")
    if cid in hook.get("kernel_error", ()):
        raise KernelError(f"sweep test hook: cell {cid!r}'s kernel fails")
    if cid in hook.get("hang_once", ()):
        marker = Path(hook["state_dir"]) / f"hung-{cid}"
        if not marker.exists():
            marker.write_text("hung once\n")
            time.sleep(3600.0)  # until the supervisor's timeout kills us
    slow = hook.get("slow_once") or {}
    cells = slow.get("cells", ())
    if cells == "*" or cid in cells:
        # First attempt of the cell sleeps (stretching the SIGKILL
        # window for chaos tests); reclaimed attempts run at full speed.
        marker = Path(hook["state_dir"]) / f"slow-{cid}"
        if not marker.exists():
            marker.write_text("slowed once\n")
            time.sleep(float(slow.get("seconds", 1.0)))


def _record_launches(cid: str, state_dir: str) -> None:
    """Write this attempt's K1 and projection launches and the virtual
    clusters' calls at the ``vcluster_torch`` entry points to
    ``state_dir/launches-<pid>.json`` (an attempt is a process of its
    own)."""
    from repro_torch.accel import waterfill
    from repro_torch.core import projection, vcluster_torch

    counts = {"cell_id": cid,
              "k1_launches": waterfill.launches,
              "project_launches": projection.launches,
              "water_fill_calls": vcluster_torch.calls["water_fill"],
              "project_calls": vcluster_torch.calls["project"]}
    out = Path(state_dir) / f"launches-{os.getpid()}.json"
    out.write_text(json.dumps(counts) + "\n")


def _cell_worker(conn, cid: str, spec_dict: dict, device: str) -> None:
    """Spawned per-attempt process entry point: compute the cell, send
    ("ok", report), ("err", repr) or, for a failure of the card or a
    kernel, ("fatal", repr) back over the pipe."""
    try:
        hook = _test_hook()
        _apply_test_hook(cid, hook)
        _, result = _run_cell((cid, spec_dict), device)
        if hook.get("launch_counts"):
            _record_launches(cid, hook["state_dir"])
        conn.send(("ok", result))
    except BaseException as e:  # noqa: BLE001 - reported to the supervisor
        try:
            conn.send(("fatal" if is_device_failure(e) else "err", repr(e)))
        except Exception:
            pass
    finally:
        conn.close()


def attempt_failed_on_device(cid: str, error: str) -> DeviceError:
    """The error a supervisor raises for an attempt that reported a
    failure of the card or of a kernel."""
    return DeviceError(f"cell {cid!r} failed on the device: {error}")


def default_worker_id() -> str:
    """hostname-pid: unique per worker loop across a shared filesystem."""
    return f"{socket.gethostname()}-{os.getpid()}"


def _attempt_once(
    cid: str, spec_dict: dict, timeout: float | None, on_tick=None,
    device: str = "cuda",
) -> tuple[str, object]:
    """One supervised spawned attempt; returns ("ok", report) or
    ("err", reason), and raises if the attempt failed on the device.
    ``on_tick`` runs every poll interval (the worker renews its lease
    there)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe(duplex=False)
    proc = ctx.Process(
        target=_cell_worker, args=(child_conn, cid, spec_dict, device),
        daemon=True,
    )
    proc.start()
    child_conn.close()
    started = time.monotonic()
    try:
        while True:
            if parent_conn.poll(0.1):
                try:
                    msg = parent_conn.recv()
                except (EOFError, OSError):
                    msg = ("err", "worker process died without sending a result")
                break
            if (
                timeout is not None
                and time.monotonic() - started > timeout
            ):
                msg = ("err", f"timeout: exceeded {timeout}s wall clock")
                break
            if on_tick is not None:
                on_tick()
    finally:
        parent_conn.close()
        if proc.is_alive():
            proc.terminate()
            proc.join(5.0)
            if proc.is_alive():  # pragma: no cover - hard hang
                proc.kill()
        proc.join(5.0)
    if msg[0] == "fatal":
        raise attempt_failed_on_device(cid, msg[1])
    return msg


def _compute_with_retries(
    cid: str,
    spec: ScenarioSpec,
    keeper: LeaseKeeper,
    *,
    timeout: float | None,
    max_retries: int,
    retry_backoff: float,
    device: str,
) -> dict:
    """The supervisor's self-healing semantics around ``_attempt_once``:
    bounded retry with capped exponential backoff, quarantine past the
    budget.  The lease keeper ticks through attempts *and* backoff
    sleeps."""
    spec_dict = spec.to_dict()
    n_fails = 0
    while True:
        kind, payload = _attempt_once(cid, spec_dict, timeout, keeper.tick,
                                      device)
        if kind == "ok":
            return payload
        n_fails += 1
        if n_fails > max_retries:
            return _quarantine_record(cid, str(payload), n_fails)
        deadline = time.monotonic() + retry_backoff * (2.0 ** (n_fails - 1))
        while time.monotonic() < deadline:
            keeper.tick()
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))


def _accel_fit(spec: ScenarioSpec) -> tuple[dict | None, str]:
    """Full accel-eligibility check for one cell: the spec-level gate
    plus its synthesis (a generator workload can still violate the fluid
    contract — unequal durations, non-uniform weights).  Returns the
    synthesized cell, which the batch then runs, or None and the
    reason."""
    from repro_torch.accel.sweep_exec import accel_eligible, synthesize_cell

    ok, reason = accel_eligible(spec)
    if not ok:
        return None, reason
    try:
        return synthesize_cell(spec), ""
    except ValueError as e:
        return None, str(e)


def run_worker(
    sweep: SweepSpec,
    store: SweepStore | str | Path,
    *,
    worker_id: str | None = None,
    ttl: float = DEFAULT_TTL,
    renew_every: float | None = None,
    timeout: float | None = 600.0,
    max_retries: int = 2,
    retry_backoff: float = 0.5,
    poll: float = 0.5,
    max_cells: int | None = None,
    deadline: float | None = None,
    progress=None,
    compute: str = "python",
    accel_batch: int = 32,
    device: str = "cuda",
) -> dict:
    """Run one worker loop against a shared store until the sweep
    converges (every cell stored) or ``max_cells``/``deadline`` stops it.

    ``ttl``/``renew_every`` shape the lease protocol (renew defaults to
    ttl/3); ``timeout``/``max_retries``/``retry_backoff`` are the local
    supervisor's self-healing knobs, unchanged; ``poll`` is the idle wait
    when every pending cell is covered by a live foreign lease;
    ``deadline`` bounds the loop's total wall clock (seconds) — on expiry
    the worker exits with ``"stalled": True`` instead of waiting forever
    on leases that other (possibly wedged) workers hold.  Returns a
    summary dict with the cells this worker computed and the store's
    coordination stats.

    ``compute="accel"`` drains cells through the batched accel executor
    (:mod:`repro_torch.accel.sweep_exec`) instead of spawned Python
    attempts: the worker claims up to ``accel_batch`` accel-eligible
    pending cells at once, runs them as one batch *in-process* on
    ``device`` (renewing all their leases between chunks), and appends
    each result under the usual exactly-once store rules.  Cells an accel
    worker cannot represent — fault injection, trace workloads, non-fluid
    generators — fall back to the unchanged per-cell spawned Python path,
    so a mixed sweep still converges; the fallback reasons are reported
    in the summary's ``"accel_fallbacks"``.  A cell whose synthesis
    raises ``ValueError`` is never claimed for a batch; a batch that the
    fluid model cannot finish in its chunk budget
    (:class:`~repro_torch.accel.cell_step.ChunkBudgetError`) demotes its
    cells to the Python path.  Any other error of a batch raises (module
    docstring).
    """
    if compute not in ("python", "accel"):
        raise ValueError(f"unknown compute {compute!r}")
    prebuild_kernels(device)
    store = open_store(store)
    wid = worker_id or default_worker_id()
    cells = sweep.expand()
    spec_of = dict(cells)
    hashes = {cid: spec.spec_hash() for cid, spec in cells}
    t_end = None if deadline is None else time.monotonic() + deadline
    summary = {
        "worker": wid,
        "computed": [],
        "duplicates_dropped": 0,
        "claims_lost": 0,
        "leases_lost": 0,
        "stalled": False,
    }
    # Cells the accel path cannot (or failed to) run this loop; they take
    # the spawned Python attempt path instead.  {cid: reason}.
    accel_unfit: dict[str, str] = {}
    if compute == "accel":
        summary["accel_cells"] = 0
        summary["accel_batches"] = 0
        summary["accel_fallbacks"] = accel_unfit

    def _finish_one(cid: str, result: dict) -> None:
        if not store.append(cid, hashes[cid], result):
            summary["duplicates_dropped"] += 1
        store.release(cid, hashes[cid], wid)
        summary["computed"].append(cid)
        if progress is not None:
            progress(cid, result)

    def _release_all(cids) -> None:
        for cid in cids:
            store.release(cid, hashes[cid], wid)

    def _try_accel_batch(todo: list[str], held, now: float) -> bool:
        """Claim + run one batch; True if any cell was computed."""
        from repro_torch.accel.cell_step import ChunkBudgetError
        from repro_torch.accel.sweep_exec import run_cells_accel

        budget = accel_batch
        if max_cells is not None:
            budget = min(budget, max_cells - len(summary["computed"]))
        got: list[str] = []
        synthesized: list[dict] = []
        for cid in todo:
            if len(got) >= budget:
                break
            if cid in accel_unfit:
                continue
            lease = held.get((cid, hashes[cid]))
            if lease is not None and lease.worker != wid and not lease.expired(now):
                continue
            cell, reason = _accel_fit(spec_of[cid])
            if cell is None:
                accel_unfit[cid] = reason
                continue
            if store.claim(cid, hashes[cid], wid, ttl):
                got.append(cid)
                synthesized.append(cell)
            else:
                summary["claims_lost"] += 1
        if not got:
            return False
        keepers = [
            LeaseKeeper(store, cid, hashes[cid], wid, ttl,
                        renew_every=renew_every)
            for cid in got
        ]

        def tick_all(*_progress) -> None:
            for k in keepers:
                k.tick()

        try:
            batch = run_cells_accel(
                [spec_of[cid] for cid in got], on_chunk=tick_all,
                device=device, cells=synthesized,
            )
        except ChunkBudgetError as e:
            # The fluid model cannot finish these cells: the exact
            # simulator can.  Anything else (a build, a launch, the card,
            # a kernel's wrapper) is not the cells' fault and propagates
            # below.
            for cid in got:
                accel_unfit[cid] = f"accel batch failed: {e!r}"
            _release_all(got)
            return False
        except BaseException:
            _release_all(got)
            raise
        for cid, result in zip(got, batch):
            _finish_one(cid, result)
        summary["accel_cells"] += len(got)
        summary["accel_batches"] += 1
        summary["leases_lost"] += sum(1 for k in keepers if k.lost)
        return True

    while True:
        store.heartbeat(
            wid,
            info={
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "done": len(summary["computed"]),
            },
        )
        done = store.load()
        todo = [cid for cid, _ in cells if (cid, hashes[cid]) not in done]
        if not todo:
            break
        if t_end is not None and time.monotonic() > t_end:
            summary["stalled"] = True
            break
        now = time.time()
        held = store.leases()
        if compute == "accel" and _try_accel_batch(todo, held, now):
            if (
                max_cells is not None
                and len(summary["computed"]) >= max_cells
            ):
                break
            continue
        # Python path: one spawned self-healing attempt per claimed cell.
        # Under compute="accel" this only sees cells the batch pass left
        # behind (accel-unfit, or claims lost to other workers).
        got = None
        for cid in todo:
            lease = held.get((cid, hashes[cid]))
            if lease is not None and lease.worker != wid and not lease.expired(now):
                continue  # live foreign lease — someone is on it
            if store.claim(cid, hashes[cid], wid, ttl):
                got = cid
                break
            summary["claims_lost"] += 1
        if got is None:
            time.sleep(poll)
            continue
        keeper = LeaseKeeper(
            store, got, hashes[got], wid, ttl, renew_every=renew_every
        )
        try:
            result = _compute_with_retries(
                got,
                spec_of[got],
                keeper,
                timeout=timeout,
                max_retries=max_retries,
                retry_backoff=retry_backoff,
                device=device,
            )
        except BaseException:
            _release_all([got])
            raise
        if not store.append(got, hashes[got], result):
            summary["duplicates_dropped"] += 1
        store.release(got, hashes[got], wid)
        if keeper.lost:
            summary["leases_lost"] += 1
        summary["computed"].append(got)
        if progress is not None:
            progress(got, result)
        if max_cells is not None and len(summary["computed"]) >= max_cells:
            break

    summary["stats"] = store.stats()
    return summary
