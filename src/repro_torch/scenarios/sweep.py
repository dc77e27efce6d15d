"""Parallel sweep engine: resumable result store + self-healing workers.

A copy of ``repro.scenarios.sweep``.  ``run_sweep`` expands a
:class:`~repro_torch.scenarios.spec.SweepSpec` into its scenario cells and
fans them out across worker *processes* (the simulator is pure Python —
process pools are the only way to use multiple cores).  Results stream
into a store (see :mod:`repro_torch.scenarios.store`; the reference
backend is append-only JSONL, ``open_store`` also accepts a sqlite path)
as cells finish, keyed by ``(cell_id, spec_hash)``:

* **resume** — a re-run of an interrupted sweep skips every cell whose
  (cell_id, spec_hash) pair is already stored, recomputing nothing;
* **staleness** — editing a preset changes the affected cells'
  ``spec_hash``, so stale stored results are ignored (and recomputed)
  instead of being silently reused;
* **determinism** — a cell's result is a pure function of its spec (all
  RNG seeds, including the fault-injection seed, are spec fields), so
  parallel/serial execution, any resume order, and any self-healing
  retry or re-issue produce identical stores up to line order.

Self-healing (the parallel path supervises one spawned process per cell
attempt, so a sick cell cannot take the sweep down with it):

* **timeout** — an attempt exceeding the per-cell wall-clock budget is
  killed and counts as a failure;
* **bounded retry** — a failed cell is re-queued with capped exponential
  backoff, up to ``max_retries`` times;
* **quarantine** — a cell failing past its retry budget lands in the
  store as a poison-cell record ``{"quarantined": True, "error": ...}``
  instead of aborting the sweep; ``matrix_report`` lists and excludes
  it.  A resume treats the quarantine record as done — delete its store
  line to retry the cell;
* **straggler re-issue** — a cell running far past the median finished
  wall time gets a second racing attempt on spare capacity; the first
  finisher wins (:class:`repro_torch.core.faults.FirstFinisherWins`) and
  the loser is killed.  Purity makes the race safe: both attempts compute
  the same result.

The port adds ``device`` (``"cuda"`` unless the caller asks for
``"cpu"``), which reaches every cell, inline or spawned, as an argument.
Self-healing is for the cells: a failure of the card or of a kernel of the
port (:func:`repro_torch.is_device_failure`) is neither retried nor
quarantined.  Inline it propagates; from a spawned attempt it stops every
attempt and raises :class:`repro_torch.DeviceError`.  Either way the sweep
ends non-zero with the cells it finished stored.

This module is the *local* (single-machine, private-store) executor.
The distributed fabric reuses the same per-attempt primitives under a
lease protocol: see :mod:`repro_torch.scenarios.worker` (lease-claiming
worker loop), :mod:`repro_torch.scenarios.store` (pluggable shared-store
backends), :mod:`repro_torch.scenarios.lease` (claim/renew/release
protocol) and :mod:`repro_torch.scenarios.coordinator` (``sweep-status``
view).

Workers use the ``spawn`` start method: the parent holds CUDA state,
which does not survive ``fork``.
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path

from repro_torch import is_device_failure
from repro_torch.core.faults import FirstFinisherWins
from repro_torch.scenarios.runner import run_scenario
from repro_torch.scenarios.spec import ScenarioSpec, SweepSpec
from repro_torch.scenarios.store import (  # noqa: F401 - ResultStore re-exported
    ResultStore,
    SweepStore,
    open_store,
)
from repro_torch.scenarios.worker import (  # noqa: F401 - hook re-exported for tests
    _TEST_HOOK_ENV,
    _cell_worker,
    _quarantine_record,
    attempt_failed_on_device,
    prebuild_kernels,
)


class _Attempt:
    """One running cell attempt (a spawned process + its result pipe)."""

    __slots__ = ("cid", "proc", "conn", "started")

    def __init__(self, cid, proc, conn, started):
        self.cid, self.proc, self.conn, self.started = cid, proc, conn, started


def run_sweep(
    sweep: SweepSpec,
    store: SweepStore | str | Path | None = None,
    workers: int = 0,
    max_cells: int | None = None,
    progress=None,
    timeout: float | None = 600.0,
    max_retries: int = 2,
    retry_backoff: float = 0.5,
    straggler_factor: float = 4.0,
    *,
    device: str = "cuda",
) -> dict[str, dict]:
    """Run (or resume) a sweep; returns {cell_id: scenario_report}.

    ``workers=0`` runs inline (deterministic single-process order, used
    by tests and small presets); ``workers=N`` fans cells out over N
    spawn-based attempt processes under the self-healing supervisor (see
    module docstring).  ``max_cells`` bounds how many *new* cells are
    computed this call — the hook tests use it to interrupt a sweep
    mid-grid and assert resume semantics.  ``progress`` is an optional
    ``f(cell_id, result)`` callback invoked as each cell finishes.

    ``store`` accepts a backend instance or a path (coerced via
    :func:`~repro_torch.scenarios.store.open_store`, so ``results.sqlite``
    selects the sqlite backend).  To spread one sweep across machines
    sharing a store, run :func:`repro_torch.scenarios.worker.run_worker`
    loops instead — this function is the local executor and does not
    take leases.

    ``device`` is where every cell's kernels run; a failure of the card
    or of a kernel raises instead of being retried or quarantined (module
    docstring).

    Self-healing knobs (parallel path): ``timeout`` is the per-attempt
    wall-clock budget in seconds (None = unbounded); a failed or
    timed-out cell retries up to ``max_retries`` times with capped
    exponential ``retry_backoff`` before being stored as a quarantine
    record; an attempt running past ``straggler_factor`` x the median
    finished wall time is raced by a second attempt (first finisher
    wins).  The inline path applies retry + quarantine only — there is
    no process boundary to kill, so no timeout or re-issue.
    """
    prebuild_kernels(device)
    if store is not None and not isinstance(store, SweepStore):
        store = open_store(store)
    cells = sweep.expand()
    done = store.load() if store is not None else {}

    results: dict[str, dict] = {}
    todo: list[tuple[str, ScenarioSpec]] = []
    for cid, spec in cells:
        prior = done.get((cid, spec.spec_hash()))
        if prior is not None:
            results[cid] = prior
        else:
            todo.append((cid, spec))
    if max_cells is not None:
        todo = todo[:max_cells]

    def finish(cid: str, spec: ScenarioSpec, result: dict) -> None:
        results[cid] = result
        if store is not None:
            store.append(cid, spec.spec_hash(), result)
        if progress is not None:
            progress(cid, result)

    if workers <= 1:
        for cid, spec in todo:
            n_fails = 0
            while True:
                try:
                    result = run_scenario(spec, device=device)
                except Exception as e:  # noqa: BLE001 - bounded retry
                    if is_device_failure(e):
                        raise
                    n_fails += 1
                    if n_fails > max_retries:
                        finish(
                            cid, spec, _quarantine_record(cid, repr(e), n_fails)
                        )
                        break
                    time.sleep(retry_backoff * (2.0 ** (n_fails - 1)))
                    continue
                finish(cid, spec, result)
                break
        return results

    _supervise(
        todo, workers, finish,
        device=device,
        timeout=timeout,
        max_retries=max_retries,
        retry_backoff=retry_backoff,
        straggler_factor=straggler_factor,
    )
    return results


def _supervise(
    todo: list[tuple[str, ScenarioSpec]],
    workers: int,
    finish,
    *,
    device: str,
    timeout: float | None,
    max_retries: int,
    retry_backoff: float,
    straggler_factor: float,
) -> None:
    """The self-healing parallel executor: one spawned process per cell
    attempt, supervised for results, failures, timeouts, and stragglers.
    An attempt that reports a failure of the card or of a kernel stops
    every attempt and raises."""
    import multiprocessing
    from multiprocessing.connection import wait as conn_wait

    ctx = multiprocessing.get_context("spawn")
    spec_of = dict(todo)
    # (not_before, launch-order, cid) — backoff-delayed retries re-enter
    # here; the tiebreaker keeps ordering deterministic.
    order = itertools.count()
    queue: list[tuple[float, int, str]] = [
        (0.0, next(order), cid) for cid, _ in todo
    ]
    n_fails: dict[str, int] = {}
    attempts: dict[str, list[_Attempt]] = {}
    by_conn: dict[object, _Attempt] = {}
    ffw = FirstFinisherWins()
    finished_walls: list[float] = []

    def n_running() -> int:
        return len(by_conn)

    def launch(cid: str) -> None:
        parent_conn, child_conn = ctx.Pipe(duplex=False)
        proc = ctx.Process(
            target=_cell_worker,
            args=(child_conn, cid, spec_of[cid].to_dict(), device),
            daemon=True,
        )
        proc.start()
        child_conn.close()
        att = _Attempt(cid, proc, parent_conn, time.monotonic())
        attempts.setdefault(cid, []).append(att)
        by_conn[parent_conn] = att

    def kill(att: _Attempt) -> None:
        by_conn.pop(att.conn, None)
        atts = attempts.get(att.cid)
        if atts and att in atts:
            atts.remove(att)
            if not atts:
                del attempts[att.cid]
        try:
            att.conn.close()
        except Exception:
            pass
        if att.proc.is_alive():
            att.proc.terminate()
            att.proc.join(5.0)
            if att.proc.is_alive():  # pragma: no cover - hard hang
                att.proc.kill()
        att.proc.join(5.0)

    def attempt_failed(att: _Attempt, error: str) -> None:
        """One attempt died; the cell fails only when none remain."""
        cid = att.cid
        kill(att)
        if cid in attempts:
            return  # a racing sibling is still in flight
        n = n_fails.get(cid, 0) + 1
        n_fails[cid] = n
        if n > max_retries:
            finish(cid, spec_of[cid], _quarantine_record(cid, error, n))
        else:
            delay = retry_backoff * (2.0 ** (n - 1))
            queue.append((time.monotonic() + delay, next(order), cid))

    try:
        while queue or attempts:
            now = time.monotonic()
            queue.sort()
            while queue and n_running() < workers and queue[0][0] <= now:
                _, _, cid = queue.pop(0)
                launch(cid)
            # Straggler re-issue: race a second attempt against any cell
            # running far past the median finished wall time.
            if len(finished_walls) >= 3 and n_running() < workers:
                med = sorted(finished_walls)[len(finished_walls) // 2]
                cutoff = straggler_factor * max(med, 0.1)
                for cid, atts in list(attempts.items()):
                    if n_running() >= workers:
                        break
                    if len(atts) == 1 and now - atts[0].started > cutoff:
                        launch(cid)
            if not by_conn:
                if queue:  # every cell is sitting out a retry backoff
                    time.sleep(min(0.05, max(0.0, queue[0][0] - now)))
                continue
            for conn in conn_wait(list(by_conn), timeout=0.1):
                att = by_conn.get(conn)
                if att is None:
                    continue  # a sibling's win already tore this attempt down
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    msg = ("err", "worker process died without sending a result")
                if msg[0] == "ok":
                    if ffw.finish(att.cid, id(att)):
                        finished_walls.append(time.monotonic() - att.started)
                        cid = att.cid
                        for other in list(attempts.get(cid, ())):
                            kill(other)  # includes att itself
                        finish(cid, spec_of[cid], msg[1])
                elif msg[0] == "fatal":
                    raise attempt_failed_on_device(att.cid, msg[1])
                else:
                    attempt_failed(att, msg[1])
            if timeout is not None:
                now = time.monotonic()
                for atts in list(attempts.values()):
                    for att in list(atts):
                        if now - att.started > timeout:
                            attempt_failed(
                                att, f"timeout: exceeded {timeout}s wall clock"
                            )
    finally:
        # A raise (a device failure, an interrupt) leaves no attempt
        # running.
        for atts in list(attempts.values()):
            for att in list(atts):
                kill(att)
