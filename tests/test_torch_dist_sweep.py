"""The port's distributed sweep fabric (repro_torch.scenarios: store,
lease, coordinator, worker, the spawned supervisor of sweep) against the
reference's (repro.scenarios).

* the store contract on both backends, and byte compatibility: the same
  operations give a JSONL store and lease log equal byte for byte to the
  reference's, and each package reads what the other wrote;
* a store half-filled by the reference's ``run_worker(max_cells=1)`` and
  finished by the port's ``run_worker(device="cpu")``: every cell stored
  exactly once, each report equal to the reference's inline run apart
  from the wall time (tolerance: none), and ``sweep_status`` of both
  packages equal on it;
* ``run_sweep(workers=2, device="cpu")``: spawned attempts converge with
  the reference's reports (wall dropped);
* a mixed ``worker --compute accel --device cpu`` run through the CLI
  (the port of the reference's
  ``test_worker_compute_accel_converges_mixed_sweep``): fifo and hfsp in
  one in-process batch, within rtol 1e-9 of the reference's accel batch
  on sojourn and makespan and exact elsewhere, fair through a spawned
  attempt, equal to the reference's report apart from the wall time;
* a kernel error inside a spawned attempt (the ``kernel_error`` test
  hook raises the port's ``KernelError`` there) ends ``run_sweep`` and
  ``run_worker`` with a ``DeviceError``: nothing retried, quarantined or
  left leased, and the cells finished before it stay stored.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.scenarios import coordinator as ref_coordinator
from repro.scenarios import presets as ref_presets
from repro.scenarios import store as ref_store
from repro.scenarios import worker as ref_worker
from repro_torch import DeviceError
from repro_torch.scenarios import __main__ as cli
from repro_torch.scenarios import presets
from repro_torch.scenarios import store as port_store
from repro_torch.scenarios.coordinator import format_status, sweep_status
from repro_torch.scenarios.lease import COUNTERS
from repro_torch.scenarios.store import (
    ResultStore,
    SqliteResultStore,
    open_store,
)
from repro_torch.scenarios.sweep import run_sweep
from repro_torch.scenarios.worker import _TEST_HOOK_ENV, run_worker

SRC = Path(__file__).resolve().parents[1] / "src"
T0 = 1000.0

#: The reference's inline paper-fb --quick sweep and its accel batch of the
#: accel-eligible cells (fifo, hfsp), as one JSON object on stdout.  The
#: reference calls ``jax.experimental.enable_x64``, which the installed
#: jax lacks; the child restores it as ``jax.enable_x64(True)``.
_REFERENCE_RUN = """
import json, sys
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
from repro.accel.sweep_exec import run_cells_accel
from repro.scenarios import presets, sweep
fb = presets.quick_sweep(presets.get_preset("paper-fb"))
accel = [(c, s) for c, s in fb.expand() if s.scheduler.policy != "fair"]
json.dump({"inline": sweep.run_sweep(fb, workers=0),
           "accel": dict(zip([c for c, _ in accel],
                             run_cells_accel([s for _, s in accel])))},
          sys.stdout)
"""


@pytest.fixture(scope="module", autouse=True)
def reference_fb():
    """The reference's paper-fb --quick runs (``get()["inline"]``,
    ``get()["accel"]``), computed in a child process that starts with
    this module."""
    child = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_RUN], stdout=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": str(SRC)}, text=True)
    result = {}

    def get() -> dict:
        if not result:
            out, _ = child.communicate(timeout=300)
            assert child.returncode == 0, "reference run failed"
            result.update(json.loads(out))
        return result

    try:
        yield get
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()


def _strip_wall(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "wall_s"}


def _fb_quick(mod=presets):
    return mod.quick_sweep(mod.get_preset("paper-fb"))


def _fifo_hfsp(mod=presets):
    """Two cells of paper-fb --quick: one round of two spawned attempts."""
    fb = mod.get_preset("paper-fb")
    return mod.quick_sweep(type(fb)(
        name="fifo-hfsp", base=fb.base,
        grids=(type(fb).grid(**{"scheduler.policy": ("fifo", "hfsp")}),)))


def _assert_store_matches(store, sweep, want: dict) -> None:
    """Every cell of ``sweep`` stored once, equal to ``want`` (a superset)
    apart from the wall time."""
    stored = open_store(store).load()
    assert len(stored) == len(sweep.expand())
    for cid, spec in sweep.expand():
        got = stored[(cid, spec.spec_hash())]
        assert _strip_wall(got) == _strip_wall(want[cid]), cid


def _hook(tmp_path, **hook) -> Path:
    path = tmp_path / "hook.json"
    path.write_text(json.dumps({"state_dir": str(tmp_path), **hook}))
    return path


# ---------------------------------------------------------------------------
# The store: contract and byte compatibility
# ---------------------------------------------------------------------------
@pytest.fixture(params=["jsonl", "sqlite"])
def store(request, tmp_path):
    if request.param == "jsonl":
        return ResultStore(tmp_path / "store.jsonl")
    return SqliteResultStore(tmp_path / "store.sqlite")


def test_store_exactly_once_and_lease_lifecycle(store):
    assert store.append("c1", "h1", {"v": 1}) is True
    assert store.append("c1", "h1", {"v": 9}) is False  # first wins
    assert store.load() == {("c1", "h1"): {"v": 1}}
    assert store.claim("c", "h", "w1", ttl=10.0, now=T0)
    assert not store.claim("c", "h", "w2", ttl=10.0, now=T0 + 5.0)
    assert store.renew("c", "h", "w1", ttl=10.0, now=T0 + 5.0)
    assert store.claim("c", "h", "w2", ttl=10.0, now=T0 + 20.0)  # reissue
    store.release("c", "h", "w2")
    assert store.leases() == {}
    stats = store.stats()
    assert set(stats) >= set(COUNTERS)
    assert (stats["claims"], stats["reissues"], stats["renews"],
            stats["releases"], stats["duplicates"]) == (2, 1, 1, 1, 1)


def _same_ops(st) -> None:
    st.append("c1", "h1", {"mean_sojourn_s": 1.5, "jobs": [1, 2]})
    st.claim("c2", "h2", "w1", ttl=30.0, now=T0)
    st.renew("c2", "h2", "w1", ttl=30.0, now=T0 + 10.0)
    st.claim("c3", "h3", "w1", ttl=1.0, now=T0)
    st.claim("c3", "h3", "w2", ttl=5.0, now=T0 + 50.0)
    st.heartbeat("w1", info={"host": "a", "done": 1}, now=T0 + 11.0)


def test_jsonl_store_bytes_equal_the_reference(tmp_path):
    ours = ResultStore(tmp_path / "ours.jsonl")
    ref = ref_store.ResultStore(tmp_path / "ref.jsonl")
    _same_ops(ours)
    _same_ops(ref)
    assert ours.path.read_bytes() == ref.path.read_bytes()
    assert ours.lease_path.read_bytes() == ref.lease_path.read_bytes()


@pytest.mark.parametrize("suffix", [".jsonl", ".sqlite"])
def test_each_package_reads_what_the_other_wrote(tmp_path, suffix):
    for writer, reader in ((ref_store, port_store),
                           (port_store, ref_store)):
        path = tmp_path / f"{writer.__name__}{suffix}"
        _same_ops(writer.open_store(path))
        got, want = reader.open_store(path), writer.open_store(path)
        assert got.load() == want.load()
        assert got.stats() == want.stats()
        assert got.workers() == want.workers()
        assert {k: (v.worker, v.expires) for k, v in got.leases().items()} \
            == {k: (v.worker, v.expires) for k, v in want.leases().items()}


# ---------------------------------------------------------------------------
# Workers and sweeps against the reference
# ---------------------------------------------------------------------------
def test_reference_half_filled_store_finished_by_the_port(
        tmp_path, monkeypatch, reference_fb):
    monkeypatch.delenv(_TEST_HOOK_ENV, raising=False)
    path = tmp_path / "shared.jsonl"
    first = ref_worker.run_worker(_fifo_hfsp(ref_presets), path,
                                  worker_id="ref", max_cells=1,
                                  timeout=120.0, deadline=120.0)
    rest = run_worker(_fifo_hfsp(), path, worker_id="port", device="cpu",
                      timeout=120.0, deadline=120.0)
    assert not rest["stalled"]
    cids = [cid for cid, _ in _fifo_hfsp().expand()]
    assert first["computed"] + rest["computed"] == cids
    assert rest["duplicates_dropped"] == 0
    _assert_store_matches(path, _fifo_hfsp(), reference_fb()["inline"])
    assert len(path.read_text().splitlines()) == len(cids)  # exactly once
    assert rest["stats"]["claims"] == 2 and rest["stats"]["releases"] == 2

    now = T0 + 1e9
    ours = sweep_status(_fifo_hfsp(), path, now=now)
    ref = ref_coordinator.sweep_status(_fifo_hfsp(ref_presets), path, now=now)
    assert ours == ref
    assert ours["converged"] and ours["quarantined"] == []
    assert format_status(ours) == ref_coordinator.format_status(ref)


def test_spawned_two_worker_sweep_matches_reference(
        tmp_path, monkeypatch, reference_fb):
    """Torch virtual clusters in the spawned attempts (on the CPU, the
    kernels' plain versions), equal to the reference's numpy run; each
    attempt writes its counters (the hook's ``launch_counts``)."""
    monkeypatch.setenv(_TEST_HOOK_ENV, str(_hook(tmp_path,
                                                  launch_counts=True)))
    monkeypatch.setenv("REPRO_VC_BACKEND", "torch")
    path = tmp_path / "s.jsonl"
    results = run_sweep(_fifo_hfsp(), store=path, workers=2, timeout=120.0,
                        device="cpu")
    want = {cid: reference_fb()["inline"][cid]
            for cid, _ in _fifo_hfsp().expand()}
    assert {c: _strip_wall(r) for c, r in results.items()} \
        == {c: _strip_wall(r) for c, r in want.items()}
    _assert_store_matches(path, _fifo_hfsp(), want)
    counts = {c["cell_id"]: c for c in (
        json.loads(f.read_text()) for f in tmp_path.glob("launches-*.json"))}
    assert set(counts) == set(want)
    hfsp, fifo = counts["scheduler.policy=hfsp"], counts["scheduler.policy=fifo"]
    assert hfsp["water_fill_calls"] > 0 and hfsp["project_calls"] > 0
    assert fifo["water_fill_calls"] == fifo["project_calls"] == 0
    # No launch on the CPU: the wrappers ran their plain versions.
    assert all(c["k1_launches"] == c["project_launches"] == 0
               for c in counts.values())


def test_cli_worker_compute_accel_converges_mixed_sweep(
        tmp_path, monkeypatch, capsys, reference_fb):
    """``worker --compute accel --device cpu``: fifo and hfsp in one
    in-process batch, within rtol 1e-9 of the reference's accel batch on
    sojourn and makespan and exact elsewhere (test_torch_accel.py's
    tolerance: XLA may contract or reorder the step's arithmetic); fair
    through a spawned attempt, equal to the reference's report."""
    monkeypatch.delenv(_TEST_HOOK_ENV, raising=False)
    path = tmp_path / "accel.sqlite"
    assert cli.main(["worker", "paper-fb", "--quick", "--device", "cpu",
                     "--compute", "accel", "--store", str(path),
                     "--deadline", "300"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("\n{") + 1:])
    assert not summary["stalled"]
    assert sorted(summary["computed"]) == [
        "scheduler.policy=fair", "scheduler.policy=fifo",
        "scheduler.policy=hfsp",
    ]
    assert summary["accel_cells"] == 2
    assert summary["accel_batches"] == 1
    assert list(summary["accel_fallbacks"]) == ["scheduler.policy=fair"]
    stored = {cid: r for (cid, _), r in open_store(path).load().items()}
    fair = "scheduler.policy=fair"
    assert _strip_wall(stored[fair]) \
        == _strip_wall(reference_fb()["inline"][fair])
    close = ("mean_sojourn_s", "makespan_s")
    for cid, want in reference_fb()["accel"].items():
        got = stored[cid]
        assert got["compute"] == "accel"
        for k in close:
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0.0), cid
        assert {k: v for k, v in _strip_wall(got).items() if k not in close} \
            == {k: v for k, v in _strip_wall(want).items() if k not in close}
    assert sweep_status(_fb_quick(), path)["converged"]


# ---------------------------------------------------------------------------
# A kernel error in a spawned attempt ends the run
# ---------------------------------------------------------------------------
def test_spawned_kernel_error_ends_run_sweep(tmp_path, monkeypatch):
    monkeypatch.setenv(_TEST_HOOK_ENV, str(_hook(
        tmp_path, kernel_error=["scheduler.policy=hfsp"])))
    path = tmp_path / "s.jsonl"
    with pytest.raises(DeviceError, match="KernelError"):
        run_sweep(_fifo_hfsp(), store=path, workers=2, timeout=120.0,
                  retry_backoff=0.0, device="cpu")
    stored = {cid: r for (cid, _), r in open_store(path).load().items()}
    assert "scheduler.policy=hfsp" not in stored
    assert not any(r.get("quarantined") for r in stored.values())


def test_spawned_kernel_error_ends_run_worker(tmp_path, monkeypatch):
    monkeypatch.setenv(_TEST_HOOK_ENV, str(_hook(
        tmp_path, kernel_error=["scheduler.policy=fifo"])))
    path = tmp_path / "w.sqlite"
    with pytest.raises(DeviceError, match="KernelError"):
        run_worker(_fb_quick(), path, device="cpu", timeout=120.0,
                   retry_backoff=0.0, deadline=120.0)
    st = open_store(path)
    assert st.load() == {}
    assert st.leases() == {}
    assert st.stats()["claims"] == 1  # one attempt, no retry
