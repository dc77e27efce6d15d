"""The port's scenario entry points (repro_torch.scenarios: presets, the
inline sweep, the CLI) against the reference's (repro.scenarios).

* every preset, full and ``--quick``: the same names, cell ids, spec
  dicts and spec hashes;
* ``python -m repro_torch.scenarios list`` and ``show`` print byte for
  byte what the reference's CLI prints;
* ``run <preset> --quick --device cpu --store ... --json ...`` (inline)
  on paper-fb and paper-estimation-error-disciplines: every cell's report
  equals the reference's inline ``run_sweep`` (run in a child process
  beside the port's), exactly, apart from the wall time (tolerance:
  none); a rerun computes nothing;
* the device rule: ``--device cuda`` without a card exits 1 with
  ``resolve_device``'s message and runs nothing;
* a kernel failure is not a cell failure: raised inside an inline sweep
  or an accel batch of ``run_worker``, the port's ``KernelError`` ends
  the run (no retry, no quarantine record, no demotion to the Python
  path), and so do a kernel wrapper's input error (``KernelInputError``)
  and any other error of an accel batch, while the chunk budget still
  demotes a batch as the reference does;
* the "auto" latch: on a CUDA device each virtual-cluster kernel latches
  at its own live-job count; on the CPU nothing latches by default.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.scenarios import __main__ as ref_cli
from repro.scenarios import presets as ref_presets
from repro_torch import DeviceError, KernelError, KernelInputError
from repro_torch.accel import sweep_exec, waterfill
from repro_torch.accel.cell_step import ChunkBudgetError
from repro_torch.core import Phase, vcluster
from repro_torch.core.vcluster import VirtualCluster
from repro_torch.scenarios import __main__ as cli
from repro_torch.scenarios import presets, store as store_mod
from repro_torch.scenarios.spec import SweepSpec
from repro_torch.scenarios.sweep import run_sweep
from repro_torch.scenarios.worker import run_worker

INLINE_PRESETS = ("paper-fb", "paper-estimation-error-disciplines")
SRC = Path(__file__).resolve().parents[1] / "src"

#: The reference's inline run of one preset at --quick scale, as one JSON
#: object on stdout (the port's results pass through JSON as well).
_REFERENCE_RUN = """
import json, sys
from repro.scenarios import presets, sweep
sweep_ = presets.quick_sweep(presets.get_preset(sys.argv[1]))
json.dump(sweep.run_sweep(sweep_, workers=0), sys.stdout)
"""


@pytest.fixture(scope="module", autouse=True)
def reference_runs():
    """The reference's inline sweeps, one child process a preset, started
    with this module so that they run beside the port's runs here."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    children = {
        name: subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_RUN, name],
            stdout=subprocess.PIPE, env=env, text=True)
        for name in INLINE_PRESETS
    }

    def get(name: str) -> dict:
        out, _ = children[name].communicate(timeout=300)
        assert children[name].returncode == 0, f"reference run {name} failed"
        return json.loads(out)

    try:
        yield get
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.communicate()


def _strip_wall(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "wall_s"}


# ---------------------------------------------------------------------------
# Presets and the CLI's listing
# ---------------------------------------------------------------------------
def test_preset_names_match_reference():
    assert presets.list_presets() == ref_presets.list_presets()


@pytest.mark.parametrize("name", ref_presets.list_presets())
@pytest.mark.parametrize("quick", [False, True])
def test_preset_cells_match_reference(name, quick):
    ours, ref = presets.get_preset(name), ref_presets.get_preset(name)
    if quick:
        ours, ref = presets.quick_sweep(ours), ref_presets.quick_sweep(ref)
    assert ours.name == ref.name
    got = [(cid, s.to_dict(), s.spec_hash()) for cid, s in ours.expand()]
    want = [(cid, s.to_dict(), s.spec_hash()) for cid, s in ref.expand()]
    assert got == want


def test_cli_list_matches_reference(capsys):
    assert cli.main(["list"]) == 0
    ours = capsys.readouterr().out
    assert ref_cli.main(["list"]) == 0
    assert ours == capsys.readouterr().out


@pytest.mark.parametrize("name", ref_presets.list_presets())
def test_cli_show_matches_reference(capsys, name):
    for extra in ([], ["--quick"]):
        assert cli.main(["show", name, *extra]) == 0
        ours = capsys.readouterr().out
        assert ref_cli.main(["show", name, *extra]) == 0
        assert ours == capsys.readouterr().out


# ---------------------------------------------------------------------------
# run --device cpu (inline) against the reference's inline run_sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", INLINE_PRESETS)
def test_cli_run_inline_matches_reference(tmp_path, capsys, name,
                                          reference_runs):
    store = tmp_path / "s.jsonl"
    out = tmp_path / "out.json"
    argv = ["run", name, "--quick", "--device", "cpu", "--store", str(store),
            "--json", str(out)]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "QUARANTINED" not in printed and "MISSING" not in printed
    got = json.loads(out.read_text())["cells"]
    want = reference_runs(name)
    assert set(got) == set(want)
    for cid in want:
        assert _strip_wall(got[cid]) == _strip_wall(want[cid]), cid
    # Exactly once: one stored line per cell, and a rerun computes none.
    assert len(store.read_text().splitlines()) == len(want)
    assert cli.main(argv) == 0
    assert len(store.read_text().splitlines()) == len(want)


def test_cli_cuda_without_card_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = tmp_path / "s.jsonl"
    for argv in (["run", "paper-fb", "--quick", "--store", str(store)],
                 ["worker", "paper-fb", "--quick", "--store", str(store)],
                 ["replay", str(tmp_path / "t.jsonl")]):
        assert cli.main(argv) == 1
        assert "device='cpu'" in capsys.readouterr().err
    assert not store.exists()


# ---------------------------------------------------------------------------
# Device and kernel failures end the run
# ---------------------------------------------------------------------------
def _raise_kernel_error(*_args, **_kw):
    raise KernelError("waterfill kernel launch failed: cudaError 700")


def _hfsp_quick(vc_backend=None):
    over = {"scheduler.policy": "hfsp"}
    if vc_backend is not None:
        over["scheduler.vc_backend"] = vc_backend
    return presets.quick_sweep(SweepSpec(
        name="one-hfsp", base=presets.paper_fb_base().override(**over)))


def test_inline_sweep_raises_kernel_error_without_quarantine(
        tmp_path, monkeypatch):
    monkeypatch.setattr(waterfill, "water_fill", _raise_kernel_error)
    store = tmp_path / "s.jsonl"
    with pytest.raises(KernelError):
        run_sweep(_hfsp_quick("torch"), store=store, workers=0,
                  retry_backoff=0.0, device="cpu")
    assert store_mod.open_store(store).load() == {}


def test_accel_batch_kernel_error_is_raised_not_demoted(
        tmp_path, monkeypatch):
    monkeypatch.setattr(waterfill, "water_fill_pair_reference",
                        _raise_kernel_error)
    path = tmp_path / "w.sqlite"
    with pytest.raises(KernelError):
        run_worker(_hfsp_quick(), path, compute="accel", device="cpu",
                   deadline=60.0)
    store = store_mod.open_store(path)
    assert store.load() == {}
    assert store.leases() == {}  # released for another worker to take
    assert store.stats()["claims"] == 1


def test_inline_sweep_raises_kernel_input_error_without_quarantine(
        tmp_path, monkeypatch):
    # Every water-fill the virtual clusters hand the wrapper is now wider
    # than it takes: its own check raises.
    monkeypatch.setattr(waterfill, "_MAX_WIDTH", 1)
    store = tmp_path / "s.jsonl"
    with pytest.raises(KernelInputError, match="pads to"):
        run_sweep(_hfsp_quick("torch"), store=store, workers=0,
                  retry_backoff=0.0, device="cpu")
    assert store_mod.open_store(store).load() == {}


def test_accel_batch_value_error_is_raised_not_demoted(tmp_path,
                                                       monkeypatch):
    def bad_inputs(*_args, **_kw):
        raise ValueError("caps must be (B, W)")

    monkeypatch.setattr(waterfill, "water_fill_pair_reference", bad_inputs)
    path = tmp_path / "w.sqlite"
    with pytest.raises(ValueError, match="caps must be"):
        run_worker(_hfsp_quick(), path, compute="accel", device="cpu",
                   deadline=60.0)
    store = store_mod.open_store(path)
    assert store.load() == {}
    assert store.leases() == {}


def test_kernel_input_error_is_a_kernel_error_and_a_value_error():
    with pytest.raises(KernelInputError, match="needs CUDA tensors") as e:
        waterfill.water_fill_cuda(torch.ones(1, 8, dtype=torch.float64),
                                  torch.ones(1, 8, dtype=torch.float64),
                                  torch.ones(1, dtype=torch.float64),
                                  torch.ones(1, 8, dtype=torch.bool))
    assert isinstance(e.value, KernelError) and isinstance(e.value, ValueError)
    assert issubclass(KernelInputError, TypeError)


def test_accel_chunk_budget_demotes_to_python_path(tmp_path, monkeypatch):
    def over_budget(*_args, **_kw):
        raise ChunkBudgetError("accel cell batch did not converge")

    monkeypatch.setattr(sweep_exec, "run_packed", over_budget)
    sweep = presets.quick_sweep(SweepSpec(
        name="one-fifo", base=presets.paper_fb_base().override(
            **{"scheduler.policy": "fifo"})))
    summary = run_worker(sweep, tmp_path / "w.jsonl", compute="accel",
                         device="cpu", deadline=120.0)
    (cid, spec), = sweep.expand()
    assert summary["computed"] == [cid]
    assert summary["accel_cells"] == 0
    assert "did not converge" in summary["accel_fallbacks"][cid]
    stored = store_mod.open_store(tmp_path / "w.jsonl").load()
    report = stored[(cid, spec.spec_hash())]
    assert "compute" not in report and report["jobs_completed"] == 30


# ---------------------------------------------------------------------------
# The "auto" latch, one threshold per kernel
# ---------------------------------------------------------------------------
def test_auto_latches_each_kernel_at_its_own_threshold(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    vc = VirtualCluster(Phase.MAP, slots=10, backend="auto", device="cuda")
    at = vcluster.AUTO_PROJECT_THRESHOLD
    for j in range(at - 1):
        vc.add_job(j, 50.0, 2)
    assert (vc.fill_backend, vc.project_backend) == ("numpy", "numpy")
    vc.add_job(at, 50.0, 2)
    assert vc.project_backend == "torch"
    assert vcluster.AUTO_FILL_THRESHOLD is None  # numpy won at every count
    for j in range(at + 1, at + 64):
        vc.add_job(j, 50.0, 2)
    assert (vc.fill_backend, vc.project_backend) == ("numpy", "torch")
    assert vc.backend == "mixed"  # the reference's attribute, read as one


def test_auto_latches_nothing_on_the_cpu_by_default():
    vc = VirtualCluster(Phase.MAP, slots=10, backend="auto", device="cpu")
    for j in range(600):
        vc.add_job(j, 50.0, 2)
    assert vc.backend == "numpy"


def test_device_error_is_a_runtime_error():
    assert issubclass(KernelError, DeviceError)
    assert issubclass(DeviceError, RuntimeError)
