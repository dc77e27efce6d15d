"""The harness on the CPU: cells found by name from files alone, names
refused, the contract's characters, no JAX anywhere, and the exits
without a card."""

import ast
import io
import json
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench import cellspec, run
from portbench.tests.tiny import REPO, make_root


@pytest.fixture(autouse=True)
def no_jax_check(monkeypatch):
    """The test process may hold JAX from the repository's other tests;
    the look for it after the window has a test of its own."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


def _main(root, *args, **kw):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(list(args), root=root, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


def test_a_cell_added_as_files_is_found_and_runs(tmp_path):
    root = make_root(tmp_path)
    cell = cellspec.find_cell(root, "tiny-dense.prefill")
    assert cell.model["d_model"] == 64 and cell.traffic["kind"] == "prefill"
    assert [m["name"] for m in cell.end_to_end] == [
        "prefill_tokens_per_s", "ttft_p95_ms", "setup_s"]
    rc, result = _main(root, "--workload", "tiny-dense.prefill", "--seed",
                       str(2**33 + 5), "--seconds", "0.2", "--trace", "0",
                       device="cpu")
    assert rc == 0 and result["correct"] is True
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms",
                                      "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_family_reference_and_a_loop_kind_added_as_files_are_used(
        tmp_path):
    root = make_root(tmp_path)
    cell = cellspec.find_cell(root, "tiny-own.prefill")
    assert cell.reference.__file__.endswith("reference/tiny_own.py")
    assert cell.kind.__file__.endswith("kinds/tiny_own.py")
    rc, result = _main(root, "--workload", "tiny-own.prefill", "--seed",
                       "2718281828459", "--seconds", "0.2", device="cpu")
    assert rc == 0 and result["correct"] is True
    assert cell.kind.RUNS == [2718281828459]
    # The reference the configuration names judged the window's requests.
    assert cell.reference.CALLS
    assert all(b * s == 128 for b, s in cell.reference.CALLS)


def test_a_config_without_a_reference_module_is_refused(tmp_path):
    root = make_root(tmp_path)
    path = root / "portbench/configs/tiny-own.json"
    config = json.loads(path.read_text())
    for bad in (None, "/etc/x.py", "portbench/../x.py",
                "portbench/kinds/prefill.py", "portbench/reference/none.py"):
        config["reference"] = bad
        path.write_text(json.dumps(config))
        with pytest.raises(cellspec.SpecError):
            cellspec.find_cell(root, "tiny-own.prefill")


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(tmp_path):
    root = make_root(tmp_path)
    rc, result = _main(root, "--workload", "tiny-moe.prefill", "--seed", "7",
                       "--seconds", "0.2", "--trace", "1", device="cpu")
    assert rc == 0 and result["correct"] is True
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # The CPU has no peaks and no device ops: those readers stay silent,
    # and none reads 0.
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0.0


def test_an_unknown_name_is_refused(tmp_path, capsys):
    rc, result = _main(REPO, "--workload", "no-such-cell", "--seed", "1",
                       "--seconds", "1", device="cpu")
    assert rc == 2 and result is None
    assert "unknown workload" in capsys.readouterr().err
    with pytest.raises(cellspec.SpecError):
        cellspec.load_reader(REPO, "no_such_metric")


@pytest.mark.parametrize("bad", ["a b", "a/b", "-a", ".a", "é", "x" * 65, ""])
def test_a_name_outside_the_allowed_characters_is_refused(bad):
    with pytest.raises(cellspec.SpecError):
        cellspec.check_name(bad, "name")


def test_every_name_and_unit_of_the_benchmark_is_allowed():
    bench = cellspec.load_benchmark(REPO)
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        cellspec.find_cell(REPO, w["name"])        # every file is there
        assert w["chips"] == 1
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
        assert m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", c["file"])


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # A module path handed to importlib, as the readers' SPANS are.
            if re.fullmatch(r"(jax|jaxlib|flax|repro)(\.\w+)+", node.value):
                found.add(node.value.split(".")[0])
    return found


def test_no_module_of_the_benchmark_names_jax_or_the_jax_package():
    files = sorted((REPO / "portbench").rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_a_process_holding_jax_prints_no_result(tmp_path, monkeypatch):
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setitem(sys.modules, "repro", sys)
    assert {"jax", "repro"} <= set(run.forbidden_modules())
    rc, result = _main(make_root(tmp_path), "--workload",
                       "tiny-dense.prefill", "--seed", "3", "--seconds",
                       "0.1", device="cpu")
    assert rc == 3 and result is None


def test_without_a_card_the_run_exits_without_a_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc, result = _main(REPO, "--workload", "olmo-1b.prefill.mixed",
                       "--seed", "1", "--seconds", "1")
    assert rc == 1 and result is None


def test_with_only_the_benchmark_files_the_run_fails(tmp_path):
    (tmp_path / "portbench").mkdir()
    for item in (REPO / "portbench").iterdir():
        if item.name != "__pycache__":
            dst = tmp_path / "portbench" / item.name
            if item.is_dir():
                shutil.copytree(item, dst, ignore=shutil.ignore_patterns(
                    "__pycache__"))
            else:
                dst.write_bytes(item.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes(
        (REPO / "BENCHMARK.json").read_bytes())
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "olmo-1b.prefill.mixed", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
