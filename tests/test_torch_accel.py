"""The port's accel sweep path (repro_torch.accel, repro_torch.scenarios,
repro_torch.workload) against the JAX reference (repro.accel et al.).

* spec layer: ``to_dict``, cell ids and spec hashes equal the
  reference's;
* synthesis: ``synthesize_cell`` + ``pack_cells`` equal the reference's
  bitwise over GOLDEN_SEEDS × {fifo, hfsp, srpt, las} × alpha {0, 0.5}
  and for one ``fb_scaled`` cell;
* the cell run: one quick-scale batch through the reference's
  ``run_packed(impl="lax")`` and the port's ``run_packed(impl="torch")``
  on the CPU — ``accel_steps`` and ``jobs_completed`` exact, ``comp`` at
  ``rtol=1e-9`` (the water-fill sums are over whole task counts under
  uniform weights, so they are exact in any order; the tolerance covers
  XLA's freedom to contract or reorder the rest of the step);
* the fixed-shape contract: padding neutrality and rerun determinism,
  bitwise, for the port;
* eligibility refusals, a mixed sweep whose ineligible cell runs through
  the port's simulator (against the reference's ``run_sweep_accel``),
  the device rule (no quiet CPU fallback), and that no module of the
  port imports jax or repro.

The reference calls ``jax.experimental.enable_x64``, which the installed
jax no longer has; a module-scoped shim restores it as
``jax.enable_x64(True)`` for these tests only.
"""

import subprocess
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from conformance import GOLDEN_SEEDS
from repro.accel import cell_step as ref_cell
from repro.accel import sweep_exec as ref_exec
from repro.scenarios import presets as ref_presets
from repro_torch.accel import cell_step, sweep_exec
from repro_torch.scenarios import presets

POLICIES = ("fifo", "hfsp", "srpt", "las")


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _quick(mod, seed, policy, **extra):
    return mod.paper_fb_base(seed=seed).quick().override(
        **{"scheduler.policy": policy, **extra}
    )


# ---------------------------------------------------------------------------
# Spec layer and synthesis
# ---------------------------------------------------------------------------
def _accel_matrix(mod, base):
    """The 4 x 4 x 4 matrix of benchmarks/bench_sched_overhead.py."""
    return mod.SweepSpec(
        name="accel-bench",
        base=base,
        grids=(mod.SweepSpec.grid(**{
            "workload.seed": (0, 1, 2, 3),
            "scheduler.policy": POLICIES,
            "scheduler.error_alpha": (0.0, 0.1, 0.3, 0.5),
        }),),
    )


def test_spec_ids_hashes_and_dicts_match_reference():
    from repro.scenarios import spec as ref_spec
    from repro_torch.scenarios import spec

    for full in (False, True):
        rb, pb = ref_presets.paper_fb_base(), presets.paper_fb_base()
        if not full:
            rb, pb = rb.quick(), pb.quick()
        ref_cells = _accel_matrix(ref_spec, rb).expand()
        cells = _accel_matrix(spec, pb).expand()
        assert len(cells) == 64
        assert [c for c, _ in cells] == [c for c, _ in ref_cells]
        for (_, s), (_, r) in zip(cells, ref_cells):
            assert s.to_dict() == r.to_dict()
            assert s.spec_hash() == r.spec_hash()
    ref_fig3 = ref_presets.get_preset("paper-fb").expand()
    fig3 = presets.get_preset("paper-fb").expand()
    assert [(c, s.spec_hash()) for c, s in fig3] == \
        [(c, s.spec_hash()) for c, s in ref_fig3]


_SYNTH_CASES = [
    (seed, policy, alpha)
    for seed in GOLDEN_SEEDS for policy in POLICIES for alpha in (0.0, 0.5)
]


def _assert_packed_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


@pytest.fixture(scope="module")
def _memo_workloads():
    """Generate each (workload, cluster) axis pair once per package: the
    synthesis cases differ only in policy and error model, and the
    generator's per-task host draws dominate their cost."""
    from repro.scenarios import runner as ref_runner
    from repro_torch.scenarios import runner

    def memoized(build):
        memo = {}

        def cached(spec):
            key = (spec.workload, spec.cluster)
            if key not in memo:
                memo[key] = build(spec)
            return memo[key]

        return cached

    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref_runner, runner):
            mp.setattr(mod, "build_workload", memoized(mod.build_workload))
        yield


@pytest.mark.parametrize("seed,policy,alpha", _SYNTH_CASES)
def test_synthesize_and_pack_bitwise_equal_reference(
        _memo_workloads, seed, policy, alpha):
    extra = {"scheduler.error_alpha": alpha, "scheduler.error_seed": seed}
    got = sweep_exec.synthesize_cell(_quick(presets, seed, policy, **extra))
    want = ref_exec.synthesize_cell(_quick(ref_presets, seed, policy, **extra))
    _assert_packed_equal(cell_step.pack_cells([got]),
                         ref_cell.pack_cells([want]))


def test_synthesize_fb_scaled_cell_bitwise_equal_reference():
    extra = {
        "workload.kind": "fb_scaled", "workload.num_jobs": 300,
        "cluster.num_machines": 30, "scheduler.error_alpha": 0.3,
    }
    got = sweep_exec.synthesize_cell(
        presets.paper_fb_base(seed=5).override(**extra))
    want = ref_exec.synthesize_cell(
        ref_presets.paper_fb_base(seed=5).override(**extra))
    packed = cell_step.pack_cells([got])
    assert packed["arrival"].shape == (1, 512)
    _assert_packed_equal(packed, ref_cell.pack_cells([want]))


# ---------------------------------------------------------------------------
# The cell run against the reference
# ---------------------------------------------------------------------------
_RUN_CELLS = [(seed, policy) for policy in POLICIES for seed in GOLDEN_SEEDS]


@pytest.fixture(scope="module")
def golden_batch():
    """One mixed-policy quick-scale batch through both packages; the
    port is fed the reference's own packed arrays."""
    packed = ref_cell.pack_cells([
        ref_exec.synthesize_cell(_quick(ref_presets, seed, policy))
        for seed, policy in _RUN_CELLS
    ])
    want = ref_cell.run_packed(packed, impl="lax")
    got = cell_step.run_packed(
        cell_step.params_from_numpy(packed, "cpu"), impl="torch"
    )
    return packed, got, want


@pytest.mark.parametrize("seed,policy", _RUN_CELLS)
def test_run_packed_matches_reference(golden_batch, seed, policy):
    packed, got, want = golden_batch
    i = _RUN_CELLS.index((seed, policy))
    assert int(got["steps"][i]) == int(want["steps"][i])
    assert got["done"][i].tobytes() == want["done"][i].tobytes()
    np.testing.assert_allclose(got["comp"][i], want["comp"][i], rtol=1e-9)
    g = cell_step.summarize(packed, got)[i]
    w = ref_cell.summarize(packed, want)[i]
    assert g["jobs_completed"] == w["jobs_completed"] == 30
    assert g["accel_steps"] == w["accel_steps"]
    assert g["mean_sojourn_s"] == pytest.approx(w["mean_sojourn_s"], rel=1e-9)


def test_padding_neutrality_and_determinism_bitwise():
    """Re-packing at a wider width moves no bit of the final state, and
    a rerun is bitwise equal."""
    cells = [
        sweep_exec.synthesize_cell(
            _quick(presets, 0, p, **{"workload.num_jobs": 12}))
        for p in ("hfsp", "srpt")
    ]
    narrow = cell_step.pack_cells(cells)
    wide = cell_step.pack_cells(cells, width=128)
    assert narrow["arrival"].shape[-1] < 128

    def run(packed):
        return cell_step.run_packed(
            cell_step.params_from_numpy(packed, "cpu"), t_chunk=128
        )

    a, b, again = run(narrow), run(wide), run(narrow)
    w = narrow["arrival"].shape[-1]
    for key in a:
        cut = b[key][:, :w] if b[key].ndim == 2 else b[key]
        assert a[key].tobytes() == cut.tobytes(), key
        assert a[key].tobytes() == again[key].tobytes(), key
    assert cell_step.summarize(narrow, a) == cell_step.summarize(wide, b)


def test_run_chunk_wraps_each_chunk_bitwise():
    """``run_packed(run_chunk=...)`` hands every chunk to the wrapper, once
    a chunk, and the wrapped run is bitwise the plain one."""
    packed = cell_step.pack_cells([
        sweep_exec.synthesize_cell(
            _quick(presets, 0, p, **{"workload.num_jobs": 12}))
        for p in ("hfsp", "srpt")
    ])
    params = cell_step.params_from_numpy(packed, "cpu")
    wrapped, seen = [], []

    def run_chunk(chunk, state):
        wrapped.append(int(state["steps"].max()))
        return chunk(state)

    got = cell_step.run_packed(params, t_chunk=64, run_chunk=run_chunk,
                               on_chunk=lambda n, *_: seen.append(n))
    want = cell_step.run_packed(params, t_chunk=64)
    assert len(wrapped) == len(seen) >= 2
    assert wrapped[0] == 0 and wrapped[1] <= 64
    for key in want:
        assert got[key].tobytes() == want[key].tobytes(), key


def test_run_sweep_accel_on_cpu_answers_every_cell():
    from repro_torch.scenarios.spec import SweepSpec

    sweep = SweepSpec(
        name="two",
        base=presets.paper_fb_base(seed=0).quick(),
        grids=(SweepSpec.grid(**{"scheduler.policy": ("fifo", "srpt")}),),
    )
    seen = []
    results = sweep_exec.run_sweep_accel(
        sweep, t_chunk=128, device="cpu",
        progress=lambda cid, res: seen.append(cid),
    )
    assert sorted(results) == sorted(seen) == [
        "scheduler.policy=fifo", "scheduler.policy=srpt",
    ]
    for cid, res in results.items():
        assert res["compute"] == "accel"
        assert res["jobs_completed"] == 30 and res["jobs_lost"] == 0
        assert res["spec"]["scheduler"]["policy"] == cid.split("=")[1]
        assert res["mean_sojourn_s"] > 0.0


#: tests/test_accel.py's bands of the fluid cell around the simulator:
#: mean sojourn by policy (relative) and makespan.
SOJOURN_TOL = {"fifo": 0.03, "srpt": 0.08, "hfsp": 0.10, "las": 0.18}
MAKESPAN_TOL = 0.02


def test_accel_cells_within_the_fidelity_bands_of_the_simulator():
    """The port's fluid cells against the port's own discrete-event runs
    of the same specs (seed 0, each accel policy), in the reference's
    bands."""
    from repro_torch.scenarios.runner import run_scenario

    specs = [_quick(presets, 0, policy) for policy in POLICIES]
    accel = sweep_exec.run_cells_accel(specs, t_chunk=128, device="cpu")
    for spec, fluid in zip(specs, accel):
        sim = run_scenario(spec, device="cpu")
        policy = spec.scheduler.policy
        assert fluid["jobs_completed"] == sim["jobs_completed"] == 30
        assert fluid["mean_sojourn_s"] == pytest.approx(
            sim["mean_sojourn_s"], rel=SOJOURN_TOL[policy]), policy
        assert fluid["makespan_s"] == pytest.approx(
            sim["makespan_s"], rel=MAKESPAN_TOL), policy


# ---------------------------------------------------------------------------
# Eligibility, device rule, import isolation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis,value", [
    ("scheduler.policy", "fair"),
    ("workload.task_jitter", 0.3),
    ("scheduler.preemption", "kill"),
    ("faults.task_fail_rate", 0.05),
])
def test_eligibility_refusals_carry_reasons(axis, value):
    base = presets.paper_fb_base(seed=0).quick()
    assert sweep_exec.accel_eligible(base) == (True, "")
    ok, reason = sweep_exec.accel_eligible(base.override(**{axis: value}))
    want = ref_exec.accel_eligible(
        ref_presets.paper_fb_base(seed=0).quick().override(**{axis: value}))
    assert (ok, reason) == want
    assert not ok and reason


def test_run_sweep_accel_runs_the_ineligible_cell_through_the_simulator():
    """A mixed fifo/fair sweep: fifo in the accel batch, fair (not
    accel-eligible) through the port's simulator on the same device;
    both equal the reference's ``run_sweep_accel`` apart from the wall
    time (the accel cell's floats at ``rel=1e-9``, as above)."""
    from repro.scenarios.spec import SweepSpec as RefSweepSpec
    from repro_torch.scenarios.spec import SweepSpec

    grid = {"scheduler.policy": ("fifo", "fair")}
    got = sweep_exec.run_sweep_accel(SweepSpec(
        name="mixed", base=presets.paper_fb_base(seed=0).quick(),
        grids=(SweepSpec.grid(**grid),)), t_chunk=128, device="cpu")
    want = ref_exec.run_sweep_accel(RefSweepSpec(
        name="mixed", base=ref_presets.paper_fb_base(seed=0).quick(),
        grids=(RefSweepSpec.grid(**grid),)), t_chunk=128)
    assert sorted(got) == sorted(want) == [
        "scheduler.policy=fair", "scheduler.policy=fifo"]
    for res in (*got.values(), *want.values()):
        res.pop("wall_s")
    fair, ref_fair = got["scheduler.policy=fair"], want["scheduler.policy=fair"]
    assert "compute" not in fair and fair["jobs_completed"] == 30
    assert fair == ref_fair
    fifo, ref_fifo = got["scheduler.policy=fifo"], want["scheduler.policy=fifo"]
    assert fifo["compute"] == "accel" and fifo.keys() == ref_fifo.keys()
    for key, value in fifo.items():
        if isinstance(value, float):
            assert value == pytest.approx(ref_fifo[key], rel=1e-9), key
        else:
            assert value == ref_fifo[key], key


def test_cuda_impl_on_cpu_tensors_raises():
    packed = cell_step.pack_cells(
        [sweep_exec.synthesize_cell(_quick(presets, 0, "hfsp"))])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cell_step.run_packed(cell_step.params_from_numpy(packed, "cpu"),
                             impl="cuda")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _quick(presets, 0, "fifo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_exec.run_cells_accel([spec])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cell_step.params_from_numpy(
            cell_step.pack_cells([sweep_exec.synthesize_cell(spec)]))


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    seen = set(proc.stdout.split())
    assert len(seen) >= 30
    # The discrete-event path's modules are among them.
    assert {f"repro_torch.core.{m}" for m in (
        "vcluster_torch", "projection", "vcluster", "types", "estimator",
        "scheduler", "disciplines", "fifo", "fair", "hfsp", "faults",
        "simulator", "metrics")} | {f"repro_torch.scenarios.{m}" for m in (
            "report", "runner", "trace", "lease", "store", "coordinator",
            "sweep", "worker", "__main__")} | {
                f"repro_torch.service.{m}" for m in (
                    "protocol", "journal", "admission", "telemetry", "engine",
                    "master", "worker", "__main__")} <= seen
