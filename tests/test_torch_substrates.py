"""The port's ML-job substrate (repro_torch.data, .checkpoint, .runtime,
configs.input_specs, attention.kv_cache_specs, workload.ml_dataset and
the ``ml`` workload kind) against the JAX reference's.

Held to the reference:

* ``SyntheticLM.batch`` bitwise for several (step, rank, num_ranks), and
  ``Prefetcher``'s order;
* checkpoints, both ways, bitwise: the port's snapshot of a train state
  (after a step, so the moments are not zero) restores in
  ``repro.checkpoint`` leaf for leaf, and the reference's snapshot of its
  own train state restores in the port, where the train step takes it
  on; plus ``keep``, ``latest``, ``save_async`` and a missing tag;
* ``input_specs`` and ``kv_cache_specs``: shapes and dtypes for each
  ported architecture and every shape of ``SHAPES``;
* ``ml_dataset`` for seeds 0-2, job for job;
* the ``ml-workload`` preset at ``--quick`` (every cell) and its full
  hfsp cell through ``run_scenario(device="cpu")``, with numpy and torch
  virtual clusters, and the quick sweep through the CLI: every report
  equals the reference's ``run_scenario`` report, wall time aside;
* the reference's three ``TestGangRuntime`` cases
  (tests/test_substrates.py) on the port, HFSP with ``vc_backend="torch",
  vc_device="cpu"``.

And in the port alone: a job that HFSP suspends (its train state offloaded
to the store and dropped, then restored) ends with the params, moments
and step of an uninterrupted ``make_train_step`` run, bitwise.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.configs as ref_configs
import repro.data as ref_data
import repro.train as ref_train
from repro.configs.base import input_specs as ref_input_specs
from repro.models.attention import kv_cache_specs as ref_kv_cache_specs
from repro.scenarios import presets as ref_presets
from repro.scenarios import runner as ref_runner
from repro.workload import ml_dataset as ref_ml_dataset
from repro_torch import configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import SHAPES, input_specs
from repro_torch.core import ClusterSpec, FIFOScheduler, HFSPConfig, HFSPScheduler
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.models.attention import kv_cache_specs
from repro_torch.models.params import tree_flatten
from repro_torch.runtime import GangRuntime, MLJob
from repro_torch.scenarios import __main__ as cli
from repro_torch.scenarios import presets
from repro_torch.scenarios.runner import run_scenario
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    init_train_state,
    make_train_step,
    train_state_to_device,
)
from repro_torch.workload import ml_dataset

ARCHS = ("olmo_1b", "rwkv6_1b6", "zamba2_2b7")


def _f32(mod, name):
    return dataclasses.replace(mod.get_smoke(name), dtype="float32")


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_synthetic_batches_match_reference(name):
    for seq, gb, seed in ((16, 8, 0), (72, 4, 3)):
        ours = SyntheticLM(configs.get_smoke(name),
                           DataConfig(seq_len=seq, global_batch=gb, seed=seed))
        ref = ref_data.SyntheticLM(ref_configs.get_smoke(name),
                                   ref_data.DataConfig(seq_len=seq,
                                                       global_batch=gb,
                                                       seed=seed))
        for step, rank, ranks in ((0, 0, 1), (3, 0, 2), (3, 1, 2), (7, 3, 4)):
            got, want = ours.batch(step, rank, ranks), ref.batch(step, rank,
                                                                 ranks)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(ours.probs, ref.probs)


def test_prefetcher_order():
    src = SyntheticLM(configs.get_smoke("olmo_1b"),
                      DataConfig(seq_len=8, global_batch=2))
    pf = Prefetcher(src, start_step=5, depth=2)
    got = [pf.next() for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], src.batch(s)["tokens"])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


@pytest.mark.parametrize("name", ARCHS)
def test_port_snapshot_restores_in_reference(tmp_path, name):
    cfg = _f32(configs, name)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=2)).batch(0)
    state, _ = make_train_step(cfg, OptimizerConfig(**OPT))(state, _tb(batch))
    CheckpointStore(str(tmp_path)).save("job", 1, state)
    step, tree = ref_ckpt.CheckpointStore(str(tmp_path)).restore("job")
    assert step == 1
    paths, ours = tree_flatten(state)
    theirs = jax.tree.leaves(tree)
    assert len(ours) == len(theirs)
    for path, a, b in zip(paths, ours, theirs):
        assert b.dtype == np.dtype(str(a.dtype).removeprefix("torch.")), path
        np.testing.assert_array_equal(a.detach().numpy(), b, err_msg=str(path))
    assert tree["opt"]["step"].dtype == np.int32 and int(tree["opt"]["step"]) == 1
    # The same leaves, under the same dotted paths as the port's tree.
    ref_paths = [tuple(k.key for k in p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert ref_paths == paths


@pytest.mark.parametrize("name", ARCHS)
def test_reference_snapshot_restores_in_port(tmp_path, name):
    ref_cfg, cfg = _f32(ref_configs, name), _f32(configs, name)
    state = ref_train.init_train_state(ref_cfg, jax.random.PRNGKey(0))
    batch = SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=2)).batch(0)
    step_fn = jax.jit(ref_train.make_train_step(
        ref_cfg, ref_train.OptimizerConfig(**OPT)))
    state, _ = step_fn(state, jax.tree.map(jnp.asarray, batch))
    ref_ckpt.CheckpointStore(str(tmp_path)).save("job", 1, state)
    step, tree = CheckpointStore(str(tmp_path)).restore("job")
    assert step == 1
    ours = train_state_to_device(tree, "cpu")
    paths, leaves = tree_flatten(ours)
    for path, a, b in zip(paths, leaves, jax.tree.leaves(state),
                          strict=True):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b),
                                      err_msg=str(path))
    assert all(p.requires_grad for p in ours["params"].parameters())
    assert ours["opt"]["step"].dtype == torch.int32
    new, metrics = make_train_step(cfg, OptimizerConfig(**OPT))(
        ours, _tb(batch))
    assert int(new["opt"]["step"]) == 2 and np.isfinite(float(metrics["loss"]))


def test_keep_latest_async_and_missing(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = {"a": torch.arange(5), "b": {"c": torch.ones((2, 2))}}
    for step in (1, 2, 3):
        store.save("t", step, tree)
    store.save("u", 9, tree)
    assert sorted(p.name for p in tmp_path.glob("t-*.npz")) == [
        "t-00000002.npz", "t-00000003.npz"]
    assert store.latest("t") == (3, store.path("t", 3))
    step, restored = store.restore("t")
    assert step == 3 and isinstance(restored["a"], np.ndarray)
    np.testing.assert_array_equal(restored["a"], np.arange(5))
    np.testing.assert_array_equal(restored["b"]["c"], np.ones((2, 2)))
    assert store.restore("t", step=1) is None  # collected
    assert store.restore("nope") is None and store.latest("nope") is None
    store.save_async("t", 7, {"x": torch.ones((3,))})
    store.wait()
    assert store.restore("t")[0] == 7
    # The reference reads the async snapshot, and keeps to ``keep``.
    assert ref_ckpt.CheckpointStore(str(tmp_path)).restore("t")[0] == 7
    assert len(list(tmp_path.glob("t-*.npz"))) == 2


# ---------------------------------------------------------------------------
# Shape stand-ins
# ---------------------------------------------------------------------------
def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("name", [*ARCHS, "starcoder2_3b"])
def test_input_and_kv_cache_specs_match_reference(name):
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    for shape_name, shape in SHAPES.items():
        for per_host in (None, 2):
            got = input_specs(cfg, shape, per_host_batch=per_host)
            want = ref_input_specs(ref_cfg, ref_configs.SHAPES[shape_name],
                                   per_host_batch=per_host)
            assert {k: _shape_dtype(v) for k, v in got.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())
        b = per_host or shape.global_batch
        got = kv_cache_specs(cfg, b, shape.seq_len, layers=cfg.num_layers)
        want = ref_kv_cache_specs(ref_cfg, b, shape.seq_len,
                                  layers=ref_cfg.num_layers)
        assert {k: _shape_dtype(v) for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())


# ---------------------------------------------------------------------------
# The ml workload and the ml-workload preset
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_ml_dataset_matches_reference(seed):
    got, got_cls = ml_dataset(seed=seed)
    want, want_cls = ref_ml_dataset(seed=seed)
    assert got_cls == want_cls
    assert [_plain(j) for j in got] == [_plain(j) for j in want]


def _plain(job):
    """A JobSpec as plain values (each package has its own Phase enum)."""
    return json.loads(json.dumps(dataclasses.asdict(job),
                                 default=lambda e: e.value))


def _no_wall(report):
    return {k: v for k, v in report.items() if k != "wall_s"}


def _ml_cells():
    """(cell id, port spec, reference spec): the quick sweep's cells and
    the full preset's hfsp cell."""
    out = []
    for quick in (True, False):
        ours, ref = presets.get_preset("ml-workload"), ref_presets.get_preset(
            "ml-workload")
        if quick:
            ours, ref = presets.quick_sweep(ours), ref_presets.quick_sweep(ref)
        for (cid, spec), (rcid, rspec) in zip(ours.expand(), ref.expand()):
            assert cid == rcid
            if quick or spec.scheduler.policy == "hfsp":
                out.append((f"{ours.name}/{cid}", spec, rspec))
    return out


@pytest.mark.parametrize("backend", ("numpy", "torch"))
def test_ml_workload_cells_match_reference(backend):
    for cid, spec, rspec in _ml_cells():
        want = ref_runner.run_scenario(rspec)
        got = run_scenario(spec.override(**{"scheduler.vc_backend": backend}),
                           device="cpu")
        assert got["jobs_completed"] == want["jobs_completed"] > 0
        got, want = _no_wall(got), _no_wall(want)
        got.pop("spec"), want.pop("spec")
        assert got == want, cid


def test_cli_runs_the_ml_workload_preset(tmp_path, capsys):
    out = tmp_path / "out.json"
    assert cli.main(["run", "ml-workload", "--quick", "--device", "cpu",
                     "--store", str(tmp_path / "s.jsonl"), "--json",
                     str(out)]) == 0
    assert "QUARANTINED" not in capsys.readouterr().out
    cells = json.loads(out.read_text())["cells"]
    ref = dict(ref_presets.quick_sweep(
        ref_presets.get_preset("ml-workload")).expand())
    assert set(cells) == set(ref)
    for cid, rspec in ref.items():
        assert _no_wall(cells[cid]) == _no_wall(json.loads(json.dumps(
            ref_runner.run_scenario(rspec)))), cid


# ---------------------------------------------------------------------------
# The gang runtime (the reference's TestGangRuntime cases, on the port)
# ---------------------------------------------------------------------------
def _hfsp(cluster):
    return HFSPScheduler(cluster, HFSPConfig(sample_set_size=1,
                                             vc_backend="torch",
                                             vc_device="cpu"))


def test_gang_two_jobs_hfsp(tmp_path):
    cluster = ClusterSpec(num_machines=1, map_slots_per_machine=1,
                          reduce_slots_per_machine=0)
    jobs = [
        MLJob(0, configs.get_smoke("olmo_1b"), total_steps=4,
              steps_per_quantum=2, arrival_time=0.0, name="a"),
        MLJob(1, configs.get_smoke("olmo_1b"), total_steps=2,
              steps_per_quantum=2, arrival_time=0.1, name="b", seed=1),
    ]
    rtm = GangRuntime(cluster, _hfsp(cluster), jobs,
                      CheckpointStore(str(tmp_path)), device="cpu")
    rep = rtm.run(max_wall_s=300)
    assert len(rep["sojourn"]) == 2
    assert all(v is not None for v in rep["losses"].values())


def test_gang_speculative_reexecution_on_spare_gang(tmp_path):
    cluster = ClusterSpec(num_machines=2, map_slots_per_machine=1,
                          reduce_slots_per_machine=0)
    jobs = [MLJob(0, configs.get_smoke("olmo_1b"), total_steps=8,
                  steps_per_quantum=2, arrival_time=0.0, name="slow")]
    # straggler_factor ~0: every quantum past the 3rd counts as a
    # straggler, forcing the speculative re-execution path.
    rtm = GangRuntime(cluster, FIFOScheduler(cluster), jobs,
                      CheckpointStore(str(tmp_path)), straggler_factor=1e-6,
                      device="cpu")
    rep = rtm.run(max_wall_s=300)
    st = rep["stats"]
    assert 0 in rep["sojourn"]          # job completed despite racing
    assert st["speculative"] >= 1
    # Every race was decided: exactly one winner per speculation.
    assert st["spec_wins"] + st["spec_losses"] == st["speculative"]
    # Speculative copies bypass suspend/kill bookkeeping entirely.
    assert st["offloads"] == 0 and st["kills"] == 0
    spec_events = [e for e in rep["events"] if e[1] == "speculative"]
    assert len(spec_events) == st["speculative"]
    # The shadow ran on the spare gang, never the suspect's own.
    for e in spec_events:
        suspect, spare = e[2].split(" ")[1].split("->")
        assert suspect != spare


def test_gang_failure_recovery(tmp_path):
    cluster = ClusterSpec(num_machines=1, map_slots_per_machine=1,
                          reduce_slots_per_machine=0)
    jobs = [MLJob(0, configs.get_smoke("olmo_1b"), total_steps=6,
                  steps_per_quantum=2, arrival_time=0.0, name="flaky")]
    # seed 2: rng draws 0.262, 0.298 < 0.4 => the first two quanta
    # fail deterministically, then recovery completes the job.
    rtm = GangRuntime(cluster, FIFOScheduler(cluster), jobs,
                      CheckpointStore(str(tmp_path)), fail_quantum_prob=0.4,
                      rng_seed=2, device="cpu")
    rep = rtm.run(max_wall_s=300)
    assert 0 in rep["sojourn"]          # completed despite failures
    assert rep["stats"]["failures"] >= 1


def test_suspended_job_ends_as_an_uninterrupted_run(tmp_path):
    """Two map slots on one machine: a quantum granted to a slot waits
    there until the runtime's next pass runs it, so a job that arrives
    meanwhile can make HFSP suspend it (with one slot, a granted quantum
    runs in the pass that grants it, and nothing is ever suspended)."""
    cluster = ClusterSpec(num_machines=1, map_slots_per_machine=2,
                          reduce_slots_per_machine=0)
    jobs = [MLJob(i, _f32(configs, name), total_steps=steps,
                  steps_per_quantum=2, arrival_time=0.02 * i, seed=i,
                  name=name)
            for i, (name, steps) in enumerate(zip(ARCHS, (8, 4, 2)))]
    rtm = GangRuntime(cluster, _hfsp(cluster), jobs,
                      CheckpointStore(str(tmp_path)), device="cpu")
    rep = rtm.run(max_wall_s=300)
    assert sorted(rep["sojourn"]) == [0, 1, 2]
    assert rep["stats"]["offloads"] >= 1 and rep["stats"]["restores"] >= 1
    for job in jobs:
        step = make_train_step(job.cfg, OptimizerConfig(
            warmup_steps=5, total_steps=job.total_steps),
            TrainConfig(remat="none"))
        state = init_train_state(job.cfg,
                                 torch.Generator().manual_seed(job.seed),
                                 "cpu")
        data = SyntheticLM(job.cfg, DataConfig(seq_len=job.seq_len,
                                               global_batch=job.global_batch,
                                               seed=job.seed))
        for s in range(job.total_steps):
            state, _ = step(state, _tb(data.batch(s)))
        got = rtm.rt[job.job_id].state
        for a, b in zip(tree_flatten(got)[1], tree_flatten(state)[1],
                        strict=True):
            assert torch.equal(a, b), job.name
