"""The port's dry-run (``repro_torch.launch.dryrun``), its per-device
counts and the MoE group pin.

* ``main()`` at full width: olmo-1b x decode_32k with ``--skip-cost``
  writes the report (in this process, before the module's fake world);
  ``cost_from_scan`` is refused.
* ``lower_cell`` at SMOKE widths (``reduced``) on fake (2, 2) and
  (2, 2, 2) meshes: OK for every arch x shape that ``shape_applicable``
  admits and SKIP for the others (the multi-pod mesh traced on its
  (pod_data, model) flattening, or pod 0's slice for long_500k); on
  (2, 2, 2) the train shape for ``TWO_POD_TRAIN`` only.
* a report has the reference's keys; argument bytes are the local shard
  bytes of the step's inputs; at a fixed chunking the depth-u and
  depth-2u traces extrapolate to the full-depth trace's counts exactly.
* ``moe_ffn`` under a one-device mesh with ``moe_group_axis=("data",)``
  gives the output and aux loss of the run without a mesh, bit for bit;
  on a (2, 2) mesh the traced dispatch buffer carries ``Shard(0)`` over
  data (and its capacity dim over model with ``moe_capacity_axis``).

The fake world is built in a module-scoped fixture and destroyed with it.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh, use_mesh
from repro_torch.models import init_model, init_model_shapes
from repro_torch.models import moe
from repro_torch.sharding import specs

#: The train cells that also run on (2, 2, 2): the dense stack's and the
#: MoE's (its group pin over the flattened ("pod", "data")).  The other
#: train steps take the same DTensor paths as on (2, 2) and would take
#: this file past its budget; they are the CLI sweep's at full width.
TWO_POD_TRAIN = ("olmo_1b", "granite_moe_3b")

#: The keys of the reference's ``lower_cell`` report for an OK cell.
REPORT_KEYS = {
    "arch", "shape", "multi_pod", "chips", "status", "compile_s",
    "argument_bytes", "output_bytes", "temp_bytes", "cost_compile_s",
    "flops", "bytes", "coll_bytes", "compute_s", "memory_s",
    "collective_s", "dominant", "collective_counts",
    "collective_bytes_by_op", "model_flops", "useful_ratio",
}


# ---------------------------------------------------------------------------
# The CLI (no process group yet in this module)
# ---------------------------------------------------------------------------
def test_main_writes_a_full_width_report(tmp_path):
    assert not dist.is_initialized()
    out = tmp_path / "dryrun.json"
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                     "--skip-cost", "--out", str(out)])
    assert exit_.value.code == 0
    assert not dist.is_initialized()
    (report,) = json.loads(out.read_text())
    assert report["status"] == "OK" and report["chips"] == 256
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "compile_s"} <= set(report)
    # olmo-1b's f32 params over the model axis, the bf16 cache's batch
    # over data (and kv heads over model), the tokens and positions.
    assert report["argument_bytes"] > 0 and report["temp_bytes"] > 0


def test_main_refuses_cost_from_scan():
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--variants", "cost_from_scan"])
    assert exit_.value.code == 2
    assert not dryrun.VARIANTS


# ---------------------------------------------------------------------------
# Smoke cells on small fake meshes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def meshes():
    assert not dist.is_initialized()
    with fake_world(8):
        yield {False: make_mesh((2, 2), ("data", "model")),
               True: make_mesh((2, 2, 2), ("pod", "data", "model"))}
    assert not dist.is_initialized()


def _small(shape):
    return dataclasses.replace(
        shape, seq_len=32, global_batch=8 if shape.global_batch > 1 else 1)


def _cell(meshes, name, shape_name, multi, **kw):
    return dryrun.lower_cell(
        name, shape_name, multi_pod=multi, verbose=False,
        cfg=kw.pop("cfg", configs.reduced(configs.get_config(name))),
        shape=_small(configs.SHAPES[shape_name]), mesh=meshes[multi], **kw)


@pytest.mark.parametrize("name", configs.ARCHS)
def test_smoke_cells_trace(meshes, name):
    cfg = configs.reduced(configs.get_config(name))
    for shape_name, shape in configs.SHAPES.items():
        r = _cell(meshes, name, shape_name, False, skip_cost=True)
        want = "OK" if configs.shape_applicable(cfg, shape)[0] else "SKIP"
        assert r["status"] == want, (name, shape_name, r)
        if want == "OK":
            assert r["argument_bytes"] > 0 and r["temp_bytes"] >= 0
            assert r["chips"] == 4


@pytest.mark.parametrize("name", configs.ARCHS)
def test_smoke_cells_trace_on_two_pods(meshes, name):
    cfg = configs.reduced(configs.get_config(name))
    for shape_name, shape in configs.SHAPES.items():
        if shape.kind == "train" and name not in TWO_POD_TRAIN:
            continue
        r = _cell(meshes, name, shape_name, True, skip_cost=True)
        want = "OK" if configs.shape_applicable(cfg, shape)[0] else "SKIP"
        assert r["status"] == want, (name, shape_name, r)
        if want == "OK":
            assert r["argument_bytes"] > 0 and r["chips"] == 8


def test_report_has_the_reference_keys(meshes):
    r = _cell(meshes, "olmo_1b", "prefill_32k", False)
    assert set(r) == REPORT_KEYS
    assert r["dominant"] in ("compute", "memory", "collective")
    assert 0 < r["useful_ratio"]


def test_argument_bytes_are_the_local_shards(meshes):
    mesh = meshes[False]
    cfg = configs.reduced(configs.get_config("olmo_1b"))
    shape = _small(configs.SHAPES["prefill_32k"])
    r = _cell(meshes, "olmo_1b", "prefill_32k", False, skip_cost=True)
    params = init_model_shapes(cfg)
    pspecs = specs.param_specs(cfg, mesh, params)
    want = 0
    for path, leaf in _leaves(params).items():
        spec = _leaves(pspecs)[path]
        want += int(np.prod(specs.local_shape(mesh, spec, leaf.shape))) \
            * leaf.element_size()
    tokens = configs.input_specs(cfg, shape)["tokens"]
    want += int(np.prod(specs.local_shape(
        mesh, specs.batch_specs(cfg, mesh, shape)["tokens"],
        tokens.shape))) * tokens.element_size()
    assert r["argument_bytes"] == want


def _leaves(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "to_dict"):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def test_depth_extrapolation_is_exact_at_a_fixed_chunking(meshes):
    mesh = meshes[False]
    # A prefill: its layout does not hang on the depth.  (A train step's
    # optimizer update can: a layer stack of 1 does not split over the
    # data axis where a stack of 4 does.)
    cfg = configs.reduced(configs.get_config("olmo_1b"), num_layers=4)
    shape = _small(configs.SHAPES["prefill_32k"])
    full = dryrun.trace_cell(cfg, shape, mesh).roofline
    r1, r2 = (dryrun.trace_cell(dataclasses.replace(cfg, num_layers=n),
                                shape, mesh).roofline for n in (1, 2))
    ext = dryrun.extrapolate_depth(r1, r2, 1, 4)
    assert (ext.flops, ext.bytes_accessed, ext.collective_bytes) == (
        full.flops, full.bytes_accessed, full.collective_bytes)
    assert ext.collectives.count_by_op == full.collectives.count_by_op
    assert full.flops > 0 and full.collectives.total_count > 0


# ---------------------------------------------------------------------------
# The MoE group pin
# ---------------------------------------------------------------------------
def _moe_layer(name="granite_moe_3b", **kw):
    cfg = dataclasses.replace(configs.get_smoke(name), **kw)
    tree = init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    p = {k: v[0] if isinstance(v, torch.Tensor) else {
        kk: vv[0] for kk, vv in v.items()}
        for k, v in tree["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32))
    return cfg, p, x


def _whole(t, mesh, placements):
    return DTensor.from_local(t, mesh, placements, run_check=False)


def test_moe_on_one_device_mesh_is_bitwise_the_plain_run(meshes):
    cfg, p, x = _moe_layer(moe_groups=2)
    want, want_aux = moe.moe_ffn(cfg, p, x)
    mesh = make_mesh((1, 1), ("data", "model"))
    pinned = dataclasses.replace(cfg, moe_group_axis=("data",))
    rep = [Replicate(), Replicate()]
    dp = {k: _whole(v, mesh, rep) if isinstance(v, torch.Tensor) else
          {kk: _whole(vv, mesh, rep) for kk, vv in v.items()}
          for k, v in p.items()}
    with use_mesh(mesh), implicit_replication():
        got, aux = moe.moe_ffn(pinned, dp, _whole(x, mesh, [Shard(0),
                                                             Replicate()]))
    assert torch.equal(got.to_local(), want)
    assert torch.equal(aux.to_local(), want_aux)


@pytest.mark.parametrize("capacity", [None, "model"])
def test_moe_dispatch_buffer_is_pinned(meshes, monkeypatch, capacity):
    mesh = meshes[False]
    cfg = dataclasses.replace(configs.get_smoke("granite_moe_3b"),
                              moe_groups=2, moe_group_axis=("data",),
                              moe_capacity_axis=capacity)
    tree = {"moe": moe.init_moe(cfg, None)}
    p = specs.distribute_tree(tree, mesh,
                              specs.param_specs(cfg, mesh, tree))["moe"]
    x = specs.distribute(torch.empty(4, 16, cfg.d_model, device="meta"),
                         mesh, ("data", None, None))
    seen = []
    pin = moe._pin_groups

    def spy(cfg, t, capacity_dim=None):
        out = pin(cfg, t, capacity_dim)
        seen.append((capacity_dim, tuple(out.shape), out.placements))
        return out

    monkeypatch.setattr(moe, "_pin_groups", spy)
    with use_mesh(mesh), implicit_replication():
        out, _ = moe.moe_ffn(cfg, p, x)
    bufs = [s for s in seen if s[0] == 2]
    assert len(bufs) == 2        # the dispatch buffer and the experts' out
    want = (Shard(0), Shard(2) if capacity else Replicate())
    for _, shape, placements in bufs:
        assert shape[0] == 2 and placements == want
    assert all(s[2][0] == Shard(0) for s in seen)
    assert tuple(out.shape) == (4, 16, cfg.d_model)

