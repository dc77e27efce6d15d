"""The port's sharding rules, production meshes and roofline against the
JAX reference.

The reference's side runs its rules on ``jax.sharding.AbstractMesh``
(no devices) over ``jax.eval_shape`` of its init; the port's on the
production meshes in a fake process group of 512 ranks
(``repro_torch.launch.mesh.fake_world``) over ``init_model_shapes`` /
``init_train_state_shapes`` / ``init_cache(device="meta")``.  Held to
the reference, for all ten ``ARCHS`` at full width on (16, 16) and
(2, 16, 16):

* every leaf's spec (params; the train state with ``zero_opt`` off and
  on; the batch at every applicable shape; the decode cache at both
  decode shapes) equals the reference's ``PartitionSpec``;
* every leaf's local shape under the port's DTensor placements (as
  DTensor computes it) equals ``NamedSharding(...).shard_shape``;
* ``model_flops`` and ``extrapolate_depth`` give the reference's numbers,
  and the ring wire-bytes of the four collectives of the reference's
  HLO parsing test, stated as (op, dtype, shape, group size), equal what
  ``parse_collectives`` reads from that text.

And in the port: the per-device counts see local shapes (the matmul whose
global count a dispatch mode would give is 256 times too large), a
contraction over a sharded dim redistributed to replication counts one
all-reduce, and the host mesh refuses a missing card.  The fake world is
built in a module-scoped fixture and destroyed with it: the next test
file in the process finds no process group.
"""

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Replicate
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset,
)

import repro.configs as ref_configs
import repro.sharding.specs as ref_specs
import repro.utils.roofline as ref_roof
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro.train.step import init_train_state as ref_init_train_state
from repro_torch import DeviceError, configs
from repro_torch.launch.mesh import (
    close_host_mesh,
    fake_world,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.models import init_cache, init_model_shapes
from repro_torch.sharding import specs
from repro_torch.train import init_train_state_shapes
from repro_torch.utils import roofline

ARCHS = configs.ARCHS
REF_MESHES = {
    False: AbstractMesh((16, 16), ("data", "model")),
    True: AbstractMesh((2, 16, 16), ("pod", "data", "model")),
}


# ---------------------------------------------------------------------------
# The host mesh (no process group yet in this module)
# ---------------------------------------------------------------------------
def test_host_mesh_refuses_a_missing_card():
    assert not dist.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        make_host_mesh()
    assert not dist.is_initialized()


def test_host_mesh_on_the_cpu_is_one_device():
    mesh = make_host_mesh(device="cpu")
    try:
        assert mesh.device_type == "cpu"
        assert tuple(mesh.mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    finally:
        close_host_mesh()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The production meshes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def meshes():
    assert not dist.is_initialized()
    with fake_world():
        yield {False: make_production_mesh(),
               True: make_production_mesh(multi_pod=True)}
    assert not dist.is_initialized()


def test_production_meshes(meshes):
    assert tuple(meshes[False].mesh.shape) == (16, 16)
    assert meshes[False].mesh_dim_names == ("data", "model")
    assert tuple(meshes[True].mesh.shape) == (2, 16, 16)
    assert meshes[True].mesh_dim_names == ("pod", "data", "model")
    # The single-pod mesh is ranks 0..255 of the 512-rank world.
    assert meshes[False].mesh.flatten().tolist() == list(range(256))


def _norm(entry):
    """A spec entry as JAX normalises it: a one-name tuple is the name."""
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _flat(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "to_dict"):
        items = tree.items()
        out = {}
        for k, v in items:
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _check(mesh, ref_mesh, port_specs, ref_spec_tree, shapes):
    """Specs and local shapes of every leaf, port against reference."""
    port = _flat(port_specs)
    ref = {p: s for p, s in _flat(ref_spec_tree).items()}
    shp = _flat(shapes)
    assert set(port) == set(ref) == set(shp)
    for path, spec in port.items():
        want = ref[path]
        assert tuple(_norm(e) for e in spec) == tuple(
            _norm(e) for e in want), path
        shape = tuple(shp[path].shape)
        local, _ = compute_local_shape_and_global_offset(
            shape, mesh, specs.to_placements(mesh, spec))
        expect = tuple(NamedSharding(ref_mesh, want).shard_shape(shape))
        assert tuple(local) == expect, (path, local, expect)
        assert specs.local_shape(mesh, spec, shape) == expect, path


_REF_SHAPES: dict = {}


def _ref_shapes(name):
    if name not in _REF_SHAPES:
        cfg = ref_configs.get_config(name)
        key = jax.random.PRNGKey(0)
        _REF_SHAPES[name] = (
            jax.eval_shape(lambda: ref_init_model(cfg, key)),
            jax.eval_shape(lambda: ref_init_train_state(cfg, key)),
        )
    return _REF_SHAPES[name]


@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_match_reference(meshes, name):
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    params = init_model_shapes(cfg)
    ref_params, _ = _ref_shapes(name)
    for multi, mesh in meshes.items():
        rm = REF_MESHES[multi]
        _check(mesh, rm, specs.param_specs(cfg, mesh, params),
               ref_specs.param_specs(ref_cfg, rm, ref_params), params)


@pytest.mark.parametrize("zero_opt", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_state_specs_match_reference(meshes, name, zero_opt):
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    state = init_train_state_shapes(cfg)
    _, ref_state = _ref_shapes(name)
    for multi, mesh in meshes.items():
        rm = REF_MESHES[multi]
        _check(mesh, rm,
               specs.state_specs(cfg, mesh, state, zero_opt=zero_opt),
               ref_specs.state_specs(ref_cfg, rm, ref_state,
                                     zero_opt=zero_opt), state)


@pytest.mark.parametrize("name", ARCHS)
def test_batch_specs_match_reference(meshes, name):
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    n = 0
    for shape in configs.SHAPES.values():
        if not configs.shape_applicable(cfg, shape)[0]:
            continue
        ref_shape = ref_configs.SHAPES[shape.name]
        batch = configs.input_specs(cfg, shape)
        for multi, mesh in meshes.items():
            rm = REF_MESHES[multi]
            _check(mesh, rm, specs.batch_specs(cfg, mesh, shape),
                   ref_specs.batch_specs(ref_cfg, rm, ref_shape), batch)
            n += 1
    assert n >= 6


@pytest.mark.parametrize("name", ARCHS)
def test_cache_specs_match_reference(meshes, name):
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    for shape_name in ("decode_32k", "long_500k"):
        shape = configs.SHAPES[shape_name]
        ref_shape = ref_configs.SHAPES[shape_name]
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
        ref_cache = jax.eval_shape(lambda: ref_init_cache(
            ref_cfg, ref_shape.global_batch, ref_shape.seq_len))
        for multi, mesh in meshes.items():
            rm = REF_MESHES[multi]
            _check(mesh, rm,
                   specs.cache_specs_sharding(cfg, mesh, shape, cache),
                   ref_specs.cache_specs_sharding(ref_cfg, rm, ref_shape,
                                                  ref_cache), cache)


def test_to_placements_splits_pod_major(meshes):
    from torch.distributed.tensor import Shard

    mesh = meshes[True]
    assert specs.to_placements(mesh, (("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError):
        specs.to_placements(mesh, (("data", "pod"), None))
    x = specs.distribute(torch.empty(64, 4096, device="meta"), mesh,
                         (("pod", "data"), "model"))
    assert tuple(x.to_local().shape) == (2, 256)
    assert tuple(x.shape) == (64, 4096)


def test_distribute_tree_keeps_the_tree(meshes):
    mesh = meshes[False]
    cfg = configs.get_config("olmo_1b")
    state = init_train_state_shapes(cfg)
    out = specs.distribute_tree(state, mesh,
                                specs.state_specs(cfg, mesh, state))
    assert all(p.requires_grad for p in out["params"].parameters())
    emb = out["params"]["embed"]["embedding"]
    assert tuple(emb.to_local().shape) == (50304 // 16, 2048)
    assert tuple(out["opt"]["step"].to_local().shape) == ()


# ---------------------------------------------------------------------------
# Roofline against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_match_reference(name):
    cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
    for shape in configs.SHAPES.values():
        ref_shape = ref_configs.SHAPES[shape.name]
        for bw in (False, True):
            assert roofline.model_flops(cfg, shape, backward=bw) == \
                ref_roof.model_flops(ref_cfg, ref_shape, backward=bw)


def _pair(flops, nbytes, coll, by_op, counts):
    port = roofline.Roofline(flops, nbytes, coll, roofline.CollectiveStats(
        dict(by_op), dict(counts)))
    ref = ref_roof.Roofline(flops, nbytes, coll, ref_roof.CollectiveStats(
        dict(by_op), dict(counts)))
    return port, ref


@pytest.mark.parametrize("name", ARCHS)
def test_extrapolate_depth_matches_reference(name):
    from repro_torch.launch.dryrun import _depth_unit, _full_depth

    cfg = configs.get_config(name)
    u, L = _depth_unit(cfg), _full_depth(cfg)
    p1, r1 = _pair(3.5e12, 7.25e9, 1.5e8, {"all-reduce": 1.0e8,
                                           "all-gather": 5.0e7},
                   {"all-reduce": 9, "all-gather": 4})
    p2, r2 = _pair(6.25e12, 1.3e10, 2.75e8, {"all-reduce": 1.9e8,
                                             "reduce-scatter": 8.5e7},
                   {"all-reduce": 17, "reduce-scatter": 3})
    got = roofline.extrapolate_depth(p1, p2, u, L)
    want = ref_roof.extrapolate_depth(r1, r2, u, L)
    assert (got.flops, got.bytes_accessed, got.collective_bytes) == (
        want.flops, want.bytes_accessed, want.collective_bytes)
    assert got.collectives.bytes_by_op == want.collectives.bytes_by_op
    assert got.collectives.count_by_op == want.collectives.count_by_op


def test_wire_bytes_match_reference_hlo():
    import test_substrates

    want = ref_roof.parse_collectives(test_substrates.TestRooflineParsing.HLO)
    item = {torch.float32: 4, torch.bfloat16: 2}
    calls = [("all_reduce", torch.float32, (8, 128), 8),
             ("all_gather_into_tensor", torch.bfloat16, (16, 256), 4),
             ("reduce_scatter_tensor", torch.float32, (4, 64), 8),
             ("collective-permute", torch.float32, (32,), 2)]
    got = roofline.collective_stats(
        [(op, item[dt] * torch.Size(shape).numel(), n)
         for op, dt, shape, n in calls])
    assert got.count_by_op == want.count_by_op
    assert got.bytes_by_op == pytest.approx(want.bytes_by_op, rel=1e-12)


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    r = roofline.Roofline(flops=989e12, bytes_accessed=1.0,
                          collective_bytes=1.0)
    assert r.dominant == "compute" and r.compute_s == 1.0
    assert set(r.summary()) == set(ref_roof.Roofline(1, 1, 1).summary())


# ---------------------------------------------------------------------------
# Per-device counts
# ---------------------------------------------------------------------------
def _operands(mesh):
    bf = torch.bfloat16
    a = specs.distribute(torch.empty(64, 2048, device="meta", dtype=bf),
                         mesh, ("data", None))
    b = specs.distribute(torch.empty(2048, 8192, device="meta", dtype=bf),
                         mesh, (None, "model"))
    c = specs.distribute(torch.empty(8192, 256, device="meta", dtype=bf),
                         mesh, ("model", None))
    return a, b, c


def test_matmul_counts_local_flops(meshes):
    mesh = meshes[False]
    a, b, _ = _operands(mesh)
    t = roofline.measure_traced(lambda a, b: a @ b, a, b)
    # (64/16 x 2048) @ (2048 x 8192/16) on each device, 1/256 of the
    # global product's 2 * 64 * 2048 * 8192.
    assert t.roofline.flops == 2 * 4 * 2048 * 512 == 8388608
    assert t.calls == []
    assert t.argument_bytes == (4 * 2048 + 2048 * 512) * 2
    assert t.output_bytes == 4 * 512 * 2


def test_sharded_contraction_counts_one_all_reduce(meshes):
    mesh = meshes[False]
    a, b, c = _operands(mesh)

    def step(a, b, c):
        y = (a @ b) @ c        # contracts the model-sharded dim: partial
        return y.redistribute(mesh, [y.placements[0], Replicate()])

    t = roofline.measure_traced(step, a, b, c)
    z = 4 * 256 * 2            # the local (4, 256) bf16 result
    assert t.calls == [("all_reduce", z, 16)]
    stats = t.roofline.collectives
    assert stats.count_by_op == {"all-reduce": 1}
    assert stats.bytes_by_op["all-reduce"] == 2 * z * 15 / 16
    assert t.roofline.flops == 8388608 + 2 * 4 * 512 * 256
