"""Multi-pod dry-run (the port's copy of ``repro/launch/dryrun.py``): trace
every (architecture x input-shape x mesh) cell on ``meta`` DTensors under a
fake process group (no allocation, no device), report the per-device
memory and costs, and emit the roofline terms.

The step under trace is the reference's choice, the plain routes:
``make_prefill_step`` with ``use_flash`` off, the rwkv and ssd scans off
their kernels, and ``make_train_step`` with the default configs.  No
kernel is traced, as the reference's dry-run lowers no Pallas call.  The
step runs inside ``implicit_replication()``: the model builds masks and
positions as plain tensors, which join the DTensors as replicated values.

Per cell, THREE traces, the reference's method:
1. full depth                  -> memory (argument/output/temp bytes);
2. depth u                     -> cost sample 1  (u = layer-pattern period)
3. depth 2u                    -> cost sample 2
and the costs at full depth extrapolated linearly from the two samples
(:func:`repro_torch.utils.roofline.extrapolate_depth`), so a report means
what the reference's means.  An eager trace counts every layer (and every
chunk), so for a config whose chunking does not change with depth the
extrapolation equals the full-depth count; the ssm and hybrid cost
samples take the reference's coarser ``inner_chunk``.  ``compile_s`` holds
the seconds of the full-depth trace.

The multi-pod mesh (pod=2, data=16, model=16) is traced on a 2-D mesh
with the same shards wherever one exists: on its flattening
(pod_data=32, model=16) over the same 512 ranks when every spec of the
cell names "pod" and "data" together, as ("pod", "data") (a dimension
split over both is then one mesh dimension instead of two), and on pod
0's (data=16, model=16) when no spec names "pod" (long_500k: batch 1
shards no batch dim; the pod axis only replicates).  DTensor's sharding
propagation over three mesh dimensions, two of them on one tensor
dimension, is far too slow to trace a model.  A cell whose specs name
"data" alone beside ("pod", "data") (the ``zero_opt`` moments on the
multi-pod mesh) is traced on the 3-D mesh itself.

Variants (``--variants``):
  serve_prefill     — prefill returns last-token logits only
  moe_capacity      — shard dispatch-buffer capacity dim; replicate experts
  zero_opt          — shard Adam moments' layer dim over data (ZeRO-2-ish)
``cost_from_scan`` (the reference's cost from the scanned compile, its
loop bodies counted once) means nothing for an eager trace, which has no
loop to count once, and is refused.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (
    ARCHS,
    SHAPES,
    get_config,
    input_specs,
    shape_applicable,
)
from repro_torch.launch.mesh import (
    PRODUCTION_WORLD,
    fake_world,
    make_mesh,
    make_production_mesh,
    use_mesh,
)
from repro_torch.models import decode_step, init_cache, init_model_shapes
from repro_torch.serve.engine import make_prefill_step
from repro_torch.sharding.specs import (
    batch_specs,
    cache_specs_sharding,
    distribute,
    distribute_tree,
    mesh_shape,
    param_specs,
    state_specs,
)
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    init_train_state_shapes,
    make_train_step,
)
from repro_torch.utils.roofline import (
    Trace,
    Traced,
    extrapolate_depth,
    model_flops,
)

#: The name of the flattened ("pod", "data") mesh dimension.
POD_DATA = "pod_data"


def _depth_unit(cfg) -> int:
    """Smallest depth whose per-layer costs repeat (the layer pattern)."""
    if cfg.family == "hybrid" and cfg.shared_attn_period:
        return cfg.shared_attn_period
    if cfg.local_global_period:
        return cfg.local_global_period
    return 1


def _at_depth(cfg, depth: int, *, scan: bool, seq_len: int = 4096):
    kw: dict = {"scan_layers": scan, "unroll_inner": not scan}
    if not scan and cfg.family in ("ssm", "hybrid"):
        # The reference's coarser chunks for its cost samples (<= 16 chunk
        # blocks per layer); intra-chunk flops are then an upper bound vs
        # the deployed 64-wide kernel blocks.
        kw["inner_chunk"] = max(256, seq_len // 16)
    if cfg.family == "encdec":
        kw.update(enc_layers=depth, dec_layers=depth, num_layers=2 * depth)
    else:
        kw.update(num_layers=depth)
    return dataclasses.replace(cfg, **kw)


def _full_depth(cfg) -> int:
    return cfg.enc_layers if cfg.family == "encdec" else cfg.num_layers


def _dp_size(mesh: DeviceMesh) -> int:
    shape = mesh_shape(mesh)
    n = shape["data"]
    if "pod" in shape:
        n *= shape["pod"]
    return n


VARIANTS: set = set()
KNOWN_VARIANTS = ("serve_prefill", "moe_capacity", "zero_opt")


def _cell_config(cfg, mesh: DeviceMesh):
    """``cfg`` as the cell runs it: for moe cells, group-limited routing
    with one group per DP shard, pinned to the DP axes."""
    if cfg.family == "moe":
        dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
        cfg = dataclasses.replace(cfg, moe_groups=_dp_size(mesh),
                                  moe_group_axis=dp)
        if "moe_capacity" in VARIANTS:
            cfg = dataclasses.replace(cfg, moe_capacity_axis="model")
    return cfg


def _cell_specs(cfg, shape, mesh: DeviceMesh) -> dict:
    """The shape-only inputs of the cell's step and their spec trees, on
    ``mesh`` by the reference's rules: {"args": [...], "specs": [...]}."""
    batch = input_specs(cfg, shape)
    bspecs = batch_specs(cfg, mesh, shape)
    if shape.kind == "train":
        state = init_train_state_shapes(cfg)
        sspecs = state_specs(cfg, mesh, state,
                             zero_opt="zero_opt" in VARIANTS)
        return {"args": [state, batch], "specs": [sspecs, bspecs]}
    params = init_model_shapes(cfg)
    pspecs = param_specs(cfg, mesh, params)
    if shape.kind == "prefill":
        return {"args": [params, batch], "specs": [pspecs, bspecs]}
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    cspecs = cache_specs_sharding(cfg, mesh, shape, cache)
    return {"args": [params, batch["tokens"], batch["positions"], cache],
            "specs": [pspecs, bspecs["tokens"], bspecs["positions"], cspecs]}


def _step(cfg, shape):
    """The cell's step.  Its carried state leaves in the layout it came in
    (the reference's ``out_shardings``: the train state by its specs, the
    decode cache by its own); the prefill's logits as they come."""
    if shape.kind == "train":
        train = make_train_step(cfg, OptimizerConfig(), TrainConfig())

        def step(state, batch):
            new, metrics = train(state, batch)
            return _in_layout(new, state), metrics

        return step
    if shape.kind == "prefill":
        return make_prefill_step(
            cfg, last_token_only="serve_prefill" in VARIANTS)

    @torch.no_grad()
    def decode(p, t, pos, c):
        logits, cache = decode_step(cfg, p, t, pos, c)
        return logits, _in_layout(cache, c)

    return decode


def _in_layout(out, like):
    """The DTensors of ``out`` redistributed to the placements of the
    matching leaves of ``like`` (same tree: dicts or ParamTrees)."""
    from repro_torch.models.params import ParamTree

    if isinstance(out, (dict, ParamTree)):
        tree = {k: _in_layout(v, like[k]) for k, v in out.items()}
        if isinstance(out, ParamTree):
            grad = any(p.requires_grad for p in out.parameters())
            return ParamTree(tree, requires_grad=grad)
        return tree
    return out.redistribute(like.device_mesh, like.placements)


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield tree


def _translate(tree):
    """A spec tree with each ("pod", "data") entry on the flattened dim."""
    if isinstance(tree, dict):
        return {k: _translate(v) for k, v in tree.items()}
    return tuple(POD_DATA if e == ("pod", "data") else e for e in tree)


def _entries(cfg, specs: list) -> list[tuple[str, ...]]:
    """The mesh axes each spec entry of the cell names (and the MoE pin)."""
    out = [tuple(cfg.moe_group_axis)] if cfg.moe_group_axis else []
    for tree in specs:
        for spec in _spec_leaves(tree):
            out.extend(((e,) if isinstance(e, str) else tuple(e))
                       for e in spec if e is not None)
    return out


def _trace_layout(cfg, shape, mesh: DeviceMesh):
    """(cfg, mesh, inputs, specs) the cell traces on.  A multi-pod cell
    that never names "pod" traces on the (data, model) mesh of pod 0 (the
    pod axis only replicates it); one that names pod and data only
    together, on the (pod_data, model) flattening, its specs rewritten
    onto it; any other on the 3-D mesh itself."""
    cell = _cell_specs(cfg, shape, mesh)
    args, specs = cell["args"], cell["specs"]
    if "pod" not in mesh.mesh_dim_names:
        return cfg, mesh, args, specs
    sh = mesh_shape(mesh)
    used = _entries(cfg, specs)
    if not any("pod" in e for e in used):
        return cfg, make_mesh((sh["data"], sh["model"]), ("data", "model")), \
            args, specs
    if all(e == ("pod", "data") for e in used if "pod" in e or "data" in e):
        flat = make_mesh((sh["pod"] * sh["data"], sh["model"]),
                         (POD_DATA, "model"))
        if cfg.moe_group_axis:
            cfg = dataclasses.replace(cfg, moe_group_axis=(POD_DATA,))
        return cfg, flat, args, [_translate(s) for s in specs]
    return cfg, mesh, args, specs


def _lay_out(args, specs, mesh):
    out = []
    for a, s in zip(args, specs):
        if isinstance(a, torch.Tensor):
            out.append(distribute(a, mesh, s))
        else:
            out.append(distribute_tree(a, mesh, s))
    return out


_REGISTERED: list = []


def _register_strategies() -> None:
    """DTensor sharding rules the model's ops need and some DTensor
    versions lack, registered once a process: ``flip`` (the backward of
    the rwkv and ssd scans' ``cumsum``) keeps any dim it does not flip
    sharded."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.flip.default)
    def flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None])
            for d in range(x.ndim) if d not in flipped]

    _REGISTERED.append(flip)


def trace_cell(cfg, shape, mesh: DeviceMesh) -> Traced:
    """One traced step of ``cfg`` (as :func:`_cell_config` left it) at
    ``shape`` on ``mesh``: the per-device counts."""
    _register_strategies()
    cfg, tmesh, args, specs = _trace_layout(cfg, shape, mesh)
    step = _step(cfg, shape)
    with Trace() as tr:
        inputs = [tr.count(a) for a in _lay_out(args, specs, tmesh)]
        with use_mesh(tmesh), implicit_replication():
            return tr.run(step, *inputs)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True, skip_cost: bool = False,
               cfg=None, mesh: DeviceMesh | None = None,
               shape=None) -> dict:
    """Trace one (arch, shape, mesh) cell; return the report (the
    reference's keys).  ``cfg``, ``shape`` and ``mesh`` stand in for the
    named config, shape and production mesh (a smoke config on a small
    mesh); the production mesh needs a :func:`fake_world` around the
    call."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "SKIP", "reason": reason}

    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = _cell_config(cfg, mesh)
    report = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              "chips": mesh.size()}

    # 1) full-depth trace: memory.
    t0 = time.time()
    full = trace_cell(cfg, shape, mesh)
    t_full = time.time() - t0
    report.update(
        status="OK",
        compile_s=round(t_full, 1),
        argument_bytes=full.argument_bytes,
        output_bytes=full.output_bytes,
        temp_bytes=full.temp_bytes,
    )

    if not skip_cost:
        # 2+3) cost samples at depths u and 2u -> extrapolate.
        u = _depth_unit(cfg)
        t0 = time.time()
        r1 = trace_cell(_at_depth(cfg, u, scan=False, seq_len=shape.seq_len),
                        shape, mesh).roofline
        r2 = trace_cell(_at_depth(cfg, 2 * u, scan=False,
                                  seq_len=shape.seq_len),
                        shape, mesh).roofline
        roof = extrapolate_depth(r1, r2, u, _full_depth(cfg))
        t_cost = time.time() - t0
        mflops = model_flops(cfg, shape, backward=(shape.kind == "train"))
        hlo_global = roof.flops * mesh.size()
        report.update(
            cost_compile_s=round(t_cost, 1),
            **roof.summary(),
            collective_counts=roof.collectives.count_by_op,
            collective_bytes_by_op={
                k: round(v) for k, v in roof.collectives.bytes_by_op.items()
            },
            model_flops=mflops,
            useful_ratio=(mflops / hlo_global) if hlo_global else None,
        )

    if verbose:
        print(f"[{arch} x {shape_name} x {'2pod' if multi_pod else '1pod'}] "
              f"OK trace={report['compile_s']}s", flush=True)
        print(f"  memory/device: args={report['argument_bytes']:,} "
              f"temp={report['temp_bytes']:,} out={report['output_bytes']:,}")
        if not skip_cost:
            print(f"  cost/device (depth-extrapolated): "
                  f"flops={report['flops']:.3e} bytes={report['bytes']:.3e}")
            print(f"  collectives: {report['collective_counts']} "
                  f"wire_bytes={report['coll_bytes']:.3e}")
            print(f"  roofline: compute={report['compute_s']*1e3:.2f}ms "
                  f"memory={report['memory_s']*1e3:.2f}ms "
                  f"collective={report['collective_s']*1e3:.2f}ms "
                  f"dominant={report['dominant']} "
                  f"useful={report['useful_ratio']:.3f}", flush=True)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-cost", action="store_true",
                    help="lowering/memory proof only (multi-pod pass)")
    ap.add_argument("--variants", default="",
                    help="comma-separated variants: "
                         "serve_prefill,moe_capacity,zero_opt")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    asked = {v for v in args.variants.split(",") if v}
    if "cost_from_scan" in asked:
        ap.error("cost_from_scan counts a scanned compile's loop bodies "
                 "once; an eager trace has no such loop, so its costs are "
                 "always the depth-extrapolated ones")
    unknown = asked - set(KNOWN_VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}; known: "
                 f"{', '.join(KNOWN_VARIANTS)}")
    VARIANTS.update(asked)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    reports = []
    failed = 0
    with fake_world(PRODUCTION_WORLD):
        for a, s, m in cells:
            try:
                reports.append(
                    lower_cell(a, s, multi_pod=m, skip_cost=args.skip_cost)
                )
            except Exception as e:  # a failure here is a bug in our sharding
                failed += 1
                traceback.print_exc()
                reports.append({"arch": a, "shape": s, "multi_pod": m,
                                "status": "FAIL", "error": str(e)[-2000:]})
            if args.out:  # incremental write: long sweeps survive interruption
                with open(args.out, "w") as f:
                    json.dump(reports, f, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    n_ok = sum(1 for r in reports if r["status"] == "OK")
    n_skip = sum(1 for r in reports if r["status"] == "SKIP")
    print(f"\ndry-run: {n_ok} OK, {n_skip} SKIP, {failed} FAIL "
          f"of {len(reports)} cells")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
