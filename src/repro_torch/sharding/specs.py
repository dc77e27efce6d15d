"""Sharding rules: DP / TP / EP / SP layouts for every arch family (the
port's copy of ``repro/sharding/specs.py``), on a
:class:`~torch.distributed.device_mesh.DeviceMesh`.

The mesh axes are ("data", "model") single-pod and ("pod", "data", "model")
multi-pod (see :mod:`repro_torch.launch.mesh`).  Parameters are
tensor-parallel over "model" and replicated over "data"/"pod"; batches are
data-parallel over ("pod", "data"); KV caches shard heads over "model" when
divisible, and the *sequence* axis over "data" when the batch is too small
to split (long_500k, batch=1 — the flash-decode layout).

Every rule degrades gracefully: an axis is applied only when the dimension
is divisible by the mesh axis size, otherwise that dim is replicated (e.g.
command-r's 8 kv heads on a 16-way model axis).

A spec is a tuple with one entry per tensor dimension, holding what the
reference's ``PartitionSpec`` holds: ``None`` (replicated), a mesh axis
name, or a tuple of names (the dimension split over all of them, the first
major).  :func:`to_placements` turns a spec into DTensor placements, one per
mesh dimension; :func:`distribute_tree` lays a parameter tree or a train
state out on the mesh by a spec tree.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.params import ParamTree

Spec = tuple


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(mesh: DeviceMesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= shape[a]
        return out
    return shape[axis]


def _shard_if(mesh: DeviceMesh, dim: int, axis) -> Any:
    """Return the axis name if ``dim`` divides evenly, else None."""
    return axis if dim % _axis_size(mesh, axis) == 0 else None


def dp_axes(mesh: DeviceMesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def _is_node(node) -> bool:
    return isinstance(node, (dict, ParamTree))


# ---------------------------------------------------------------------------
# Parameter specs (path-rule based)
# ---------------------------------------------------------------------------
def _leaf_spec(mesh: DeviceMesh, path: tuple[str, ...],
               shape: tuple[int, ...], cfg: ModelConfig | None = None
               ) -> Spec:
    name = path[-1]
    ctx = set(path)
    # leading layer axis from the stacked layers (decoder-only stacks use
    # "layers"; whisper uses "encoder"/"decoder")
    stacked = bool(ctx & {"layers", "encoder", "decoder"})
    lead = (None,) if stacked else ()

    def pspec(*dims):
        return (*lead, *dims)

    # -- embeddings -------------------------------------------------------
    if name == "embedding":
        return (_shard_if(mesh, shape[0], "model"), None)
    if name == "unembed":
        return (None, _shard_if(mesh, shape[-1], "model"))
    if name in ("enc_pos", "dec_pos"):
        return (None, None)

    # -- attention ----------------------------------------------------------
    if "attn" in ctx or "self_attn" in ctx or "cross_attn" in ctx:
        if name in ("wq", "wk", "wv"):
            return pspec(None, _shard_if(mesh, shape[-2], "model"), None)
        if name == "wo":
            return pspec(_shard_if(mesh, shape[-3], "model"), None, None)
        if name in ("bq", "bk", "bv"):
            return pspec(_shard_if(mesh, shape[-2], "model"), None)
        if name == "bo":
            return pspec(None)

    # -- MoE (expert weights; the shared expert is a plain MLP) -----------------
    if "moe" in ctx and "shared" not in ctx:
        if name == "router":
            return pspec(None, None)
        if name in ("wi", "wg"):   # (E, d, f): expert-local TP on f
            return pspec(None, None, _shard_if(mesh, shape[-1], "model"))
        if name == "wo":           # (E, f, d)
            return pspec(None, _shard_if(mesh, shape[-2], "model"), None)
        if name in ("bi",):
            return pspec(None, _shard_if(mesh, shape[-1], "model"))
        if name in ("bo",):
            return pspec(None, None)

    # -- MLP (incl. moe shared expert / zamba2 shared block) --------------------
    if "mlp" in ctx or "cmix" in ctx or "shared" in ctx:
        if name in ("wi", "wg", "wk"):   # (d, f)
            return pspec(None, _shard_if(mesh, shape[-1], "model"))
        if name in ("wo", "wv"):         # (f, d)
            return pspec(_shard_if(mesh, shape[-2], "model"), None)
        if name == "wr":                 # rwkv cmix receptance (d, d)
            return pspec(None, _shard_if(mesh, shape[-1], "model"))
        if name == "bi":
            return pspec(_shard_if(mesh, shape[-1], "model"))
        if name == "bo":
            return pspec(None)
        if name == "mu":
            return pspec(None, None)

    # -- RWKV time mix -----------------------------------------------------------
    if "tmix" in ctx:
        if name in ("wr", "wk", "wv", "wg"):   # (d, d): head-major out dim
            return pspec(None, _shard_if(mesh, shape[-1], "model"))
        if name == "wo":
            return pspec(_shard_if(mesh, shape[-2], "model"), None)
        if name == "bonus_u":                  # (h, dk)
            return pspec(_shard_if(mesh, shape[-2], "model"), None)
        if name in ("wd_a", "wd_b"):
            return pspec(None, None)
        if name in ("wd_bias", "ln_x_scale"):
            return pspec(_shard_if(mesh, shape[-1], "model"))
        if name == "mu":
            return pspec(None, None)

    # -- SSD (mamba2) ---------------------------------------------------------------
    if "ssd" in ctx:
        if name in ("wz", "wx"):               # (d, d_inner)
            return pspec(None, _shard_if(mesh, shape[-1], "model"))
        if name == "w_out":                    # (d_inner, d)
            return pspec(_shard_if(mesh, shape[-2], "model"), None)
        if name in ("conv_x_w",):              # (K, d_inner)
            return pspec(None, _shard_if(mesh, shape[-1], "model"))
        if name in ("conv_x_b", "norm_scale"):
            return pspec(_shard_if(mesh, shape[-1], "model"))
        if name in ("wB", "wC", "wdt", "conv_B_w", "conv_C_w",
                    "conv_B_b", "conv_C_b", "A_log", "D", "dt_bias"):
            return pspec(*(None,) * (len(shape) - (1 if stacked else 0)))

    # -- norms / everything small: replicate ------------------------------------------
    return (None,) * len(shape)


def param_specs(cfg: ModelConfig, mesh: DeviceMesh, params_shape) -> dict:
    """A spec tree matching ``params_shape`` (a :class:`ParamTree` or nested
    dicts of tensors, e.g. from
    :func:`repro_torch.models.init_model_shapes`)."""

    def walk(path, node):
        if _is_node(node):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return _leaf_spec(mesh, path, tuple(node.shape), cfg)

    return walk((), params_shape)


def state_specs(cfg: ModelConfig, mesh: DeviceMesh, state_shape, *,
                zero_opt: bool = False) -> dict:
    """{"params": ..., "opt": {"m","v","step"}} spec tree.

    ``zero_opt`` (ZeRO-2-style): Adam moments additionally shard their
    leading (layer-stack) dim over 'data' when divisible — gradients then
    reduce-scatter into the moment shards and the Adam update is 1/16th
    the work and memory per device; parameters stay replicated over data
    for a cheap forward."""
    pspecs = param_specs(cfg, mesh, state_shape["params"])

    def zero(spec_node, shape_node):
        if isinstance(spec_node, dict):
            return {k: zero(spec_node[k], shape_node[k]) for k in spec_node}
        dims = list(spec_node)
        shp = tuple(shape_node.shape)
        if (
            dims
            and dims[0] is None
            and len(shp) >= 2
            and shp[0] % _axis_size(mesh, "data") == 0
        ):
            dims[0] = "data"
            return tuple(dims)
        return spec_node

    mspecs = zero(pspecs, state_shape["params"]) if zero_opt else pspecs
    return {
        "params": pspecs,
        "opt": {"m": mspecs, "v": mspecs, "step": ()},
    }


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------
def batch_specs(cfg: ModelConfig, mesh: DeviceMesh, shape: ShapeConfig
                ) -> dict:
    dp = dp_axes(mesh)
    bdim = _shard_if(mesh, shape.global_batch, dp)
    out = {"tokens": (bdim, None)}
    if shape.kind == "train":
        out["labels"] = (bdim, None)
    if shape.kind == "decode":
        out["positions"] = (bdim,)
    if cfg.family == "vlm" and shape.kind != "decode":
        out["patch_embeds"] = (bdim, None, None)
    if cfg.family == "encdec" and shape.kind != "decode":
        out["frame_embeds"] = (bdim, None, None)
    return out


def cache_specs_sharding(cfg: ModelConfig, mesh: DeviceMesh,
                         shape: ShapeConfig, cache_shape) -> dict:
    """Sharding for the decode cache.  batch >= data => batch-shard;
    batch == 1 (long_500k) => shard the cache *sequence* over data
    (flash-decode: partial attention per shard, combined across shards)."""
    dp = dp_axes(mesh)
    b = shape.global_batch
    batch_ok = b % _axis_size(mesh, dp) == 0

    def leaf(path, node):
        name = path[-1]
        shp = tuple(node.shape)
        if name in ("k", "v", "shared_k", "shared_v", "xk", "xv"):
            # (L, b, S, kvh, hs)
            kvh_axis = _shard_if(mesh, shp[3], "model")
            if batch_ok:
                return (None, dp, None, kvh_axis, None)
            return (None, None, _shard_if(mesh, shp[2], "data"), kvh_axis,
                    None)
        if name == "ssm":       # (L, b, h, p, n)
            return (None, dp if batch_ok else None,
                    _shard_if(mesh, shp[2], "model"), None, None)
        if name == "S":         # rwkv (L, b, h, dk, dv)
            return (None, dp if batch_ok else None,
                    _shard_if(mesh, shp[2], "model"), None, None)
        if name in ("shift", "cmix_shift"):   # (L, b, d)
            return (None, dp if batch_ok else None, None)
        if name.startswith("conv_"):          # (L, b, K-1, c)
            return (None, dp if batch_ok else None, None,
                    _shard_if(mesh, shp[3], "model"))
        return (None,) * len(shp)

    def walk(path, node):
        if _is_node(node):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return leaf(path, node)

    return walk((), cache_shape)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------
def to_placements(mesh: DeviceMesh, spec: Spec) -> tuple:
    """The DTensor placements of ``spec``, one per mesh dimension (the
    counterpart of the reference's ``NamedSharding(mesh, spec)``).  A
    tensor dimension split over several axes, ``("pod", "data")``, is
    ``Shard(d)`` on each of them; DTensor splits it over the mesh
    dimensions in mesh order, so the first named axis must come first in
    the mesh too (JAX's major-to-minor order).  A mesh dimension of size 1
    splits nothing and stays ``Replicate()`` (DTensor will not reshape a
    dim sharded over it, where a dim of size 1 goes away)."""
    names = mesh.mesh_dim_names
    sizes = mesh.mesh.shape
    placements: list = [Replicate()] * len(names)
    used: set = set()
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r} splits dim {d} over {axes}, "
                             f"out of the mesh's order {names}")
        for i in order:
            if i in used:
                raise ValueError(f"spec {spec!r} uses axis {names[i]!r} "
                                 "twice")
            used.add(i)
            if sizes[i] > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def local_shape(mesh: DeviceMesh, spec: Spec, shape) -> tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` (every rule shards only evenly divisible dims)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axis_size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry!r} ({n})")
        out[d] //= n
    return tuple(out)


def distribute(t: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> DTensor:
    """``t`` as a DTensor on ``mesh`` laid out by ``spec``.  A ``meta``
    tensor becomes a DTensor over a ``meta`` local shard of its local
    shape (nothing allocated, no collective); any other tensor is split
    from its full value, which every rank holds (``distribute_tensor``
    with no source rank: no collective).  Grad flags carry over."""
    placements = to_placements(mesh, spec)
    if t.device.type == "meta":
        loc = torch.empty(local_shape(mesh, spec, t.shape), dtype=t.dtype,
                          device="meta")
        out = DTensor.from_local(loc, mesh, placements, run_check=False,
                                 shape=t.shape, stride=t.stride())
    else:
        # Every rank holds the whole tensor (a seeded init builds the same
        # tree on each): each keeps its own shard, nothing is sent.
        out = distribute_tensor(t.detach(), mesh, placements,
                                src_data_rank=None)
    return out.requires_grad_(t.requires_grad)


def distribute_tree(tree, mesh: DeviceMesh, specs):
    """A parameter tree (a :class:`ParamTree` or nested dicts) or a train
    state ``{"params", "opt"}`` laid out on ``mesh`` by the matching spec
    tree: a ParamTree gives a ParamTree of DTensor parameters (grads on
    as the input's are), nested dicts give nested dicts."""
    if isinstance(tree, ParamTree):
        grad = any(p.requires_grad for p in tree.parameters())
        return ParamTree(distribute_tree(tree.to_dict(), mesh, specs),
                         requires_grad=grad)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, specs[k])
                for k, v in tree.items()}
    return distribute(tree, mesh, specs)
