"""Roofline analysis from a traced step (the port's copy of
``repro/utils/roofline.py``; no device required).

Sources
-------
* :func:`measure_traced` runs one step on DTensors whose local shards are
  ``meta`` tensors and counts, **per device** (on the local shards, as
  XLA's per-device program is counted):

  - FLOPs, by torch's own flop formulas (``torch.utils.flop_counter``:
    matrix products, convolutions, attention; elementwise ops count
    none);
  - bytes: each op's inputs read once and outputs written once, which is
    what an eager step moves (views and metadata ops move nothing);
  - collectives: one ``(op, result bytes, group size)`` per call of a
    ``c10d_functional`` collective;
  - memory: argument bytes (the local shards of the step's inputs),
    output bytes (the storages the outputs hold) and temp bytes (the peak
    of live local storage above the arguments, outputs live at the peak
    included).  Storages are counted, not views; an in-place op
    allocates nothing.

  A dispatch mode wrapped around DTensor code sees each op at its
  *global* shapes.  So the counting is done one level down: every local
  shard is a :class:`CountingTensor`, a wrapper subclass that sees the
  ops DTensor runs on the shards; tensors made in the step outside any
  DTensor (masks, positions) are counted by a mode that wraps them the
  same way.  The trace runs no kernel: the model's plain routes only.
  Depth costs extrapolate linearly, as the reference's do (an eager trace
  counts every layer, so at a fixed chunking the extrapolation is exact).

* Collectives charge ring wire-bytes per device, from each call's result
  bytes Z and group size n:

    all-reduce          2 * Z * (n-1)/n
    all-gather          Z * (n-1)/n
    reduce-scatter      Z * (n-1)                (operand = n * result)
    all-to-all          Z * (n-1)/n
    any other           Z

  The ``c10d_functional`` names map onto the reference's: ``all_reduce``
  -> all-reduce, ``all_gather_into_tensor`` -> all-gather,
  ``reduce_scatter_tensor`` -> reduce-scatter, ``all_to_all_single`` ->
  all-to-all; any other collective keeps its own name.

Hardware constants: NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU
data sheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3,
NVLink 4 at 900 GB/s per GPU both directions together, 450 GB/s each way.
One NVLink domain holds 8 GPUs: a 16-way "model" axis (and any "data" or
"pod" axis) crosses it, and there the rate per GPU falls to the
network's, so the collective term is optimistic.

Terms (seconds, per device):
  compute    = FLOPs / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = collective_wire_bytes / LINK_BW
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 data sheet.
PEAK_FLOPS = 989e12     # bf16 dense, tensor cores, per GPU
HBM_BW = 3.35e12        # bytes/s HBM3 per GPU
LINK_BW = 450e9         # bytes/s NVLink 4 per GPU per direction

#: ``c10d_functional`` collective -> the reference's (XLA's) op name.
COLLECTIVE_NAMES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class CollectiveStats:
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_op.values()))

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def scaled(self, factor_by: dict | None = None):
        return self


def wire_bytes(op: str, z: float, n: int) -> float:
    """Ring wire bytes per device of one collective (module docstring):
    ``op`` under the reference's name, ``z`` its result bytes, ``n`` its
    group size."""
    if op == "all-reduce":
        return 2.0 * z * (n - 1) / max(n, 1)
    if op == "all-gather":
        return z * (n - 1) / max(n, 1)
    if op == "reduce-scatter":
        return z * (n - 1)
    if op == "all-to-all":
        return z * (n - 1) / max(n, 1)
    return float(z)


def collective_name(c10d_op: str) -> str:
    """The reference's name of a ``c10d_functional`` collective (its own
    name when it has none there)."""
    base = c10d_op.removesuffix("_")
    return COLLECTIVE_NAMES.get(base, base)


def collective_stats(calls) -> CollectiveStats:
    """Wire bytes and counts per op of ``calls``, each ``(op, result
    bytes, group size)`` with ``op`` a ``c10d_functional`` name."""
    stats = CollectiveStats()
    for op, z, n in calls:
        name = collective_name(op)
        stats.bytes_by_op[name] = (stats.bytes_by_op.get(name, 0)
                                   + wire_bytes(name, z, n))
        stats.count_by_op[name] = stats.count_by_op.get(name, 0) + 1
    return stats


@dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    collective_bytes: float      # per device, wire model
    collectives: CollectiveStats | None = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "coll_bytes": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def extrapolate_depth(r1: Roofline, r2: Roofline, u: int, L: int) -> Roofline:
    """Linear-in-depth extrapolation from depths u and 2u to L:
    cost(L) = base + L*body with body = (r2 - r1)/u, base = r1 - u*body."""

    def ext(a: float, b: float) -> float:
        body = (b - a) / u
        base = a - u * body
        return max(base + L * body, 0.0)

    stats = CollectiveStats()
    ops = set(r1.collectives.bytes_by_op) | set(r2.collectives.bytes_by_op)
    for op in ops:
        a = r1.collectives.bytes_by_op.get(op, 0.0)
        b = r2.collectives.bytes_by_op.get(op, 0.0)
        stats.bytes_by_op[op] = ext(a, b)
        ca = r1.collectives.count_by_op.get(op, 0)
        cb = r2.collectives.count_by_op.get(op, 0)
        stats.count_by_op[op] = int(round(ext(float(ca), float(cb))))
    return Roofline(
        flops=ext(r1.flops, r2.flops),
        bytes_accessed=ext(r1.bytes_accessed, r2.bytes_accessed),
        collective_bytes=ext(r1.collective_bytes, r2.collective_bytes),
        collectives=stats,
    )


def model_flops(cfg, shape, *, backward: bool) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (train) or 2·N·D (inference) with
    N = active params, D = tokens processed."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# Per-device counting on meta shards
# ---------------------------------------------------------------------------
class _Storage:
    """One local storage: its bytes count as live while any tensor over it
    lives."""

    __slots__ = ("nbytes", "__weakref__")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes


class _Count:
    """The running counts of one trace."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.calls: list[tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0

    def alloc(self, nbytes: int) -> _Storage:
        rec = _Storage(nbytes)
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(rec, self._free, nbytes)
        return rec

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes


_ACTIVE: list[_Count] = []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CountingTensor(torch.Tensor):
    """A wrapper over a ``meta`` tensor (``elem``) that counts every op run
    on it into the active trace, and shares a :class:`_Storage` record with
    the tensors that alias it."""

    elem: torch.Tensor
    storage_rec: _Storage

    @staticmethod
    def __new__(cls, elem: torch.Tensor, rec: _Storage):
        return torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=elem.device, requires_grad=elem.requires_grad)

    def __init__(self, elem: torch.Tensor, rec: _Storage):
        self.elem = elem
        self.storage_rec = rec

    def __repr__(self) -> str:
        return f"CountingTensor({tuple(self.shape)}, {self.dtype})"

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor first; its shards come back
        return _run_counted(func, args, kwargs or {})


def _unwrap(x):
    if type(x) is CountingTensor:
        return x.elem
    if type(x) in (list, tuple):
        return type(x)(_unwrap(v) for v in x)
    return x


def _tensors(xs) -> list:
    """The tensors among ``xs`` and the lists in it."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif type(x) in (list, tuple):
            out.extend(_tensors(x))
    return out


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


_GROUP_ARG: dict = {}


def _group_size(func, args, kwargs) -> int | None:
    """The group size of a collective op's call, None for any other op
    (a collective is an op that takes a ``group_name``)."""
    if func not in _GROUP_ARG:
        names = [a.name for a in func._schema.arguments]
        _GROUP_ARG[func] = (names.index("group_name")
                            if "group_name" in names else None)
    i = _GROUP_ARG[func]
    if i is None:
        return None
    from torch._C._distributed_c10d import _resolve_process_group

    name = args[i] if i < len(args) else kwargs["group_name"]
    return _resolve_process_group(name).size()


def _run_counted(func, args, kwargs):
    u_args = tuple(_unwrap(a) for a in args)
    u_kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    out = func(*u_args, **u_kwargs)
    if not _ACTIVE:
        return out
    count = _ACTIVE[-1]

    ins = _tensors((*args, *kwargs.values()))
    recs = {_storage_key(x.elem): x.storage_rec for x in ins
            if type(x) is CountingTensor}
    outs = _tensors((out,))
    if not getattr(func, "is_view", False):
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in flop_registry:
            count.flops += flop_registry[packet](*u_args, **u_kwargs,
                                                 out_val=out)
        out_bytes = sum(_nbytes(x) for x in outs)
        count.bytes += sum(_nbytes(x) for x in ins) + out_bytes
        n = _group_size(func, args, kwargs)
        if n is not None:
            count.calls.append((packet.__name__, out_bytes, n))

    def wrap(x):
        if type(x) is not torch.Tensor or x.device.type != "meta":
            return x
        key = _storage_key(x)
        rec = recs.get(key)
        if rec is None:
            rec = recs[key] = count.alloc(x.untyped_storage().nbytes())
        return CountingTensor(x, rec)

    if type(out) in (list, tuple):
        return type(out)(wrap(x) for x in out)
    return wrap(out)


class _CountPlain(TorchDispatchMode):
    """Counts the ops the step runs outside any DTensor (masks, positions,
    RoPE tables) and wraps the ``meta`` tensors they make; an op on
    DTensors passes through to DTensor, whose ops on the local shards the
    :class:`CountingTensor` shards count."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        return _run_counted(func, args, kwargs)


def count_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a ``meta`` tensor, or a DTensor over one) with its storage
    counted in the active trace: a DTensor gets a :class:`CountingTensor`
    local shard, a plain tensor becomes one.  Grad flags carry over."""
    from torch.distributed.tensor import DTensor

    count = _ACTIVE[-1]
    if isinstance(t, DTensor):
        loc = t.to_local()
        ct = CountingTensor(loc.detach(), count.alloc(_nbytes(loc)))
        out = DTensor.from_local(ct, t.device_mesh, t.placements,
                                 run_check=False, shape=t.shape,
                                 stride=t.stride())
    else:
        out = CountingTensor(t.detach(), count.alloc(_nbytes(t)))
    return out.requires_grad_(t.requires_grad)


@dataclass
class Traced:
    """The per-device counts of one traced step."""

    roofline: Roofline
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    calls: list


class Trace:
    """One counting trace: build the step's inputs with :meth:`count` (the
    argument bytes are what they hold), then :meth:`run` the step once."""

    def __init__(self):
        self._count = _Count()

    def __enter__(self):
        _ACTIVE.append(self._count)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self._count)

    def count(self, tree):
        """A tree of tensors (dicts, a ParamTree, DTensors or meta
        tensors) with every leaf's storage counted as an argument."""
        from repro_torch.models.params import ParamTree

        if isinstance(tree, ParamTree):
            grad = any(p.requires_grad for p in tree.parameters())
            return ParamTree(self.count(tree.to_dict()), requires_grad=grad)
        if isinstance(tree, dict):
            return {k: self.count(v) for k, v in tree.items()}
        return count_tensor(tree)

    def run(self, fn, *args) -> Traced:
        """``fn(*args)`` once, counted."""
        c = self._count
        args_bytes = c.live
        c.peak = c.live
        with _CountPlain():
            out = fn(*args)
        seen, out_bytes = set(), 0
        for x in _locals(out):
            if isinstance(x, CountingTensor) and \
                    id(x.storage_rec) not in seen:
                seen.add(id(x.storage_rec))
                out_bytes += x.storage_rec.nbytes
        stats = collective_stats(c.calls)
        roof = Roofline(flops=c.flops, bytes_accessed=c.bytes,
                        collective_bytes=stats.total_bytes,
                        collectives=stats)
        return Traced(roof, args_bytes, out_bytes, c.peak - args_bytes,
                      list(c.calls))


def _locals(tree) -> list:
    """The local shards of every tensor in ``tree`` (dicts, ParamTrees,
    tuples and lists nested in any order)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import ParamTree

    if isinstance(tree, (dict, ParamTree)):
        return [x for v in tree.items() for x in _locals(v[1])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree]


def measure_traced(fn, *args) -> Traced:
    """Count ``fn(*args)`` per device (module docstring): ``args`` are
    trees of DTensors over ``meta`` shards or ``meta`` tensors; their
    storages are the argument bytes."""
    with Trace() as tr:
        return tr.run(fn, *(tr.count(a) for a in args))


__all__ = [
    "HBM_BW", "LINK_BW", "PEAK_FLOPS", "CollectiveStats", "CountingTensor",
    "Roofline", "Trace", "Traced", "collective_name", "collective_stats",
    "extrapolate_depth", "measure_traced", "model_flops", "wire_bytes",
]
