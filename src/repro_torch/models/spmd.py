"""The model's ops on a device mesh: where an operand is a DTensor, each
runs as GSPMD partitions the reference's op, and as it is on plain
tensors (the same call, so the numbers without a mesh do not change).

DTensor's own rules for these ops either pick another layout than GSPMD
(the unembedding, the vocab mask, the loss), or fail on some DTensor
versions (attention's batched products with batch and heads both
sharded, the lookup in a vocab-sharded table, ``F.pad``).  The dry-run
(:mod:`repro_torch.launch.dryrun`) traces the model through these.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def on_mesh(t: torch.Tensor) -> bool:
    """True for a DTensor (a tensor laid out on a device mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *operands)``.  On a mesh (any operand a DTensor)
    the product is partitioned as GSPMD partitions it: each mesh dim keeps
    one subscript sharded (the one the largest operand shards there), the
    operands that carry it are split on it and the others stay whole, each
    device runs the einsum on its shards (``local_map``), and a subscript
    summed away leaves a partial sum.  DTensor's own rule flattens the
    batch subscripts into one dim, which some of its versions refuse when
    two of them are sharded (attention's batch and heads)."""
    if not any(on_mesh(o) for o in operands):
        return torch.einsum(eq, *operands)
    return _einsum_on_mesh(eq, operands)


def _einsum_on_mesh(eq: str, operands) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    subs, out = eq.replace(" ", "").split("->")
    subs = subs.split(",")
    mesh = next(o.device_mesh for o in operands if isinstance(o, DTensor))
    whole = [Replicate()] * mesh.ndim
    ops = []
    for o in operands:
        if not isinstance(o, DTensor):
            o = DTensor.from_local(o, mesh, whole, run_check=False)
        elif any(isinstance(p, Partial) for p in o.placements):
            o = o.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in o.placements])
        ops.append(o)
    by_size = sorted(range(len(ops)), key=lambda j: -ops[j].numel())
    letters = []
    for i in range(mesh.ndim):
        letter = None
        for j in by_size:
            p = ops[j].placements[i]
            if isinstance(p, Shard):
                letter = subs[j][p.dim]
                break
        letters.append(letter)

    def layout(sub):
        return [Shard(sub.index(c)) if c is not None and c in sub
                else Replicate() for c in letters]

    ins = [layout(sub) for sub in subs]
    ops = [o.redistribute(mesh, pl) for o, pl in zip(ops, ins)]
    res = [Shard(out.index(c)) if c is not None and c in out
           else Partial() if c is not None else Replicate() for c in letters]

    def local(*xs):
        xs = [_ContiguousGrad.apply(x) if x.requires_grad else x for x in xs]
        return torch.einsum(eq, *xs).contiguous()

    return local_map(local, res, in_placements=tuple(ins),
                     device_mesh=mesh)(*ops)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous.  DTensor views
    a shard as the whole tensor's layout says, and einsum (and its
    backward) may hand back permuted views."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def stack(tensors, dim: int = 0) -> torch.Tensor:
    """``torch.stack(tensors, dim)``.  On a mesh the parts first take one
    layout, the first part's with its partial sums summed: DTensor stacks
    only parts laid out alike, and cannot turn one kind of partial
    reduction into another."""
    if not on_mesh(tensors[0]):
        return torch.stack(tensors, dim)
    from torch.distributed.tensor import Partial, Replicate

    first = tensors[0]
    layout = tuple(Replicate() if isinstance(p, Partial) else p
                   for p in first.placements)
    return torch.stack([t if tuple(t.placements) == layout
                        else t.redistribute(first.device_mesh, layout)
                        for t in tensors], dim)


def pad_seq(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``x`` with ``pad`` entries of ``value`` after the end of dim 1
    (``F.pad``).  On a mesh, a concatenation with them: some versions of
    DTensor give ``F.pad`` a layout of the wrong length."""
    if not on_mesh(x):
        return F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad), value=value)
    tail = torch.full((x.shape[0], pad, *x.shape[2:]), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail], dim=1)


def lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``.  On a mesh whose vocab-sharded
    table is a DTensor, GSPMD's take: each shard looks up the rows it
    holds (zeros for the others) and the shards' rows are summed, one
    all-reduce.  (DTensor's own rule leaves a masked partial that some of
    its versions cannot carry through the ops and the backward that
    follow.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not on_mesh(table):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    rows = [i for i, pl in enumerate(table.placements)
            if isinstance(pl, Shard) and pl.dim == 0]
    if not rows:
        return F.embedding(tokens, table)
    coord = mesh.get_coordinate()
    shard = 0
    for i in rows:
        shard = shard * mesh.size(i) + coord[i]
    local = table.shape[0] // math.prod(mesh.size(i) for i in rows)
    lo = shard * local
    if not on_mesh(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    out = [Partial() if i in rows else tokens.placements[i]
           for i in range(mesh.ndim)]

    def take(tok, tab):
        idx = tok.long() - lo
        held = (idx >= 0) & (idx < tab.shape[0])
        got = F.embedding(torch.where(held, idx, 0), tab)
        return got * held[..., None].to(got.dtype)

    rows_out = local_map(take, out, in_placements=(
        tokens.placements, table.placements), device_mesh=mesh)(tokens,
                                                                table)
    return rows_out.redistribute(mesh, [
        Replicate() if isinstance(pl, Partial) else pl for pl in out])


def unembed_input(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """On a mesh, the DTensor ``x`` laid out for ``x @ w`` as GSPMD lays
    it out: whole over every mesh dim that shards ``w``, its batch (first)
    dim sharded as before over the others.  The vocab-sharded unembedding
    then yields vocab-sharded logits; DTensor's own choice, with x's
    batch split over the model axis too, leaves every device a partial
    sum of the whole vocab.  A plain ``x`` as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not on_mesh(x):
        return x
    keep = [Replicate() if isinstance(wp, Shard)
            else xp if isinstance(xp, Shard) and xp.dim == 0
            else Replicate()
            for xp, wp in zip(x.placements, w.placements)]
    return x.redistribute(x.device_mesh, keep)


def like_last_dim(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The 1-D ``v`` laid out as the last dim of the DTensor ``x`` (so an
    elementwise op keeps x's layout instead of gathering it); as it is
    when ``x`` is a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not on_mesh(x):
        return v
    mesh = x.device_mesh
    last = [Shard(0) if isinstance(p, Shard) and p.dim == x.ndim - 1
            else Replicate() for p in x.placements]
    whole = DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, last)
