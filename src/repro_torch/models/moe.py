"""Mixture-of-Experts FFN (the port's copy of ``repro/models/moe.py``):
granite-moe (40 experts, top-8) and llama4-scout (16 experts, top-1 with
a shared expert).

Dispatch is capacity-based scatter/gather at fixed shapes, so no layer
waits on the host:

* router (f32) -> softmax -> the top k experts of each token, gates
  renormalised.  The top k come from a stable descending sort, which
  puts equal probabilities lower expert index first as ``jax.lax.top_k``
  does (``torch.topk`` promises no order among ties);
* position-in-expert via a one-hot cumsum over the choices in
  token-major, then choice, order; choices past the capacity
  ``C = max(1, ceil(g * k / E * capacity_factor))`` are dropped: their
  gate counts zero and the residual carries them (the Switch behaviour);
* dispatch: one ``scatter_add`` of each group's choices' rows into its
  own dense ``(E*C, d)`` rows of a ``(G, E, C, d)`` buffer (the group
  dim a batch dim, as the reference's vmapped scatter keeps it).  Each
  kept choice has a slot of its own; a dropped one adds zeros to slot 0
  of its expert, as the reference's scatter-add does;
* every expert's FFN as one batched product per weight over the
  expert-major ``(E, G*C, d)`` rows (``wg`` only for the ``*_glu``
  activations);
* combine: a per-group gather of each choice's row weighted by its gate,
  summed over the k contiguous rows of each token; the shared expert is
  added last.

On a mesh (``cfg.moe_group_axis`` set, under
:func:`repro_torch.launch.mesh.use_mesh`), the group dim is pinned to the
data-parallel axes at the reference's four sites: the grouped tokens,
the dispatch buffer, the experts' output buffer and the combined output
(the buffers' capacity dim too with ``cfg.moe_capacity_axis``).

A Switch-style load-balance loss ``E * sum_e f_e p_e`` is returned for
training.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import _act_fn, apply_mlp, dense_init, init_mlp
from repro_torch.models.spmd import einsum, on_mesh


def _pin_groups(cfg: ModelConfig, x: torch.Tensor,
                capacity_dim: int | None = None) -> torch.Tensor:
    """Anchor the leading group dim to the DP mesh axes (the reference's
    ``with_sharding_constraint``): on the ambient mesh
    (:func:`repro_torch.launch.mesh.use_mesh`), the DTensor ``x`` is
    redistributed to ``Shard(0)`` over ``cfg.moe_group_axis``, and with
    ``cfg.moe_capacity_axis`` set, the dispatch buffer's capacity dim
    (``capacity_dim``) over that axis too.  The identity without a group
    axis; an axis with no ambient mesh raises, as the reference's
    constraint needs a mesh."""
    if cfg.moe_group_axis is None:
        return x
    from repro_torch.launch.mesh import current_mesh
    from repro_torch.sharding.specs import to_placements

    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            f"moe_group_axis={cfg.moe_group_axis!r} pins the MoE groups to "
            "mesh axes, and there is no mesh: run the model under "
            "repro_torch.launch.mesh.use_mesh(mesh) on DTensors")
    dims: list = [None] * (x.ndim - 1)
    if capacity_dim is not None and cfg.moe_capacity_axis is not None:
        dims[capacity_dim - 1] = cfg.moe_capacity_axis
    spec = (tuple(cfg.moe_group_axis), *dims)
    return x.redistribute(mesh, to_placements(mesh, spec))


def _group(cfg: ModelConfig, x: torch.Tensor, G: int) -> torch.Tensor:
    """x: (b, s, d) as (G, g, d), the group dim pinned.  On a mesh the
    tokens' batch dim is pinned first, the layout GSPMD gives the
    reshape's input: DTensor reshapes a (b, s) split only when s is
    whole on each shard (and so its output again, on the way back)."""
    b, s, d = x.shape
    return _pin_groups(cfg, _pin_groups(cfg, x).reshape(G, b * s // G, d))


def init_moe(cfg: ModelConfig, gen: torch.Generator, *,
             layers: int | None = None) -> dict:
    d, e, dff = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    pref = () if layers is None else (layers,)
    p = {
        "router": dense_init(gen, (*pref, d, e), d, cfg.param_dtype),
        "wi": dense_init(gen, (*pref, e, d, dff), d, cfg.param_dtype),
        "wo": dense_init(gen, (*pref, e, dff, d), dff, cfg.param_dtype),
    }
    if cfg.act.endswith("_glu"):
        p["wg"] = dense_init(gen, (*pref, e, d, dff), d, cfg.param_dtype)
    if cfg.shared_expert_d_ff:
        p["shared"] = init_mlp(cfg, gen, cfg.shared_expert_d_ff, layers=layers)
    return p


class Routing(NamedTuple):
    """Where :func:`route` sends the tokens of one call."""

    groups: int           # G: tokens are routed in G groups of g
    capacity: int         # C: slots per expert and group
    gates: torch.Tensor   # (G, g, k) f32, renormalised
    idx: torch.Tensor     # (G, g, k) expert of each choice
    pos: torch.Tensor     # (G, g*k) position of each choice in its expert
    keep: torch.Tensor    # (G, g*k) bool: pos < capacity
    aux: torch.Tensor     # () f32 load-balance loss


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis in descending
    order, equal values lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, p, x: torch.Tensor) -> Routing:
    """The router, top-k, aux loss, capacity and kept set for x: (b, s, d).

    Group-limited routing (GShard-style): the tokens are reshaped to
    ``(G, g, d)`` with G = cfg.moe_groups (1 unless it divides the token
    count), and positions and capacity are per group."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.num_experts, cfg.top_k
    G = cfg.moe_groups if n % max(cfg.moe_groups, 1) == 0 else 1
    g = n // G
    xg = _group(cfg, x, G)

    probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    gates, idx = _top_k(probs, k)                        # (G, g, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = idx.reshape(G, g * k)
    onehot = F.one_hot(flat_e, e)                        # (G, gk, e)
    # Switch-style load-balance aux loss: e * sum_e f_e * p_e.
    me = probs.mean(dim=(0, 1))                          # mean router prob
    ce = onehot.sum(dim=(0, 1)).float() / (G * g * k)    # dispatch fraction
    aux = e * (me * ce).sum()

    capacity = max(1, int(math.ceil(g * k / e * cfg.capacity_factor)))
    # The running count scans the innermost axis: a scan along an outer
    # axis takes ~85% of a granite prefill on the card.
    pos = onehot.transpose(1, 2).contiguous().cumsum(-1).gather(
        1, flat_e[:, None, :])[:, 0] - 1
    return Routing(G, capacity, gates, idx, pos, pos < capacity, aux)


def _experts(cfg: ModelConfig, p, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on the (G, E, C, d) dispatch buffer.  One batched
    product per weight over the expert-major (E, G*C, d) rows; on a mesh
    the reference's einsums, partitioned as GSPMD partitions them (the
    group and capacity dims stay where the pins put them)."""
    G, e, C, d = buf.shape
    dtype = buf.dtype
    act = _act_fn(cfg.act)
    if on_mesh(buf):
        h = act(einsum("Gecd,edf->Gecf", buf, p["wi"].to(dtype)))
        if "wg" in p:
            h = h * einsum("Gecd,edf->Gecf", buf, p["wg"].to(dtype))
        return einsum("Gecf,efd->Gecd", h, p["wo"].to(dtype))
    rows = buf.transpose(0, 1).reshape(e, G * C, d)
    h = act(torch.bmm(rows, p["wi"].to(dtype)))
    if "wg" in p:
        h = h * torch.bmm(rows, p["wg"].to(dtype))
    return torch.bmm(h, p["wo"].to(dtype)).view(e, G, C, d).transpose(0, 1)


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    r = route(cfg, p, x)
    G, C = r.groups, r.capacity
    g = b * s // G
    dtype = x.dtype
    xg = _group(cfg, x, G)

    # Slot of each choice in its group's (E*C) buffer rows; a dropped
    # choice points at slot 0 of its expert and carries zeros there.
    safe_pos = torch.where(r.keep, r.pos, 0)
    slot = (r.idx.reshape(G, g * k) * C + safe_pos)[..., None].expand(
        G, g * k, d)
    keep = r.keep[..., None]

    # The k choices of token i are rows i*k..i*k+k-1, so the dispatch input
    # is a broadcast of the tokens and the combine a reshape-sum.  Every
    # group scatters into its own buffer, so G stays a batch dim.
    contrib = xg[:, :, None, :].expand(G, g, k, d).reshape(G, g * k, d)
    contrib = torch.where(keep, contrib, 0)
    buf = x.new_zeros((G, e * C, d)).scatter_add(1, slot, contrib)
    buf = _pin_groups(cfg, buf.view(G, e, C, d), capacity_dim=2)

    out_buf = _pin_groups(cfg, _experts(cfg, p, buf), capacity_dim=2)
    if cfg.moe_capacity_axis is not None and on_mesh(out_buf):
        from torch.distributed.tensor import Replicate, Shard

        # The gather reads a whole (E*C) row block of each group.
        out_buf = out_buf.redistribute(out_buf.device_mesh, [
            pl if pl == Shard(0) else Replicate()
            for pl in out_buf.placements])

    picked = out_buf.reshape(G, e * C, d).gather(1, slot)    # (G, gk, d)
    weight = r.gates.reshape(G, g * k, 1).to(dtype) * keep.to(dtype)
    out = _pin_groups(cfg, (picked * weight).view(G, g, k, d).sum(dim=2))

    if "shared" in p:
        out = out + apply_mlp(cfg, p["shared"], xg)
    # Pinned again as (b, s, d), so that the gradient reaches the reshape
    # in the layout it left in.
    return _pin_groups(cfg, out.reshape(b, s, d)), r.aux
