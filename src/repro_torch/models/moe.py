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
* dispatch: one ``index_add_`` of the choices' rows into a dense
  ``(E, G*C, d)`` buffer.  Each kept choice has a slot of its own; a
  dropped one adds zeros to slot 0 of its expert, as the reference's
  scatter-add does;
* every expert's FFN as one batched product per weight (``wg`` only for
  the ``*_glu`` activations);
* combine: a gather of each choice's row weighted by its gate, summed over
  the k contiguous rows of each token; the shared expert is added last.

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


def _pin_groups(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The reference's GSPMD constraint of the group dim to the mesh's
    data-parallel axes: the identity without a mesh axis.  The port has
    no mesh yet, so an axis raises."""
    if cfg.moe_group_axis is None:
        return x
    raise NotImplementedError(
        f"moe_group_axis={cfg.moe_group_axis!r} pins the MoE groups to a "
        "mesh axis, and the port has no device mesh yet: ROADMAP Queue 1 "
        "item 8 (sharding, mesh and dry-run)")


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
    xg = _pin_groups(cfg, x.reshape(G, g, d))

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


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    r = route(cfg, p, x)
    G, C = r.groups, r.capacity
    g = b * s // G
    dtype = x.dtype
    xg = x.reshape(G, g, d)

    # Slot of each choice in the (E, G*C) buffer rows; a dropped choice
    # points at slot 0 of its expert and carries zeros there.
    safe_pos = torch.where(r.keep, r.pos, 0)
    group = torch.arange(G, device=x.device)[:, None]
    slot = ((r.idx.reshape(G, g * k) * G + group) * C + safe_pos).reshape(-1)
    keep = r.keep.reshape(-1, 1)

    # The k choices of token i are rows i*k..i*k+k-1, so the dispatch input
    # is a broadcast of the tokens and the combine a reshape-sum.
    contrib = xg[:, :, None, :].expand(G, g, k, d).reshape(G * g * k, d)
    contrib = torch.where(keep, contrib, 0)
    buf = x.new_zeros((e * G * C, d)).index_add_(0, slot, contrib)
    buf = buf.view(e, G * C, d)

    act = _act_fn(cfg.act)
    h = act(torch.bmm(buf, p["wi"].to(dtype)))
    if "wg" in p:
        h = h * torch.bmm(buf, p["wg"].to(dtype))
    out_buf = torch.bmm(h, p["wo"].to(dtype)).view(e * G * C, d)

    picked = out_buf.index_select(0, slot)               # (G*gk, d)
    weight = r.gates.reshape(-1, 1).to(dtype) * keep.to(dtype)
    out = (picked * weight).view(G, g, k, d).sum(dim=2)

    if "shared" in p:
        out = out + apply_mlp(cfg, p["shared"], xg)
    return out.reshape(b, s, d), r.aux
