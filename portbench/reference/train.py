"""Plain float32 train steps: a reference module's ``loss`` under
autograd, clipping by the global norm, and AdamW with a warmup and cosine
schedule, written from the update's equations.

The optimizer's settings come whole from the traffic file (``lr``,
``betas``, ``eps``, ``weight_decay``, ``grad_clip``, ``warmup_steps``,
``total_steps``, ``min_lr_ratio``); weight decay applies to matrices
only, not to norm scales.
"""

from __future__ import annotations

import math

import torch


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of update ``step`` (1 for the first), warmup then
    cosine decay."""
    if opt.get("schedule", "cosine") != "cosine":
        raise ValueError(f"schedule {opt['schedule']!r}: only cosine")
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    frac = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    decay = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (
        1 + math.cos(math.pi * frac))
    return opt["lr"] * warm * decay


def decayed(path: str) -> bool:
    return not path.endswith(".scale")


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def train(loss, model: dict, opt: dict, params: dict, batches, *,
          aux_weight: float = 0.0, rnd=_same):
    """Run one step per batch of ``batches`` ((tokens, labels) pairs) from
    ``params`` ({dotted path: f32 tensor}), ``loss(model, params tree,
    tokens, labels, aux_weight, rnd)`` the configuration's reference
    loss.  Returns (the loss of each
    step, the norm of each leaf's clipped gradient at the first step, the
    norm of each leaf's change over all the steps)."""
    b1, b2 = opt["betas"]
    p = {k: v.detach().float() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grads = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        leaves = {k: t.requires_grad_(True) for k, t in p.items()}
        total = loss(model, _tree(leaves), tokens, labels, aux_weight, rnd)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True)
        losses.append(float(total.detach()))
        with torch.no_grad():
            grads = {k: torch.zeros_like(t) if g is None else g
                     for (k, t), g in zip(leaves.items(), grads)}
            gnorm = math.sqrt(sum(float(g.square().sum())
                                  for g in grads.values()))
            clip = min(opt["grad_clip"] / max(gnorm, 1e-9), 1.0)
            grads = {k: g * clip for k, g in grads.items()}
            if first_grads is None:
                first_grads = {k: float(g.norm()) for k, g in grads.items()}
            lr = lr_at(opt, step)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            new = {}
            for k, t in leaves.items():
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g.square()
                delta = (m[k] / c1) / ((v2[k] / c2).sqrt() + opt["eps"])
                if decayed(k):
                    delta = delta + opt["weight_decay"] * t
                new[k] = t.detach() - lr * delta
            p = new
    with torch.no_grad():
        change = {k: float((p[k] - params[k].float()).norm()) for k in p}
    return losses, first_grads, change
