"""AdamW by hand (the port's copy of ``repro/train/optimizer.py``), plus
LR schedules, global-norm clipping and int8 gradient compression.

The optimizer state is a plain tree ``{"m": ..., "v": ..., "step": ...}``
of the parameters' structure (nested dicts of f32 tensors; ``step`` a
0-d int32), checkpointable with :mod:`repro_torch.checkpoint`.

Every function here is pure: it returns new tensors and leaves the trees
it was given as they were.  The gang runtime relies on that: a
speculative re-execution restarts a quantum from the pre-quantum state
it still holds (:mod:`repro_torch.runtime.gang`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.params import as_dict, tree_flatten, tree_unflatten


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | linear | constant
    min_lr_ratio: float = 0.1
    # Beyond-paper distributed trick: quantize gradients to int8 (with a
    # per-leaf fp32 scale) before the DP all-reduce, dequantize after.
    grad_compression: str | None = None   # None | "int8"


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32 on its device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1),
            0.0, 1.0,
        )
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * frac)
            )
        else:  # linear
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    return cfg.lr * warm * decay


def init_opt_state(params) -> dict:
    """Zero moments in the parameters' structure and dtype, step 0."""
    _, leaves = tree_flatten(params)
    device = leaves[0].device if leaves else None

    def zeros():
        return tree_unflatten(as_dict(params), [
            torch.zeros_like(p, requires_grad=False) for p in leaves])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled so that their global L2 norm is at most
    ``max_norm``; returns (clipped tree, the norm before clipping)."""
    _, leaves = tree_flatten(grads)
    out, gnorm = _clip(leaves, max_norm)
    return tree_unflatten(as_dict(grads), out), gnorm


def _clip(leaves: list, max_norm: float) -> tuple[list, torch.Tensor]:
    with torch.no_grad():
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves))
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        return [(g * scale).to(g.dtype) for g in leaves], gnorm


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization (gradient compression)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _is_decayed(path: tuple) -> bool:
    """Weight decay applies to matmul weights only — not norms, biases,
    decay vectors or bonus terms."""
    last = str(path[-1])
    no_decay = (
        "scale", "bias", "mu", "bonus_u", "A_log", "D", "dt_bias",
        "ln_x_scale", "norm_scale", "wd_bias",
    )
    return not any(last.startswith(n) or last.endswith(n) for n in no_decay)


def adamw_update(
    cfg: OptimizerConfig, params, grads, opt_state
) -> tuple[object, dict, dict]:
    """One AdamW step.  Returns (new_params, new_opt_state, metrics); the
    new params have ``params``' structure (a ParamTree stays one, its
    gradients on as they were)."""
    paths, ps = tree_flatten(params)
    _, gs = tree_flatten(grads)
    _, ms = tree_flatten(opt_state["m"])
    _, vs = tree_flatten(opt_state["v"])
    with torch.no_grad():
        gs = [g.float() for g in gs]
        gs, gnorm = _clip(gs, cfg.grad_clip)
        step = opt_state["step"] + 1
        lr = lr_at(cfg, step)
        b1, b2 = cfg.betas
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        new_p, new_m, new_v = [], [], []
        for path, p, g, m, v in zip(paths, ps, gs, ms, vs):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            if _is_decayed(path):
                delta = delta + cfg.weight_decay * p.float()
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
    structure = as_dict(params)
    return (
        tree_unflatten(params, new_p),
        {"m": tree_unflatten(structure, new_m),
         "v": tree_unflatten(structure, new_v), "step": step},
        {"grad_norm": gnorm, "lr": lr},
    )
