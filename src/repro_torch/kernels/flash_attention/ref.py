"""Plain oracle for the flash attention kernel (the port's copy of
``repro/kernels/flash_attention/ref.py``): the whole score matrix, a
softmax, and the product with V, in f32."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,   # (b, h, sq, hd)
    k: torch.Tensor,   # (b, kvh, skv, hd)
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    sq = q.shape[2]
    groups = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
