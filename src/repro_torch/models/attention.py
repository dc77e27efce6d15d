"""Grouped-query attention (the port's copy of ``repro/models/attention.py``):

* GQA (kv_heads <= heads), RoPE, optional biases;
* sliding-window (local) masks and a per-layer ``is_global`` flag (a
  Python bool here: the port loops over layers instead of scanning);
* attention-logit softcap;
* KV-cache decode (one query token against a ``max_seq`` cache);
* the compute path is pluggable: with ``use_flash`` the causal prefill
  goes to :mod:`repro_torch.kernels.flash_attention` (kernel K2 on CUDA
  tensors) under the same dispatch predicate as the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    apply_rope,
    dense_init,
    gen_device,
    rope_freqs,
    softcap,
)
from repro_torch.models.spmd import einsum

NEG_INF = -2.0**30  # large-but-finite: keeps softmax NaN-free on masked rows


def init_attention(cfg: ModelConfig, gen: torch.Generator, *,
                   layers: int | None = None) -> dict:
    d, h, kvh, hs = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_size
    pref = () if layers is None else (layers,)
    p = {
        "wq": dense_init(gen, (*pref, d, h, hs), d, cfg.param_dtype),
        "wk": dense_init(gen, (*pref, d, kvh, hs), d, cfg.param_dtype),
        "wv": dense_init(gen, (*pref, d, kvh, hs), d, cfg.param_dtype),
        "wo": dense_init(gen, (*pref, h, hs, d), h * hs, cfg.param_dtype),
    }
    if cfg.use_bias:
        dt = getattr(torch, cfg.param_dtype)
        for name, shape in (("bq", (h, hs)), ("bk", (kvh, hs)),
                            ("bv", (kvh, hs)), ("bo", (d,))):
            p[name] = torch.zeros((*pref, *shape), dtype=dt,
                                  device=gen_device(gen))
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(cfg: ModelConfig, p, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        dtype = x.dtype
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return q, k, v


def _out(cfg: ModelConfig, p, o: torch.Tensor) -> torch.Tensor:
    h, k, d = p["wo"].shape
    y = o.flatten(-2) @ p["wo"].to(o.dtype).reshape(h * k, d)
    if "bo" in p:
        y = y + p["bo"].to(o.dtype)
    return y


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return k.repeat_interleave(groups, dim=2)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int | None, is_global: bool = True) -> torch.Tensor:
    """(q, k) boolean mask: global layers see full causal context, local
    layers a sliding window."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window is None or is_global:
        return causal
    return causal & (q_pos[:, None] - k_pos[None, :] < window)


def mha(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor, *, use_flash: bool = False) -> torch.Tensor:
    """Core softmax attention.  q: (b, sq, h, hd), k/v: (b, sk, kvh, hd),
    mask: (sq, sk) bool (or (b, sq, sk)).

    With ``use_flash``, no softcap and a 2-D mask, the call goes to the
    flash path, which is causal only and derives its own mask (the layer
    mask is ignored there, as in the reference).  Otherwise long queries
    are processed in q-chunks of ``cfg.attn_chunk`` when ``sq`` is a
    multiple of it, so scores materialize at (b, h, chunk, skv) fp32."""
    groups = q.shape[2] // k.shape[2]
    scale = cfg.query_scale or (1.0 / math.sqrt(cfg.head_size))
    if use_flash and cfg.attn_softcap is None and mask.ndim == 2:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, mask=mask, scale=scale)
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    sq = q.shape[1]
    chunk = cfg.attn_chunk
    if sq <= chunk or sq % chunk:
        return _mha_dense(cfg, q, k, v, mask, scale)
    outs = []
    for i in range(sq // chunk):
        rows = slice(i * chunk, (i + 1) * chunk)
        m_c = mask[rows] if mask.ndim == 2 else mask[:, rows]
        outs.append(_mha_dense(cfg, q[:, rows], k, v, m_c, scale))
    return torch.cat(outs, dim=1)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands in their promoted dtype, as
    ``jnp.einsum`` promotes: whisper's cross-attention reads bf16 queries
    against the keys of an f32 encoder output."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return einsum(eq, a.to(dt), b.to(dt))


def _mha_dense(cfg, q, k, v, mask, scale):
    scores = _einsum("bqhk,bshk->bhqs", q, k).float() * scale
    scores = softcap(scores, cfg.attn_softcap)
    mask_b = mask[None, None] if mask.ndim == 2 else mask[:, None]
    scores = torch.where(mask_b, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _einsum("bhqs,bshk->bqhk", probs, v)


def attention_block(cfg: ModelConfig, p, x: torch.Tensor,
                    positions: torch.Tensor, is_global: bool = True, *,
                    use_flash: bool = False) -> torch.Tensor:
    """Full self-attention over x (training / prefill path)."""
    q, k, v = _qkv(cfg, p, x)
    cos, sin = rope_freqs(cfg, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    mask = causal_mask(positions[0], positions[0], cfg.sliding_window,
                       is_global)
    o = mha(cfg, q, k, v, mask, use_flash=use_flash)
    return _out(cfg, p, o)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, *, layers: int,
                  device) -> dict:
    shape = (layers, batch, max_seq, cfg.kv_heads, cfg.head_size)
    dt = cfg.activation_dtype()
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def kv_cache_specs(cfg: ModelConfig, batch: int, max_seq: int, *,
                   layers: int) -> dict:
    """The KV cache's stand-ins on the ``meta`` device (shape and dtype,
    no storage), as :func:`init_kv_cache` would make it."""
    shape = (layers, batch, max_seq, cfg.kv_heads, cfg.head_size)
    dt = cfg.activation_dtype()
    return {"k": torch.empty(shape, dtype=dt, device="meta"),
            "v": torch.empty(shape, dtype=dt, device="meta")}


def decode_attention_block(
    cfg: ModelConfig,
    p,
    x: torch.Tensor,          # (b, 1, d) — the new token
    positions: torch.Tensor,  # (b,) — its position
    cache_k: torch.Tensor,    # (b, S, kvh, hd) — this layer's cache
    cache_v: torch.Tensor,
    is_global: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against the cache; returns (out, new_k, new_v)."""
    S = cache_k.shape[1]
    q, k, v = _qkv(cfg, p, x)  # (b,1,h,hd) / (b,1,kvh,hd)
    cos, sin = rope_freqs(cfg, positions[:, None])  # (b,1,hd/2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # Insert the new kv at its position by a one-hot ADD, as the reference
    # does: a reused slot (BatchingQueue) adds onto its stale entry, and the
    # port gives the reference's result.  An out-of-range position is
    # dropped (all-zero row), as jax.nn.one_hot makes it.
    k_pos = torch.arange(S, device=x.device)
    onehot = (positions[:, None] == k_pos[None, :]).to(cache_k.dtype)  # (b, S)
    cache_k = cache_k + onehot[:, :, None, None] * k.to(cache_k.dtype)
    cache_v = cache_v + onehot[:, :, None, None] * v.to(cache_v.dtype)
    valid = k_pos[None, :] <= positions[:, None]  # (b, S)
    if cfg.sliding_window is not None and not is_global:
        valid = valid & ((positions[:, None] - k_pos[None, :])
                         < cfg.sliding_window)
    mask = valid[:, None, :]  # (b, 1, S) -> broadcast as (b, q=1, S)
    o = mha(cfg, q, cache_k, cache_v, mask)
    return _out(cfg, p, o), cache_k, cache_v
