"""The causal LM of the dense family (the port's copy of the dense path of
``repro/models/transformer.py``): olmo-1b, starcoder2-3b, and the dense
flags of the others (parallel residual, post-block norms, local/global
layers).

Parameters keep the reference's tree: each leaf under ``"layers"`` has a
leading ``(L, ...)`` layer axis.  Layers run in a Python loop over views
of that axis, not a scan.  The moe, ssm, hybrid and vlm families raise.

    params = init_lm(cfg, generator)
    logits, aux = lm_forward(cfg, params, batch)                (prefill)
    cache = init_lm_cache(cfg, batch, max_seq, device)
    logits, cache = lm_decode(cfg, params, tokens, positions, cache)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    attention_block,
    decode_attention_block,
    init_attention,
    init_kv_cache,
)
from repro_torch.models.common import (
    apply_mlp,
    apply_norm,
    embed_tokens,
    init_embed,
    init_mlp,
    init_norm,
    unembed,
)

#: Families not ported yet -> the ROADMAP item that ports them.
_NOT_PORTED = {
    "ssm": "ROADMAP Queue 1 item 1 (rwkv6, kernel K3)",
    "hybrid": "ROADMAP Queue 1 item 2 (zamba2, kernel K4)",
    "moe": "ROADMAP Queue 1 item 7 (other model families)",
    "vlm": "ROADMAP Queue 1 item 7 (other model families)",
    "encdec": "ROADMAP Queue 1 item 7 (other model families)",
}


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}"
        )


def global_flags(cfg: ModelConfig) -> np.ndarray:
    """(L,) bool — which layers use full (global) attention.  gemma2
    alternates local/global with the *global* layer every Nth."""
    L = cfg.num_layers
    if cfg.local_global_period:
        idx = np.arange(L)
        return (idx % cfg.local_global_period) == (cfg.local_global_period - 1)
    return np.ones((L,), dtype=bool)


def _layer_slice(tree, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree, as views."""
    return {k: _layer_slice(v, i) if not isinstance(v, torch.Tensor) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_lm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters of the dense LM as a nested dict, drawn from
    ``gen`` on ``gen.device``."""
    _dense_only(cfg)
    L, dev = cfg.num_layers, gen.device
    p: dict = {"embed": init_embed(cfg, gen), "final_norm": init_norm(cfg, dev)}
    p["layers"] = {
        "ln1": init_norm(cfg, dev, layers=L),
        "attn": init_attention(cfg, gen, layers=L),
        "ln2": init_norm(cfg, dev, layers=L),
    }
    if cfg.post_block_norm:
        p["layers"]["post_ln1"] = init_norm(cfg, dev, layers=L)
        p["layers"]["post_ln2"] = init_norm(cfg, dev, layers=L)
    p["layers"]["mlp"] = init_mlp(cfg, gen, layers=L)
    return p


# ---------------------------------------------------------------------------
# Per-layer block bodies
# ---------------------------------------------------------------------------
def _attn_layer(cfg, p_l, x, positions, is_global, *, use_flash):
    h = apply_norm(cfg, p_l["ln1"], x)
    h = attention_block(cfg, p_l["attn"], h, positions, is_global,
                        use_flash=use_flash)
    if cfg.post_block_norm:
        h = apply_norm(cfg, p_l["post_ln1"], h)
    if cfg.parallel_residual:
        # command-r: attn and MLP read the same normed input.
        m = apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln1"], x))
        return x + h + m
    x = x + h
    m = apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))
    if cfg.post_block_norm:
        m = apply_norm(cfg, p_l["post_ln2"], m)
    return x + m


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def lm_forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    use_flash: bool = False,
    unembed_last_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (b, s)}.  Returns (logits (b, s, V), aux_loss
    scalar); with ``unembed_last_only`` the logits are (b, 1, V)."""
    _dense_only(cfg)
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    flags = global_flags(cfg)
    for i in range(cfg.num_layers):
        x = _attn_layer(cfg, _layer_slice(params["layers"], i), x, positions,
                        bool(flags[i]), use_flash=use_flash)
    if unembed_last_only:
        x = x[:, -1:, :]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------
def init_lm_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    _dense_only(cfg)
    return init_kv_cache(cfg, batch, max_seq, layers=cfg.num_layers,
                         device=device)


def _decode_attn_layer(cfg, p_l, x, positions, k_l, v_l, is_global):
    h = apply_norm(cfg, p_l["ln1"], x)
    h, k_l, v_l = decode_attention_block(cfg, p_l["attn"], h, positions,
                                         k_l, v_l, is_global)
    if cfg.post_block_norm:
        h = apply_norm(cfg, p_l["post_ln1"], h)
    if cfg.parallel_residual:
        m = apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln1"], x))
        return x + h + m, k_l, v_l
    x = x + h
    m = apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))
    if cfg.post_block_norm:
        m = apply_norm(cfg, p_l["post_ln2"], m)
    return x + m, k_l, v_l


def lm_decode(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,      # (b, 1)
    positions: torch.Tensor,   # (b,)
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One token per row against the cache; returns (logits (b, 1, V), a
    new cache).  The cache passed in is left as it was."""
    _dense_only(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)  # (b, 1, d)
    flags = global_flags(cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k_l, v_l = _decode_attn_layer(
            cfg, _layer_slice(params["layers"], i), x, positions,
            cache["k"][i], cache["v"][i], bool(flags[i]),
        )
        ks.append(k_l)
        vs.append(v_l)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
