"""The causal LM (the port's copy of ``repro/models/transformer.py``) for
the families ported so far:

* ``dense`` — olmo-1b, starcoder2-3b, and the dense flags of the others
  (parallel residual, post-block norms, local/global layers);
* ``ssm``   — rwkv6 (attention-free; :mod:`repro_torch.models.rwkv`).

Parameters keep the reference's tree: each leaf under ``"layers"`` has a
leading ``(L, ...)`` layer axis.  Layers run in a Python loop over views
of that axis, not a scan.  The moe, hybrid, vlm and encdec families
raise.

    params = init_lm(cfg, generator)
    logits, aux = lm_forward(cfg, params, batch)                (prefill)
    cache = init_lm_cache(cfg, batch, max_seq, device)
    logits, cache = lm_decode(cfg, params, tokens, positions, cache)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv as R
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
    "hybrid": "ROADMAP Queue 1 item 2 (zamba2, kernel K4)",
    "moe": "ROADMAP Queue 1 item 7 (other model families)",
    "vlm": "ROADMAP Queue 1 item 7 (other model families)",
    "encdec": "ROADMAP Queue 1 item 7 (other model families)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm"):
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
    """Random parameters of the LM as a nested dict, drawn from ``gen`` on
    ``gen.device``."""
    _check_family(cfg)
    L, dev = cfg.num_layers, gen.device
    p: dict = {"embed": init_embed(cfg, gen), "final_norm": init_norm(cfg, dev)}
    if cfg.family == "ssm":  # rwkv6
        p["layers"] = {
            "ln1": init_norm(cfg, dev, layers=L),
            "tmix": R.init_rwkv_block(cfg, gen, layers=L),
            "ln2": init_norm(cfg, dev, layers=L),
            "cmix": R.init_channel_mix(cfg, gen, layers=L),
        }
        return p
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


def _rwkv_layer(cfg, p_l, s_l, x, **scan):
    """One rwkv6 layer; ``scan`` picks the WKV scan of ``rwkv_time_mix``
    (``use_kernel`` in the prefill, ``use_ref`` in decode)."""
    h, st = R.rwkv_time_mix(
        cfg, p_l["tmix"], apply_norm(cfg, p_l["ln1"], x),
        {"S": s_l["S"], "shift": s_l["shift"]}, **scan,
    )
    x = x + h
    h2, cshift = R.rwkv_channel_mix(
        cfg, p_l["cmix"], apply_norm(cfg, p_l["ln2"], x), s_l["cmix_shift"])
    return x + h2, {"S": st["S"], "shift": st["shift"], "cmix_shift": cshift}


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------
def lm_forward(
    cfg: ModelConfig,
    params,
    batch: dict,
    *,
    use_flash: bool = False,
    use_scan_kernel: bool = False,
    unembed_last_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (b, s)}.  Returns (logits (b, s, V), aux_loss
    scalar); with ``unembed_last_only`` the logits are (b, 1, V).
    ``use_flash`` applies to the dense family, ``use_scan_kernel`` (the
    WKV scan in :mod:`repro_torch.kernels.rwkv6`) to the ssm family; each
    family ignores the other's flag."""
    _check_family(cfg)
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    if cfg.family == "ssm":
        x = _rwkv_stack_forward(cfg, params, x, use_kernel=use_scan_kernel)
    else:
        x = _attn_stack_forward(cfg, params, x, use_flash=use_flash)
    if unembed_last_only:
        x = x[:, -1:, :]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_stack_forward(cfg, params, x, *, use_flash):
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    flags = global_flags(cfg)
    for i in range(cfg.num_layers):
        x = _attn_layer(cfg, _layer_slice(params["layers"], i), x, positions,
                        bool(flags[i]), use_flash=use_flash)
    return x


def _rwkv_stack_forward(cfg, params, x, *, use_kernel):
    """Every layer starts from a zero state, as the reference's prefill."""
    state = R.init_rwkv_state(cfg, x.shape[0], layers=cfg.num_layers,
                              device=x.device)
    for i in range(cfg.num_layers):
        x, _ = _rwkv_layer(cfg, _layer_slice(params["layers"], i),
                           _layer_slice(state, i), x, use_kernel=use_kernel)
    return x


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------
def init_lm_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """The dense family's KV cache, or the ssm family's recurrent state
    (which does not grow with ``max_seq``)."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return R.init_rwkv_state(cfg, batch, layers=cfg.num_layers,
                                 device=device)
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
    new cache).  The cache passed in is left as it was.  The ssm family
    reads no positions: its state carries them."""
    _check_family(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)  # (b, 1, d)
    if cfg.family == "ssm":
        states = []
        for i in range(cfg.num_layers):
            x, st = _rwkv_layer(cfg, _layer_slice(params["layers"], i),
                                _layer_slice(cache, i), x, use_ref=True)
            states.append(st)
        new_cache = {k: torch.stack([st[k] for st in states])
                     for k in ("S", "shift", "cmix_shift")}
    else:
        flags = global_flags(cfg)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, k_l, v_l = _decode_attn_layer(
                cfg, _layer_slice(params["layers"], i), x, positions,
                cache["k"][i], cache["v"][i], bool(flags[i]),
            )
            ks.append(k_l)
            vs.append(v_l)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, new_cache
