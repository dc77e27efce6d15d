"""Whisper-style encoder-decoder (the port's copy of
``repro/models/encdec.py``; whisper-base: 6+6 layers, d=512).

The audio frontend (log-mel + two convs) is a stub, as in the reference:
the batch carries precomputed frame embeddings ``(b, F=1500, d)``.  The
transformer backbone is exact: learned positional embeddings, pre-LN
blocks, GELU MLPs with biases, decoder cross-attention.  Neither stack
uses RoPE in the prefill; the decode step's self-attention is the LM's
``decode_attention_block``, which rotates q and k, as the reference's does.

Decode keeps a self-attention KV cache per decoder layer plus cross K/V
(``xk``/``xv``) of ``num_frames`` rows.  As in the reference, nothing
fills the cross K/V: they stay the zeros of :func:`init_encdec_cache`, so
decode attends to zeros and its logits do not depend on the audio.

Layers run in a Python loop over views of the stacked ``(L, ...)``
leaves, each under ``torch.utils.checkpoint`` when ``cfg.remat`` is set
and autograd records.

The activations follow the reference's dtype promotion: f32 frame
embeddings make an f32 encoder output, and the decoder turns f32 at its
first cross-attention, whatever ``cfg.dtype`` says.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    _out,
    _proj,
    _qkv,
    decode_attention_block,
    init_attention,
    init_kv_cache,
    kv_cache_specs,
    mha,
)
from repro_torch.models.common import (
    apply_mlp,
    apply_norm,
    embed_init,
    embed_tokens,
    gen_device,
    init_embed,
    init_mlp,
    init_norm,
    unembed,
)
from repro_torch.models.spmd import stack
from repro_torch.models.transformer import _layers, _remat

#: Rows of the decoder's learned position table; longer decoder prefills
#: tile it.
DEC_POSITIONS = 4096


def init_encdec(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters as a nested dict, drawn from ``gen`` on its
    device; with ``gen=None`` shape-only tensors on ``meta``."""
    Le, Ld, dev = cfg.enc_layers, cfg.dec_layers, gen_device(gen)
    return {
        "embed": init_embed(cfg, gen),
        "enc_pos": embed_init(gen, (cfg.num_frames, cfg.d_model),
                              cfg.param_dtype),
        "dec_pos": embed_init(gen, (DEC_POSITIONS, cfg.d_model),
                              cfg.param_dtype),
        "encoder": {
            "ln1": init_norm(cfg, dev, layers=Le),
            "attn": init_attention(cfg, gen, layers=Le),
            "ln2": init_norm(cfg, dev, layers=Le),
            "mlp": init_mlp(cfg, gen, layers=Le),
        },
        "decoder": {
            "ln1": init_norm(cfg, dev, layers=Ld),
            "self_attn": init_attention(cfg, gen, layers=Ld),
            "ln_x": init_norm(cfg, dev, layers=Ld),
            "cross_attn": init_attention(cfg, gen, layers=Ld),
            "ln2": init_norm(cfg, dev, layers=Ld),
            "mlp": init_mlp(cfg, gen, layers=Ld),
        },
        "enc_final": init_norm(cfg, dev),
        "final_norm": init_norm(cfg, dev),
    }


def _self_attention(cfg, p, x, causal: bool):
    s = x.shape[1]
    q, k, v = _qkv(cfg, p, x)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
    if causal:
        mask = mask.tril()
    return _out(cfg, p, mha(cfg, q, k, v, mask))


def _cross_attention(cfg, p, x, enc):
    """Queries from x, keys and values from the encoder output ``enc``.
    The weights are cast to x's dtype, then promoted with enc's, as the
    reference's einsums do."""
    dtype = x.dtype
    q = _proj(x, p["wq"])
    k = _proj(enc, p["wk"].to(dtype))
    v = _proj(enc, p["wv"].to(dtype))
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    mask = torch.ones((x.shape[1], enc.shape[1]), dtype=torch.bool,
                      device=x.device)
    return _out(cfg, p, mha(cfg, q, k, v, mask))


def _enc_layer(cfg, p_l, x):
    x = x + _self_attention(cfg, p_l["attn"], apply_norm(cfg, p_l["ln1"], x),
                            False)
    return x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))


def _dec_layer(cfg, p_l, x, enc):
    x = x + _self_attention(cfg, p_l["self_attn"],
                            apply_norm(cfg, p_l["ln1"], x), True)
    x = x + _cross_attention(cfg, p_l["cross_attn"],
                             apply_norm(cfg, p_l["ln_x"], x), enc)
    return x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))


def encode(cfg: ModelConfig, params, frame_embeds: torch.Tensor
           ) -> torch.Tensor:
    """The encoder output (b, F, d) in ``frame_embeds``' dtype."""
    x = frame_embeds + params["enc_pos"][None, :frame_embeds.shape[1]].to(
        frame_embeds.dtype)
    layer = _remat(_enc_layer, cfg)
    for p_l in _layers(params["encoder"], cfg.enc_layers):
        x = layer(cfg, p_l, x)
    return apply_norm(cfg, params["enc_final"], x)


def encdec_forward(
    cfg: ModelConfig, params, batch: dict,
    unembed_last_only: bool = False, **_unused,
) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (b, s), "frame_embeds": (b, F, d)}.  Returns
    (logits (b, s, V), a zero aux loss); the flags of the LM's forward
    (``use_flash``, ``use_scan_kernel``) do not apply and are ignored."""
    enc = encode(cfg, params, batch["frame_embeds"])
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params["embed"], tokens)
    s = tokens.shape[1]
    pos = params["dec_pos"]
    if s > pos.shape[0]:  # stress shapes (32k decoder prefill)
        pos = pos.repeat(-(-s // pos.shape[0]), 1)
    x = x + pos[None, :s].to(x.dtype)
    layer = _remat(_dec_layer, cfg)
    for p_l in _layers(params["decoder"], cfg.dec_layers):
        x = layer(cfg, p_l, x, enc)
    if unembed_last_only:
        x = x[:, -1:, :]
    x = apply_norm(cfg, params["final_norm"], x)
    return (unembed(cfg, params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_encdec_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> dict:
    """Self-attention K/V of ``max_seq`` rows and cross K/V of
    ``num_frames`` rows per decoder layer, all zeros."""
    kv = init_kv_cache(cfg, batch, max_seq, layers=cfg.dec_layers,
                       device=device)
    x = init_kv_cache(cfg, batch, cfg.num_frames, layers=cfg.dec_layers,
                      device=device)
    return {"k": kv["k"], "v": kv["v"], "xk": x["k"], "xv": x["v"]}


def encdec_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """:func:`init_encdec_cache`'s tensors on the ``meta`` device (shape
    and dtype, no storage)."""
    kv = kv_cache_specs(cfg, batch, max_seq, layers=cfg.dec_layers)
    x = kv_cache_specs(cfg, batch, cfg.num_frames, layers=cfg.dec_layers)
    return {"k": kv["k"], "v": kv["v"], "xk": x["k"], "xv": x["v"]}


def encdec_decode(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,     # (b, 1)
    positions: torch.Tensor,  # (b,)
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One token per row against the cache; returns (logits (b, 1, V), a
    new cache).  The cache passed in is left as it was."""
    x = embed_tokens(cfg, params["embed"], tokens)
    pos_table = params["dec_pos"]
    x = x + pos_table[positions % pos_table.shape[0]].to(x.dtype)[:, None, :]
    ks, vs = [], []
    for i, p_l in enumerate(_layers(params["decoder"], cfg.dec_layers)):
        h = apply_norm(cfg, p_l["ln1"], x)
        h, k_l, v_l = decode_attention_block(
            cfg, p_l["self_attn"], h, positions, cache["k"][i],
            cache["v"][i])
        x = x + h
        ks.append(k_l)
        vs.append(v_l)
        # Cross-attention against the cached cross K/V.
        hq = apply_norm(cfg, p_l["ln_x"], x)
        q = _proj(hq, p_l["cross_attn"]["wq"])
        if "bq" in p_l["cross_attn"]:
            q = q + p_l["cross_attn"]["bq"].to(hq.dtype)
        xk_l, xv_l = cache["xk"][i], cache["xv"][i]
        mask = torch.ones((1, xk_l.shape[1]), dtype=torch.bool,
                          device=x.device)
        x = x + _out(cfg, p_l["cross_attn"], mha(cfg, q, xk_l, xv_l, mask))
        x = x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, {"k": stack(ks), "v": stack(vs),
                    "xk": cache["xk"], "xv": cache["xv"]}
