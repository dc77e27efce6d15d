"""The unified causal LM (the port's copy of
``repro/models/transformer.py``) covering the decoder-only families:

* ``dense``  — olmo-1b, command-r-35b (parallel residual), gemma2-2b
  (local/global alternation + softcaps), starcoder2-3b (biases, plain MLP);
* ``vlm``    — llava-next-34b (patch-embedding stub prepended to tokens);
* ``moe``    — granite-moe (40e top-8), llama4-scout (16e top-1 + shared;
  :mod:`repro_torch.models.moe`);
* ``ssm``    — rwkv6 (attention-free; :mod:`repro_torch.models.rwkv`);
* ``hybrid`` — zamba2 (a mamba2 stack, :mod:`repro_torch.models.ssd`, with
  ONE shared attention+MLP block applied after every
  ``shared_attn_period``-th layer).

The encoder-decoder family (whisper) is :mod:`repro_torch.models.encdec`.

Parameters keep the reference's tree: each leaf under ``"layers"`` has a
leading ``(L, ...)`` layer axis (the hybrid's ``"shared"`` block has
none).  Layers run in a Python loop over views of that axis, not a scan;
with ``cfg.remat`` each layer body (the hybrid's mamba layer and shared
block each) runs under ``torch.utils.checkpoint`` when autograd records.

    params = init_lm(cfg, generator)
    logits, aux = lm_forward(cfg, params, batch)                (prefill)
    cache = init_lm_cache(cfg, batch, max_seq, device)
    logits, cache = lm_decode(cfg, params, tokens, positions, cache)
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv as R
from repro_torch.models import ssd as M
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
    gen_device,
    init_embed,
    init_mlp,
    init_norm,
    unembed,
)
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.spmd import stack

#: The families whose layers are attention + MLP (or MoE) blocks.
ATTN_FAMILIES = ("dense", "vlm", "moe")


def global_flags(cfg: ModelConfig) -> np.ndarray:
    """(L,) bool — which layers use full (global) attention.  gemma2
    alternates local/global with the *global* layer every Nth."""
    L = cfg.num_layers
    if cfg.local_global_period:
        idx = np.arange(L)
        return (idx % cfg.local_global_period) == (cfg.local_global_period - 1)
    return np.ones((L,), dtype=bool)


def _n_shared_applications(cfg: ModelConfig) -> int:
    return (cfg.num_layers // cfg.shared_attn_period
            if cfg.shared_attn_period else 0)


def _layers(tree, n: int) -> list[dict]:
    """The ``n`` layers of a stacked tree, as views: each ``(L, ...)`` leaf
    is unbound once.  Under autograd one ``unbind`` stacks the layers'
    grads once in its backward, where a select per layer (``v[i]``) would
    each materialise a zero tensor the size of the whole stack."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = (torch.unbind(v, 0) if isinstance(v, torch.Tensor)
                 else _layers(v, n))
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _remat(fn, cfg: ModelConfig):
    """``fn`` under activation rematerialisation when ``cfg.remat`` is set
    and autograd records (the reference's ``jax.checkpoint`` around each
    layer body): backward keeps only the layer's inputs and recomputes the
    rest."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def run(*args, **kw):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_lm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters of the LM as a nested dict, drawn from ``gen`` on
    its device; with ``gen=None`` shape-only tensors on ``meta``."""
    L, dev = cfg.num_layers, gen_device(gen)
    p: dict = {"embed": init_embed(cfg, gen), "final_norm": init_norm(cfg, dev)}
    if cfg.family == "ssm":  # rwkv6
        p["layers"] = {
            "ln1": init_norm(cfg, dev, layers=L),
            "tmix": R.init_rwkv_block(cfg, gen, layers=L),
            "ln2": init_norm(cfg, dev, layers=L),
            "cmix": R.init_channel_mix(cfg, gen, layers=L),
        }
        return p
    if cfg.family == "hybrid":  # zamba2
        p["layers"] = {
            "ln1": init_norm(cfg, dev, layers=L),
            "ssd": M.init_ssd_block(cfg, gen, layers=L),
        }
        # ONE shared attention+MLP block reused every shared_attn_period
        # layers (zamba2's parameter-sharing trick).
        p["shared"] = {
            "ln1": init_norm(cfg, dev),
            "attn": init_attention(cfg, gen),
            "ln2": init_norm(cfg, dev),
            "mlp": init_mlp(cfg, gen),
        }
        return p
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(f"init_lm does not handle family={cfg.family}")
    p["layers"] = {
        "ln1": init_norm(cfg, dev, layers=L),
        "attn": init_attention(cfg, gen, layers=L),
        "ln2": init_norm(cfg, dev, layers=L),
    }
    if cfg.post_block_norm:
        p["layers"]["post_ln1"] = init_norm(cfg, dev, layers=L)
        p["layers"]["post_ln2"] = init_norm(cfg, dev, layers=L)
    if cfg.family == "moe":
        p["layers"]["moe"] = init_moe(cfg, gen, layers=L)
    else:
        p["layers"]["mlp"] = init_mlp(cfg, gen, layers=L)
    return p


# ---------------------------------------------------------------------------
# Per-layer block bodies
# ---------------------------------------------------------------------------
def _ffn(cfg, p_l, h):
    """The layer's MLP, or its MoE layer: (out, the MoE's aux loss or
    None)."""
    if cfg.family == "moe":
        return moe_ffn(cfg, p_l["moe"], h)
    return apply_mlp(cfg, p_l["mlp"], h), None


def _attn_layer(cfg, p_l, x, positions, is_global, *, use_flash):
    """One attention + MLP (or MoE) layer: (x, the MoE's aux loss or
    None)."""
    h = apply_norm(cfg, p_l["ln1"], x)
    h = attention_block(cfg, p_l["attn"], h, positions, is_global,
                        use_flash=use_flash)
    if cfg.post_block_norm:
        h = apply_norm(cfg, p_l["post_ln1"], h)
    if cfg.parallel_residual:
        # command-r: attn and MLP read the same normed input.
        m = apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln1"], x))
        return x + h + m, None
    x = x + h
    m, aux = _ffn(cfg, p_l, apply_norm(cfg, p_l["ln2"], x))
    if cfg.post_block_norm:
        m = apply_norm(cfg, p_l["post_ln2"], m)
    return x + m, aux


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


def _mamba_layer(cfg, p_l, s_l, x, **scan):
    """One zamba2 mamba layer; ``scan`` picks the SSD scan of
    ``ssd_block`` (``use_kernel`` in the prefill, ``use_ref`` in decode)."""
    h, st = M.ssd_block(cfg, p_l["ssd"], apply_norm(cfg, p_l["ln1"], x), s_l,
                        **scan)
    return x + h, st


def _shared_attn_block(cfg, shared, x, positions, *, use_flash):
    h = apply_norm(cfg, shared["ln1"], x)
    h = attention_block(cfg, shared["attn"], h, positions,
                        use_flash=use_flash)
    x = x + h
    m = apply_mlp(cfg, shared["mlp"], apply_norm(cfg, shared["ln2"], x))
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
    use_scan_kernel: bool = False,
    unembed_last_only: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (b, s)[, "patch_embeds": (b, P, d)]}.  Returns
    (logits (b, s_total, V), aux_loss scalar); with ``unembed_last_only``
    the logits are (b, 1, V).  ``use_flash`` (causal attention in
    :mod:`repro_torch.kernels.flash_attention`) applies to the dense, vlm
    and moe families and the hybrid's shared block, ``use_scan_kernel``
    (the WKV scan in :mod:`repro_torch.kernels.rwkv6`, the SSD scan in
    :mod:`repro_torch.kernels.ssd`) to the ssm and hybrid families; a
    family ignores a flag that does not apply to it."""
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = _rwkv_stack_forward(cfg, params, x, use_kernel=use_scan_kernel)
    elif cfg.family == "hybrid":
        x = _hybrid_stack_forward(cfg, params, x, use_flash=use_flash,
                                  use_kernel=use_scan_kernel)
    elif cfg.family in ATTN_FAMILIES:
        x, aux = _attn_stack_forward(cfg, params, x, aux, use_flash=use_flash)
    else:
        raise ValueError(cfg.family)
    if unembed_last_only:
        x = x[:, -1:, :]
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, aux


def _attn_stack_forward(cfg, params, x, aux, *, use_flash):
    """(x, ``aux`` plus every MoE layer's aux loss)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    flags = global_flags(cfg)
    layer = _remat(_attn_layer, cfg)
    for i, p_l in enumerate(_layers(params["layers"], cfg.num_layers)):
        x, a = layer(cfg, p_l, x, positions, bool(flags[i]),
                     use_flash=use_flash)
        if a is not None:
            aux = aux + a
    return x, aux


def _rwkv_stack_forward(cfg, params, x, *, use_kernel):
    """Every layer starts from a zero state, as the reference's prefill."""
    L = cfg.num_layers
    states = _layers(R.init_rwkv_state(cfg, x.shape[0], layers=L,
                                       device=x.device), L)

    def body(p_l, s_l, x):
        return _rwkv_layer(cfg, p_l, s_l, x, use_kernel=use_kernel)[0]

    layer = _remat(body, cfg)
    for p_l, s_l in zip(_layers(params["layers"], L), states):
        x = layer(p_l, s_l, x)
    return x


def _hybrid_stack_forward(cfg, params, x, *, use_flash, use_kernel):
    """Every mamba layer starts from a zero state, as the reference's
    prefill (one zero state serves them all: nothing writes into it); the
    shared block runs after every ``shared_attn_period``-th layer."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    zero = _layers(M.init_ssd_state(cfg, b, layers=1, device=x.device), 1)[0]
    period = cfg.shared_attn_period

    def mamba(p_l, x):
        return _mamba_layer(cfg, p_l, zero, x, use_kernel=use_kernel)[0]

    mamba_layer = _remat(mamba, cfg)
    shared_layer = _remat(_shared_attn_block, cfg)
    for i, p_l in enumerate(_layers(params["layers"], cfg.num_layers)):
        x = mamba_layer(p_l, x)
        if period and (i + 1) % period == 0:
            x = shared_layer(cfg, params["shared"], x, positions,
                             use_flash=use_flash)
    return x


# ---------------------------------------------------------------------------
# Decode (one token against a cache)
# ---------------------------------------------------------------------------
def init_lm_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    """The KV cache of the dense, vlm and moe families, the ssm family's
    recurrent state (which does not grow with ``max_seq``), or the
    hybrid's mamba states and conv tails plus one KV cache per application
    of the shared block (``shared_k``/``shared_v``)."""
    if cfg.family == "ssm":
        return R.init_rwkv_state(cfg, batch, layers=cfg.num_layers,
                                 device=device)
    if cfg.family == "hybrid":
        cache = M.init_ssd_state(cfg, batch, layers=cfg.num_layers,
                                 device=device)
        kv = init_kv_cache(cfg, batch, max_seq,
                           layers=_n_shared_applications(cfg), device=device)
        cache["shared_k"], cache["shared_v"] = kv["k"], kv["v"]
        return cache
    if cfg.family not in ATTN_FAMILIES:
        raise ValueError(cfg.family)
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
    m, _ = _ffn(cfg, p_l, apply_norm(cfg, p_l["ln2"], x))
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
    reads no positions: its state carries them.  A vlm decodes text tokens
    only: its patches went in with the prefill."""
    x = embed_tokens(cfg, params["embed"], tokens)  # (b, 1, d)
    layers = _layers(params["layers"], cfg.num_layers)
    if cfg.family == "ssm":
        states = []
        for p_l, s_l in zip(layers, _layers(cache, cfg.num_layers)):
            x, st = _rwkv_layer(cfg, p_l, s_l, x, use_ref=True)
            states.append(st)
        new_cache = {k: stack([st[k] for st in states])
                     for k in ("S", "shift", "cmix_shift")}
    elif cfg.family == "hybrid":
        x, new_cache = _hybrid_decode(cfg, params, layers, x, positions,
                                      cache)
    elif cfg.family in ATTN_FAMILIES:
        flags = global_flags(cfg)
        ks, vs = [], []
        for i, p_l in enumerate(layers):
            x, k_l, v_l = _decode_attn_layer(
                cfg, p_l, x, positions, cache["k"][i], cache["v"][i],
                bool(flags[i]),
            )
            ks.append(k_l)
            vs.append(v_l)
        new_cache = {"k": stack(ks), "v": stack(vs)}
    else:
        raise ValueError(cfg.family)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, new_cache


def _hybrid_decode(cfg, params, layers, x, positions, cache):
    """The hybrid's decode: every mamba layer steps its state through the
    sequential scan (t = 1) with its conv tail; the shared block decodes
    after every ``shared_attn_period``-th layer against KV slot
    ``(i + 1) // period - 1``.  Returns (x, the new cache)."""
    period = cfg.shared_attn_period
    shared = params["shared"]
    states, ks, vs = [], [], []
    for i, p_l in enumerate(layers):
        s_l = {k: cache[k][i] for k in ("ssm", "conv_x", "conv_B", "conv_C")}
        x, st = _mamba_layer(cfg, p_l, s_l, x, use_ref=True)
        states.append(st)
        if period and (i + 1) % period == 0:
            app = (i + 1) // period - 1
            h = apply_norm(cfg, shared["ln1"], x)
            h, k_l, v_l = decode_attention_block(
                cfg, shared["attn"], h, positions, cache["shared_k"][app],
                cache["shared_v"][app])
            x = x + h
            x = x + apply_mlp(cfg, shared["mlp"],
                              apply_norm(cfg, shared["ln2"], x))
            ks.append(k_l)
            vs.append(v_l)
    new_cache = {k: stack([st[k] for st in states]) for k in states[0]}
    new_cache["shared_k"] = stack(ks) if ks else cache["shared_k"]
    new_cache["shared_v"] = stack(vs) if vs else cache["shared_v"]
    return x, new_cache
