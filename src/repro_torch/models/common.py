"""Shared model components: norms, RoPE, MLPs, initializers, softcaps
(the port's copy of ``repro/models/common.py``).

Parameters are nested dicts of tensors under the reference's names (or
the :class:`~repro_torch.models.params.ParamTree` module that holds them),
and every function takes ``(cfg, params, inputs)``.  Master parameters
are kept in ``cfg.param_dtype`` (fp32 by default; bf16 where a model's
f32 tree does not fit the card) and cast to the activation dtype at each
use, as in the reference.  Initializers draw from a seeded
``torch.Generator``; they give other numbers than ``jax.random`` from the
same seed, so the tests carry the reference's parameters across instead
(:func:`repro_torch.models.params.from_reference`).  With no
generator (``gen=None``) they give shape-only ``meta`` tensors, the
counterpart of ``jax.eval_shape`` over the reference's init.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spmd import (
    like_last_dim,
    lookup,
    on_mesh,
    unembed_input,
)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def gen_device(gen: torch.Generator | None) -> torch.device:
    """The device parameters are drawn on: the generator's, or ``meta``
    when ``gen`` is None (a shape-only init: every initializer then gives
    a tensor of the right shape and dtype with no storage and no draw)."""
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: torch.Generator | None, shape, in_axis_size: int,
               dtype: str) -> torch.Tensor:
    """Truncated-normal fan-in init (the common LM choice), drawn in f32.

    A float32 leaf is drawn whole.  A leaf stored in another dtype (bf16
    ``param_dtype``) is drawn one slice of its leading axis at a time, one
    layer of a stacked leaf, each slice cast into the leaf as it is drawn:
    the f32 temporary stays at one slice, where a whole draw of
    command-r-35b's (40, 8192, 22528) MLP leaf would take 29.5 GB beside
    its cast.  So a leaf of another dtype comes from a random stream of its
    own, not from the f32 tree's numbers rounded; the f32 draw is as it
    was."""
    dt = getattr(torch, dtype)
    if gen is None:
        return torch.empty(shape, dtype=dt, device="meta")
    scale = 1.0 / math.sqrt(in_axis_size)
    if dt == torch.float32:
        t = torch.empty(shape, dtype=torch.float32, device=gen_device(gen))
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t * scale
    out = torch.empty(shape, dtype=dt, device=gen_device(gen))
    for piece in out:
        t = torch.empty(piece.shape, dtype=torch.float32, device=out.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        piece.copy_(t.mul_(scale))
    return out


def embed_init(gen: torch.Generator | None, shape, dtype: str
               ) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
    t = torch.randn(shape, generator=gen, device=gen.device)
    return (t * 0.02).to(getattr(torch, dtype))


def _full(shape, value: float, dtype: str, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=getattr(torch, dtype), device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, device, dim: int | None = None,
              layers: int | None = None) -> dict:
    """Norm parameters; ``layers`` stacks a leading layer axis."""
    if cfg.non_parametric_norm:
        return {}
    d = dim or cfg.d_model
    shape = (d,) if layers is None else (layers, d)
    p = {"scale": _full(shape, 1.0, cfg.param_dtype, device)}
    if cfg.norm == "layernorm" and cfg.use_bias:
        p["bias"] = _full(shape, 0.0, cfg.param_dtype, device)
    return p


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm / LayerNorm, optionally non-parametric (olmo-style)."""
    dtype = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + cfg.norm_eps)
    else:
        mu = x.mean(dim=-1, keepdim=True)
        # jnp.var is the biased (population) variance.
        var = x.var(dim=-1, keepdim=True, correction=0)
        x = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
    if p:
        x = x * p["scale"].float()
        if "bias" in p:
            x = x + p["bias"].float()
    return x.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(cfg: ModelConfig, positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions, shape (..., head_dim/2)."""
    hd = cfg.head_size
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv  # (..., hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim/2).
    Rotates the two halves of the head dim (not interleaved pairs)."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Softcap (gemma2)
# ---------------------------------------------------------------------------
def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int | None = None,
             *, layers: int | None = None) -> dict:
    """Gated (SwiGLU/GeGLU) or plain 2-layer MLP.  ``layers`` stacks a
    leading layer axis."""
    d = cfg.d_model
    dff = d_ff or cfg.d_ff
    pref = () if layers is None else (layers,)
    p = {"wi": dense_init(gen, (*pref, d, dff), d, cfg.param_dtype)}
    if cfg.act.endswith("_glu"):
        p["wg"] = dense_init(gen, (*pref, d, dff), d, cfg.param_dtype)
    p["wo"] = dense_init(gen, (*pref, dff, d), dff, cfg.param_dtype)
    if cfg.use_bias:
        p["bi"] = _full((*pref, dff), 0.0, cfg.param_dtype, gen_device(gen))
        p["bo"] = _full((*pref, d), 0.0, cfg.param_dtype, gen_device(gen))
    return p


def _act_fn(name: str):
    if name.startswith("silu"):
        return F.silu
    if name.startswith("gelu"):
        # jax.nn.gelu defaults to the tanh approximation.
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return lambda x: F.relu(x).square()
    raise ValueError(name)


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    act = _act_fn(cfg.act)
    h = x @ p["wi"].to(dtype)
    if "bi" in p:
        h = h + p["bi"].to(dtype)
    h = act(h)
    if "wg" in p:
        h = h * (x @ p["wg"].to(dtype))
    out = h @ p["wo"].to(dtype)
    if "bo" in p:
        out = out + p["bo"].to(dtype)
    return out


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embed(cfg: ModelConfig, gen: torch.Generator) -> dict:
    v = cfg.padded_vocab
    p = {"embedding": embed_init(gen, (v, cfg.d_model), cfg.param_dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, v), cfg.d_model,
                                  cfg.param_dtype)
    return p


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums each row's grads in a
    # fixed order, where indexing's (an accumulating index_put_) does not
    # on the CPU, and the train step must give the same bits every run.
    x = lookup(tokens, p["embedding"]).to(cfg.activation_dtype())
    # gemma-style sqrt(d) scaling by the factor rounded to the activation
    # dtype, as the reference multiplies by it.
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x * scale


def unembed(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    w = p["unembed"] if "unembed" in p else p["embedding"].T
    x = unembed_input(x, w)
    logits = x @ w.to(x.dtype)
    logits = softcap(logits, cfg.final_softcap)
    if cfg.vocab_pad:
        # Mask padded vocab entries out of every softmax/argmax.
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(like_last_dim(valid, logits), logits, -1e30)
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, fp32 accumulation.

    The reference picks the gold logit with a one-hot contraction so that
    GSPMD keeps vocab-sharded logits sharded.  On one card there is no
    vocab sharding to keep, and ``gather`` reads the same logit without a
    (b, s, V) f32 one-hot (3.3 GB at olmo-1b's 4 x 4096 x 50304).  On a
    mesh, DTensor logits keep their vocab shards, as GSPMD keeps the
    reference's: the log-normaliser from a max and a sum of exponentials
    (one partial reduction per shard each) and the gold logit by the
    one-hot contraction (a gather across vocab shards has no DTensor rule
    that runs on ``meta`` shards)."""
    logits = logits.float()
    if not on_mesh(logits):
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (logz - gold).mean()
    top = logits.amax(dim=-1, keepdim=True).detach()
    logz = (logits - top).exp().sum(-1).log() + top[..., 0]
    vocab = like_last_dim(
        torch.arange(logits.shape[-1], device=logits.device), logits)
    hit = labels.long()[..., None] == vocab
    gold = torch.where(hit, logits, 0.0).sum(-1)
    return (logz - gold).mean()

