"""Plain float32 forward of the decoder-only attention families (dense and
moe), written from the model's equations, with no kernel, cache or batch
trick of the program.

The model: token embedding times sqrt(d_model); per layer a pre-norm
causal self-attention (GQA, RoPE rotating the two halves of each head)
and a pre-norm MLP (SwiGLU) or mixture of experts, each added to the
residual; a final norm; the tied unembedding.  The norm is LayerNorm
without scale or bias (olmo) or RMSNorm with a scale (granite).

The mixture of experts routes as the configuration states: a softmax over
the router's f32 logits, the top k by a stable descending sort (equal
probabilities lower expert first), gates renormalised over the k, and a
capacity of ceil(g k / E x capacity_factor) slots per expert in each
group of g tokens; choices past it, counted token by token and choice by
choice, are dropped and the residual carries them.  Every kept choice is
computed by a plain loop over the experts.

``rnd`` is applied to both inputs of every product with a weight and of
both attention products: the identity for the reference, a rounding to a
lower precision for the control.  Call with autograd off for serving; the
train reference runs it under autograd.

As a configuration's ``reference`` module it also lays out the weights
the benchmark hands both sides (``make_weights``, in the port's tree) and
counts the model FLOPs the utilization readers divide
(``prefill_flops``, ``train_flops``, from :mod:`portbench.counting`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import inputs
from portbench.counting import prefill_flops, train_flops  # noqa: F401


def leaf_specs(model: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(dotted path, shape, scale) of every random leaf of the attention
    families' tree (dense and moe), in draw order; scale 0.02 for the
    embedding, 1/sqrt(fan-in) for every other matrix."""
    d, h, kvh, hd = sizes(model)
    L = model["num_layers"]
    vocab = model["vocab_size"] + model.get("vocab_pad", 0)
    glu = model.get("act", "silu_glu").endswith("_glu")
    if model["family"] not in ("dense", "moe"):
        raise ValueError(f"no weight layout for family {model['family']}")
    if model.get("use_bias") or not model.get("tie_embeddings", True):
        raise ValueError("biases and untied embeddings are not laid out")
    specs = [("embed.embedding", (vocab, d), 0.02),
             ("layers.attn.wq", (L, d, h, hd), d ** -0.5),
             ("layers.attn.wk", (L, d, kvh, hd), d ** -0.5),
             ("layers.attn.wv", (L, d, kvh, hd), d ** -0.5),
             ("layers.attn.wo", (L, h, hd, d), (h * hd) ** -0.5)]
    if model["family"] == "moe":
        e, f = model["num_experts"], model["expert_d_ff"]
        specs += [("layers.moe.router", (L, d, e), d ** -0.5),
                  ("layers.moe.wi", (L, e, d, f), d ** -0.5)]
        if glu:
            specs.append(("layers.moe.wg", (L, e, d, f), d ** -0.5))
        specs.append(("layers.moe.wo", (L, e, f, d), f ** -0.5))
    else:
        f = model["d_ff"]
        specs.append(("layers.mlp.wi", (L, d, f), d ** -0.5))
        if glu:
            specs.append(("layers.mlp.wg", (L, d, f), d ** -0.5))
        specs.append(("layers.mlp.wo", (L, f, d), f ** -0.5))
    return specs


def make_weights(model: dict, seed: int, device) -> dict:
    """The weights as nested dicts of tensors in the port's layout, in
    ``model['param_dtype']``: the matrices of :func:`leaf_specs` from one
    normal draw, norm scales of one (none for a non-parametric norm)."""
    dtype = getattr(torch, model.get("param_dtype", "float32"))
    tree = inputs.normal_tree(leaf_specs(model), seed, device, dtype)
    L, d = model["num_layers"], model["d_model"]
    for path in ("final_norm", "layers.ln1", "layers.ln2"):
        if model.get("non_parametric_norm"):
            inputs.put(tree, path, {})
        else:
            shape = (d,) if path == "final_norm" else (L, d)
            inputs.put(tree, path + ".scale",
                       torch.ones(shape, dtype=dtype, device=device))
    return tree


def same(x: torch.Tensor) -> torch.Tensor:
    """The reference's rounding of a product input: none."""
    return x


def sizes(model: dict) -> tuple[int, int, int, int]:
    d, h = model["d_model"], model["num_heads"]
    return d, h, model.get("num_kv_heads") or h, model.get("head_dim") or d // h


def norm(model: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    eps = model.get("norm_eps", 1e-5)
    if model.get("norm", "rmsnorm") == "rmsnorm":
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    else:
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
    if "scale" in p:
        x = x * p["scale"]
    return x


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, heads, hd); the first half of each head rotated against
    the second by angle pos * theta^(-2i/hd)."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=torch.float32) / hd)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(model: dict, p: dict, x: torch.Tensor, rnd=same
              ) -> torch.Tensor:
    """Causal softmax attention, one batch row at a time."""
    d, h, kvh, hd = sizes(model)
    b, s, _ = x.shape
    xr = rnd(x)
    q = (xr @ rnd(p["wq"].reshape(d, h * hd))).view(b, s, h, hd)
    k = (xr @ rnd(p["wk"].reshape(d, kvh * hd))).view(b, s, kvh, hd)
    v = (xr @ rnd(p["wv"].reshape(d, kvh * hd))).view(b, s, kvh, hd)
    theta = model.get("rope_theta", 10_000.0)
    q, k = rope(q, theta), rope(k, theta)
    scale = model.get("query_scale") or 1.0 / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    rows = []
    for i in range(b):
        qi = q[i].transpose(0, 1)                                 # (h, s, hd)
        ki = k[i].transpose(0, 1).repeat_interleave(h // kvh, 0)
        vi = v[i].transpose(0, 1).repeat_interleave(h // kvh, 0)
        scores = (rnd(qi) @ rnd(ki).transpose(1, 2)) * scale
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
        rows.append((rnd(probs) @ rnd(vi)).transpose(0, 1))      # (s, h, hd)
    o = torch.stack(rows).reshape(b, s, h * hd)
    return rnd(o) @ rnd(p["wo"].reshape(h * hd, d))


def mlp(p: dict, x: torch.Tensor, rnd=same) -> torch.Tensor:
    xr = rnd(x)
    hid = F.silu(xr @ rnd(p["wi"])) * (xr @ rnd(p["wg"]))
    return rnd(hid) @ rnd(p["wo"])


def moe(model: dict, p: dict, x: torch.Tensor, rnd=same
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, load-balance aux loss) of the mixture of experts."""
    b, s, d = x.shape
    e, k = model["num_experts"], model["top_k"]
    n = b * s
    groups = model.get("moe_groups", 1)
    groups = groups if groups > 0 and n % groups == 0 else 1
    g = n // groups
    xf = x.reshape(n, d)
    probs = torch.softmax(rnd(xf) @ rnd(p["router"]), -1)          # (n, e)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True).clamp_min(1e-9)
    idx = idx[:, :k]
    capacity = max(1, math.ceil(g * k / e * model.get("capacity_factor",
                                                      1.25)))
    flat = idx.reshape(groups, 1, g * k)
    # (G, e, gk): choices of each expert in token-then-choice order; the
    # running count runs along the innermost axis (along an outer one the
    # card's cumsum is many times slower).
    onehot = (torch.arange(e, device=x.device)[None, :, None] == flat).long()
    pos = (onehot.cumsum(-1) - 1).gather(1, flat)[:, 0].reshape(n, k)
    keep = pos < capacity
    aux = e * (probs.mean(0) * (onehot.sum((0, 2)).float() / (n * k))).sum()
    out = torch.zeros_like(xf)
    for ex in range(e):
        tok, choice = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = rnd(xf[tok])
        hid = F.silu(xe @ rnd(p["wi"][ex])) * (xe @ rnd(p["wg"][ex]))
        y = rnd(hid) @ rnd(p["wo"][ex])
        out = out.index_add(0, tok, y * gates[tok, choice][:, None])
    return out.reshape(b, s, d), aux


def layer(model: dict, p: dict, x: torch.Tensor, rnd=same
          ) -> tuple[torch.Tensor, torch.Tensor]:
    x = x + attention(model, p["attn"], norm(model, p.get("ln1", {}), x),
                      rnd)
    h = norm(model, p.get("ln2", {}), x)
    if model["family"] == "moe":
        m, aux = moe(model, p["moe"], h, rnd)
    else:
        m, aux = mlp(p["mlp"], h, rnd), x.new_zeros(())
    return x + m, aux


def layer_params(tree: dict, i: int) -> dict:
    """Layer i's leaves of a stacked ``(L, ...)`` tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hidden(model: dict, params: dict, tokens: torch.Tensor, rnd=same, *,
           remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states after the final norm (b, s, d), the sum of the
    MoE layers' aux losses).  With ``remat`` each layer runs under
    activation checkpointing, so that a train step's backward fits."""
    if model.get("act", "silu_glu") != "silu_glu":
        raise ValueError(f"activation {model['act']!r}: the reference "
                         "writes SwiGLU only")
    d = model["d_model"]
    x = params["embed"]["embedding"][tokens] * math.sqrt(d)
    aux = x.new_zeros(())
    for i in range(model["num_layers"]):
        p_l = layer_params(params["layers"], i)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(layer, model, p_l, x, rnd, use_reentrant=False)
        else:
            x, a = layer(model, p_l, x, rnd)
        aux = aux + a
    return norm(model, params.get("final_norm", {}), x), aux


def unembed(model: dict, params: dict, h: torch.Tensor, rnd=same
            ) -> torch.Tensor:
    """Logits over the real vocabulary (padded rows left out)."""
    w = params["embed"]["embedding"][:model["vocab_size"]]
    return rnd(h) @ rnd(w).T


def last_logits(model: dict, params: dict, tokens: torch.Tensor,
                rnd=same) -> torch.Tensor:
    """(b, vocab) logits of the last position of each prompt."""
    h, _ = hidden(model, params, tokens, rnd)
    return unembed(model, params, h[:, -1], rnd)


def loss(model: dict, params: dict, tokens: torch.Tensor,
         labels: torch.Tensor, aux_weight: float, rnd=same,
         remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``aux_weight`` x the aux loss."""
    h, aux = hidden(model, params, tokens, rnd, remat=remat)
    logits = unembed(model, params, h, rnd)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1))
    return ce + aux_weight * aux
