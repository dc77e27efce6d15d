"""Operations and bytes the benchmark counts from shapes: the bound of one
causal attention call (kernel K2's roofline), the model FLOPs of a
prefill request and of a train step, and the table of the card's peaks.

Everything reads the configuration file's ``model`` fields (a plain
dict), never the program's own counts, so the yardstick stays put when
the program changes.  Model FLOPs count useful work only: products with
weights and attention over the unmasked (causal) pairs; no recompute, no
masked scores, no elementwise work.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_kind: str) -> dict | None:
    """The card's published peaks (``bf16_flops_per_s``,
    ``f32_flops_per_s``, ``bytes_per_s``), or None for a card the table
    does not hold: a share of a peak is then left out, never guessed."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(device_kind)


def _sizes(model: dict) -> tuple[int, int, int, int, int]:
    d, h = model["d_model"], model["num_heads"]
    kvh = model.get("num_kv_heads") or h
    hd = model.get("head_dim") or d // h
    return d, h, kvh, hd, model["num_layers"]


def layer_matmul_params(model: dict, active: bool = True) -> int:
    """Weights one token multiplies in one layer: q, k, v, o, and the MLP,
    or the router and the experts it is routed to (all of them with
    ``active=False``)."""
    d, h, kvh, hd, _ = _sizes(model)
    glu = 3 if model.get("act", "silu_glu").endswith("_glu") else 2
    attn = d * (h + 2 * kvh) * hd + h * hd * d
    if model["family"] == "moe":
        e = model["num_experts"]
        used = model["top_k"] if active else e
        ffn = used * glu * d * model["expert_d_ff"] + d * e
        if model.get("shared_expert_d_ff"):
            ffn += glu * d * model["shared_expert_d_ff"]
    else:
        ffn = glu * d * model["d_ff"]
    return attn + ffn


def causal_pairs(s: int) -> int:
    """Unmasked (query, key) pairs of one causal sequence of length s."""
    return s * (s + 1) // 2


def attention_flops(model: dict, b: int, s: int) -> int:
    """Both attention products of every layer over the causal pairs."""
    _, h, _, hd, layers = _sizes(model)
    return layers * 4 * b * h * hd * causal_pairs(s)


def prefill_flops(model: dict, b: int, s: int) -> int:
    """Model FLOPs of one prefill request of b prompts of length s that
    returns the last position's logits: 2 x active layer weights x tokens,
    the attention over the causal pairs, and the unembedding of b rows."""
    d, _, _, _, layers = _sizes(model)
    vocab = model["vocab_size"] + model.get("vocab_pad", 0)
    return (2 * layers * layer_matmul_params(model) * b * s
            + attention_flops(model, b, s) + 2 * d * vocab * b)


def train_flops(model: dict, b: int, s: int) -> int:
    """Model FLOPs of one train step on b x s tokens, with no recompute:
    6 x N x tokens (N the layers' weights and the unembedding, a tied one
    counted once, as its product runs once) plus the attention's forward
    and backward (3 x the forward)."""
    d, _, _, _, layers = _sizes(model)
    vocab = model["vocab_size"] + model.get("vocab_pad", 0)
    n = layers * layer_matmul_params(model) + d * vocab
    return 6 * n * b * s + 3 * attention_flops(model, b, s)


def flash_bound(b: int, h: int, kvh: int, s: int, hd: int, esize: int,
                peak: dict) -> tuple[float, str]:
    """(seconds, bound by) of one causal attention call at the card's
    peaks: q, k and v read once and the output written once, and two
    products over the s(s+1)/2 unmasked pairs of each head."""
    nbytes = (2 * b * h * s * hd + 2 * b * kvh * s * hd) * esize
    flops = 4 * b * h * hd * causal_pairs(s)
    t_bytes = nbytes / peak["bytes_per_s"]
    t_ops = flops / peak["bf16_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
