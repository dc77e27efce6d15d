"""Model/shape configuration schema (the port's copy of
``repro/configs/base.py``, without JAX).

One :class:`ModelConfig` instance fully describes an architecture; the
model code (:mod:`repro_torch.models`) builds init/apply functions from
it.  Field names, defaults and :func:`reduced` are the reference's, so a
config of either package describes the same model.  ``input_specs`` gives
the dry-run's shape stand-ins as tensors on the ``meta`` device (shape and
dtype, no storage) where the reference gives ``jax.ShapeDtypeStruct``.

Each of the 10 assigned architectures gets a module in
:mod:`repro_torch.configs` exposing ``CONFIG`` (exact published
hyper-parameters) and ``SMOKE`` (a reduced same-family config runnable on
CPU in a test).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int | None = None          # GQA; None => MHA
    head_dim: int | None = None              # None => d_model // num_heads

    # -- block flavour --------------------------------------------------
    act: Literal["silu_glu", "gelu", "gelu_glu", "relu_sq"] = "silu_glu"
    use_bias: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    non_parametric_norm: bool = False         # olmo: LN without scale/bias
    post_block_norm: bool = False             # gemma2 sandwich norms
    parallel_residual: bool = False           # command-r style
    tie_embeddings: bool = True

    # -- attention --------------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int | None = None          # local attention window
    local_global_period: int | None = None     # gemma2: every Nth layer global
    attn_softcap: float | None = None          # gemma2 logit softcap
    final_softcap: float | None = None         # gemma2 final-logit softcap
    query_scale: float | None = None           # None => 1/sqrt(head_dim)

    # -- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    shared_expert_d_ff: int = 0                # llama4 shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Group-limited routing (GShard-style): tokens are split into
    # ``moe_groups`` groups, each with its own capacity and dispatch
    # buffers.  Set to the data-parallel shard count so dispatch stays
    # LOCAL to each shard — global dispatch makes GSPMD materialize an
    # unsharded (E, C, d) buffer and TB-scale collectives.
    moe_groups: int = 1

    # -- SSM / RWKV ---------------------------------------------------------
    ssm_state: int = 0                         # mamba2 N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    shared_attn_period: int = 0                # zamba2: shared attn every N
    rwkv_head_dim: int = 64

    # -- enc-dec (whisper) ----------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    num_frames: int = 1500                     # audio frontend stub length
    learned_pos_emb: bool = False

    # -- VLM (llava) -----------------------------------------------------------
    num_patches: int = 0                        # vision frontend stub length

    # -- sharding knobs ---------------------------------------------------------
    # Megatron-style vocab padding: embedding/unembedding use
    # vocab_size + vocab_pad so the vocab dim divides the model axis;
    # padded logits are masked to -inf before the softmax/loss.
    vocab_pad: int = 0
    # Mesh axis name(s) the MoE group dim is constrained to (set by the
    # launcher; None = no constraint, e.g. single-device tests).
    moe_group_axis: tuple | None = None
    # §Perf variant: shard the dispatch-buffer CAPACITY dim over this axis
    # and REPLICATE the (small) expert weights — removes the TP all-reduce
    # on the buffer gradient entirely.  Only sensible when expert weights
    # are small (granite: 40e x 1536 x 512).
    moe_capacity_axis: str | None = None

    # -- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"                     # activation/compute dtype
    param_dtype: str = "float32"                # master weights
    # scan_layers=False unrolls the layer stack as a python loop — used by
    # the dry-run's cost extrapolation (XLA cost_analysis counts while-loop
    # bodies ONCE, so flops are measured on small unrolled depths and
    # linearly extrapolated; see utils/roofline.py).
    scan_layers: bool = True
    # unroll_inner=True additionally unrolls intra-layer loops (attention
    # q-chunks, rwkv/ssd chunk scans) so their flops are fully visible to
    # cost_analysis.  Only the dry-run cost samples set this.
    unroll_inner: bool = False
    # q-chunk size for the memory-bounded attention path (the XLA analogue
    # of the flash kernel's blocking; scores materialize at (b,h,chunk,skv)
    # fp32 instead of (b,h,sq,skv)).
    attn_chunk: int = 1024
    # Chunk length for the rwkv/ssd chunked scans (the deployed TPU kernel
    # block size is 64; the dry-run cost samples may use a coarser chunk to
    # keep unrolled-graph compile times sane — a conservative upper bound
    # on the intra-chunk term).
    inner_chunk: int = 64
    # Per-LAYER activation rematerialisation (checkpointing around each
    # block body): backward stores only layer-boundary activations.
    # Checkpointing the whole loss instead would keep every recomputed
    # intermediate live at once — no memory saving at all.
    remat: bool = False

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_pad

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.shared_attn_period == 0

    @property
    def supports_long_context(self) -> bool:
        """True if serve-time memory/compute is sub-quadratic in context:
        recurrent-state families. Pure full-attention archs skip long_500k
        (DESIGN.md §Arch-applicability)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode_step(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    # -- parameter counting (roofline MODEL_FLOPS = 6·N·D) -----------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        h, kvh, hs = self.num_heads, self.kv_heads, self.head_size
        attn = d * h * hs + 2 * d * kvh * hs + h * hs * d  # q,k,v,o

        def glu(hidden: int) -> int:
            return 3 * d * hidden if self.act.endswith("_glu") else 2 * d * hidden

        if self.family == "moe":
            n_used = self.top_k if active_only else self.num_experts
            ffn = n_used * glu(self.expert_d_ff) + d * self.num_experts
            if self.shared_expert_d_ff:
                ffn += glu(self.shared_expert_d_ff)
        else:
            ffn = glu(dff)

        if self.family == "encdec":
            enc = self.enc_layers * (attn + glu(dff))
            dec = self.dec_layers * (2 * attn + glu(dff))
            return enc + dec + v * d + self.num_frames * d

        if self.family == "ssm":  # rwkv6
            d_in = d
            mix = 4 * d * d_in + d * d_in  # r,k,v,g,o projections (~5 d^2)
            cmix = 2 * d * self.d_ff
            return self.num_layers * (mix + cmix) + v * d

        if self.family == "hybrid":  # zamba2: mamba2 layers + 1 shared block
            d_inner = self.ssm_expand * d
            mamba = d * (2 * d_inner) + d_inner * d + d_inner * (
                2 * self.ssm_state
            )
            shared = attn + glu(dff)
            return self.num_layers * mamba + shared + v * d

        per_layer = attn + ffn
        total = self.num_layers * per_layer + v * d
        if not self.tie_embeddings:
            total += v * d
        return total


# ---------------------------------------------------------------------------
# Input shapes (assigned): every LM arch is exercised on 4 shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: 512k context is quadratic; "
            "run only for SSM/hybrid families (DESIGN.md)"
        )
    return True, ""


def input_specs(
    cfg: ModelConfig, shape: ShapeConfig, *, per_host_batch: int | None = None
) -> dict[str, torch.Tensor]:
    """Stand-ins for every model input on the ``meta`` device (no
    allocation), with the reference's shapes and dtypes.  Modality
    frontends are stubs: ``[vlm]``/``[audio]`` entries receive precomputed
    patch/frame embeddings."""
    b = per_host_batch or shape.global_batch
    s = shape.seq_len
    # VLM: patch embeddings occupy the front of the sequence, so the text
    # token budget is seq_len - num_patches (total length stays exact).
    s_text = s - cfg.num_patches if cfg.family == "vlm" else s
    i32 = torch.int32
    act = cfg.activation_dtype()

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((b, s_text), i32)}
        if shape.kind == "train":
            # VLM loss covers text positions only; labels match text length.
            specs["labels"] = spec((b, s_text), i32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = spec((b, cfg.num_patches, cfg.d_model),
                                         act)
        if cfg.family == "encdec":
            specs["frame_embeds"] = spec((b, cfg.num_frames, cfg.d_model), act)
        return specs
    # decode: one new token against a cache of seq_len
    return {"tokens": spec((b, 1), i32), "positions": spec((b,), i32)}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family variant for CPU smoke tests."""
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.family == "moe":
        small.update(num_experts=4, top_k=min(cfg.top_k, 2), expert_d_ff=64)
        if cfg.shared_expert_d_ff:
            small["shared_expert_d_ff"] = 64
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=8, ssm_head_dim=16, rwkv_head_dim=16)
    if cfg.family == "encdec":
        small.update(enc_layers=2, dec_layers=2, num_frames=8)
    if cfg.family == "vlm":
        small.update(num_patches=4)
    if cfg.sliding_window:
        small["sliding_window"] = 8
    if cfg.shared_attn_period:
        small["shared_attn_period"] = 2
        small["num_layers"] = 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
