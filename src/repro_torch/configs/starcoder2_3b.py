"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, biases, plain-GELU MLP [arXiv:2402.19173; hf]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    act="gelu",                  # starcoder2: non-gated MLP
    norm="layernorm",
    use_bias=True,
    tie_embeddings=True,
    rope_theta=999_999.4,        # published rope base ~1e6
)

SMOKE = reduced(CONFIG)
