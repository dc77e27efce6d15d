"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LN [arXiv:2402.00838; hf]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    act="silu_glu",
    norm="layernorm",
    non_parametric_norm=True,   # OLMo's defining quirk
    use_bias=False,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = reduced(CONFIG)
