"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias, parallel residual blocks
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    act="silu_glu",
    norm="layernorm",
    use_bias=False,
    parallel_residual=True,     # Cohere's parallel attn+FFN blocks
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)

SMOKE = reduced(CONFIG)
