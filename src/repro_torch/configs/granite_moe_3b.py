"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite; hf]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                    # kept for reference; experts use expert_d_ff
    vocab_size=49155,
    vocab_pad=13,         # 49168 = 16*3073: vocab-shardable
    act="silu_glu",
    norm="rmsnorm",
    num_experts=40,
    top_k=8,
    expert_d_ff=512,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = reduced(CONFIG)
