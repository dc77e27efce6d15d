"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    act="silu_glu",
    norm="rmsnorm",
    num_experts=16,
    top_k=1,
    expert_d_ff=8192,
    shared_expert_d_ff=8192,     # llama4's always-on shared expert
    tie_embeddings=True,
    rope_theta=500_000.0,
)

SMOKE = reduced(CONFIG)
