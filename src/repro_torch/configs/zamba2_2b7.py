"""zamba2-2.7b [hybrid]: 54 mamba2 layers, d_model=2560, ssm_state=64,
with ONE shared attention+MLP block (32H kv=32, d_ff=10240) applied every
6 layers — Zamba's parameter-sharing design [arXiv:2411.15242; hf]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    act="gelu_glu",
    norm="rmsnorm",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_period=6,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = reduced(CONFIG)
