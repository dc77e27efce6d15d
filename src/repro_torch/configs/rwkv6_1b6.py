"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; unverified]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                # d_model / rwkv_head_dim
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    tie_embeddings=False,        # rwkv uses separate head
)

SMOKE = reduced(CONFIG, num_heads=4)
