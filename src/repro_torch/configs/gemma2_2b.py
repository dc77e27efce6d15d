"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000
— local+global alternating attention, logit softcaps, sandwich norms
[arXiv:2408.00118; hf]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    act="gelu_glu",
    norm="rmsnorm",
    post_block_norm=True,        # gemma2 sandwich norms
    sliding_window=4096,
    local_global_period=2,       # local, global, local, global, ...
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=1.0 / 16.0,      # gemma2 scales by 1/sqrt(256)
    tie_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = reduced(CONFIG, head_dim=16, local_global_period=2)
