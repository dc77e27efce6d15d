"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; vision frontend is a STUB (input_specs
provides precomputed patch embeddings) [hf:llava-hf; unverified]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    act="silu_glu",
    norm="rmsnorm",
    use_bias=False,
    tie_embeddings=True,
    rope_theta=5_000_000.0,
    num_patches=2880,            # anyres: base 576 + 4 tiles x 576
)

SMOKE = reduced(CONFIG)
