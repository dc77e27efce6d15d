"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings) [arXiv:2212.04356; unverified]."""

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=12,               # 6 enc + 6 dec
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    vocab_pad=7,          # 51872 = 16*3242: vocab-shardable
    act="gelu",
    norm="layernorm",
    use_bias=True,
    learned_pos_emb=True,
    num_frames=1500,             # 30 s of audio after the conv frontend
    tie_embeddings=True,
)

SMOKE = reduced(CONFIG)
