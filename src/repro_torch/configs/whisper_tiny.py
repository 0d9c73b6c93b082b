"""whisper-tiny — encoder-decoder audio model; conv frontend is a stub
(input_specs() provides 1500 precomputed frame embeddings).
[arXiv:2212.04356]  4L(enc)+4L(dec) d_model=384 6H d_ff=1536 vocab=51865.
Deviation: RoPE replaces whisper's learned/sinusoidal positions so the
synthetic 32k-deep decode shapes stay well-defined (DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    is_encoder_decoder=True, encoder_layers=4, encoder_frames=1500,
    activation="gelu", norm="layernorm", qkv_bias=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    is_encoder_decoder=True, encoder_layers=2, encoder_frames=8,
    activation="gelu", norm="layernorm", qkv_bias=True, tie_embeddings=True,
)

register(FULL, SMOKE)
