"""stablelm-1.6b — dense, kv=32 (full MHA), partial RoPE, LayerNorm, QKV bias.
[hf:stabilityai/stablelm-2-1_6b]  24L d_model=2048 32H d_ff=5632 vocab=100352."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352, head_dim=64,
    rope_theta=10_000.0, rope_pct=0.25, activation="silu", norm="layernorm",
    qkv_bias=True, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="stablelm-1.6b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512, head_dim=16,
    rope_pct=0.25, activation="silu", norm="layernorm", qkv_bias=True,
    tie_embeddings=False,
)

register(FULL, SMOKE)
