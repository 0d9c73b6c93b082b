"""qwen3-moe-235b-a22b — 128-expert top-8 MoE.
[hf:Qwen/Qwen3-*; hf]  94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    rope_theta=1_000_000.0, activation="silu", norm="rmsnorm",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen3-moe-235b-a22b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, head_dim=16,
    num_experts=4, experts_per_token=2, moe_d_ff=64,
    activation="silu", norm="rmsnorm", tie_embeddings=False,
)

register(FULL, SMOKE)
