"""granite-moe-1b-a400m — 32-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base]  24L d_model=1024 16H (GQA kv=8)
expert d_ff=512 vocab=49155."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=32, experts_per_token=8, moe_d_ff=512,
    rope_theta=10_000.0, activation="silu", norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, head_dim=16,
    num_experts=4, experts_per_token=2, moe_d_ff=64,
    activation="silu", norm="rmsnorm", tie_embeddings=True,
)

register(FULL, SMOKE)
