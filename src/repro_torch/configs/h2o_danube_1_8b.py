"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]  24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
SWA window 4096 => sub-quadratic; eligible for long_500k."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    window=4096, rope_theta=10_000.0, activation="silu", norm="rmsnorm",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    window=16, activation="silu", norm="rmsnorm", tie_embeddings=False,
)

register(FULL, SMOKE)
