"""nemotron-4-15b — dense GQA with squared-ReLU MLP.
[arXiv:2402.16819]  32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000, head_dim=128,
    rope_theta=10_000.0, rope_pct=0.5, activation="relu2", norm="layernorm",
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    rope_pct=0.5, activation="relu2", norm="layernorm", tie_embeddings=False,
)

register(FULL, SMOKE)
