"""internvl2-2b — InternViT frontend (stub) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The ViT frontend is a stub: input_specs() provides 256 precomputed patch
embeddings prepended inside the sequence window."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    num_patches=256, rope_theta=1_000_000.0, activation="silu",
    norm="rmsnorm", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="internvl2-2b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    num_patches=4, activation="silu", norm="rmsnorm", tie_embeddings=False,
)

register(FULL, SMOKE)
