"""jamba-v0.1-52b — hybrid Mamba + attention (1:7 interleave) with 16-expert
top-2 MoE on odd layers.  [arXiv:2403.19887; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Adaptations (DESIGN.md): Jamba ships Mamba-1 layers; we use the Mamba2/SSD
formulation (TPU-friendly chunked matmuls) with Jamba's small state (16).
Jamba uses no positional encoding; we keep RoPE on its 4 attention layers
(harmless, documented)."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    num_experts=16, experts_per_token=2, moe_d_ff=14336,
    attn_period=8, attn_offset=3, moe_period=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    activation="silu", norm="rmsnorm", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    num_experts=4, experts_per_token=2, moe_d_ff=128,
    attn_period=4, attn_offset=1, moe_period=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=32,
    activation="silu", norm="rmsnorm", tie_embeddings=False,
)

register(FULL, SMOKE)
