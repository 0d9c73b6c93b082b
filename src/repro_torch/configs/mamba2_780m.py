"""mamba2-780m — SSD (state-space duality), attention-free.
[arXiv:2405.21060]  48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    norm="rmsnorm", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=32,
    norm="rmsnorm", tie_embeddings=True,
)

register(FULL, SMOKE)
