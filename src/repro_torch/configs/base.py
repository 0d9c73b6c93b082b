"""Model configuration schema + assigned input shapes.

Every assigned architecture provides a full config (exact published numbers)
and a reduced smoke config (same family, tiny dims) via its module in
`repro_torch.configs`.  `input_specs()` gives the `(shape, dtype)` of every
model input of a step function, allocating nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Jamba) ---
    attn_period: int = 0        # 1 attention layer per `attn_period` layers
    attn_offset: int = 3        # position of the attention layer in the period
    moe_period: int = 0         # MoE FFN every `moe_period` layers
    # --- attention ---
    window: int = 0             # sliding-window size (0 = full attention)
    rope_theta: float = 10_000.0
    activation: str = "silu"    # silu | gelu | relu2
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_pct: float = 1.0       # fraction of head_dim rotated (stablelm: 0.25)
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # --- vlm ---
    num_patches: int = 0
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window attention."""
        return self.family in ("ssm", "hybrid") or self.window > 0


def padded_vocab(vocab: int, multiple: int = 256) -> int:
    """The vocab padded to a multiple of 256, as the reference pads it, so
    parameter shapes match it leaf for leaf.  Padded logit columns are
    masked to -1e30 at use sites."""
    return (vocab + multiple - 1) // multiple * multiple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k only for sub-quadratic archs."""
    if shape == "long_500k":
        return cfg.is_subquadratic
    return True


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """`(shape, dtype)` of every model input of a step function.

    train:   {tokens, labels[, patch_embeds | audio_frames]}
    prefill: {tokens[, frontend embeds]}
    decode:  {tokens (B, 1)}  (the KV/state cache itself is part of the
             serve state, not an input spec)
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, L = shape.global_batch, shape.seq_len
    i32 = torch.int32
    out: dict[str, tuple[tuple[int, ...], torch.dtype]] = {}
    if shape.kind in ("train", "prefill"):
        text_len = L - cfg.num_patches if cfg.family == "vlm" else L
        out["tokens"] = ((B, text_len), i32)
        if shape.kind == "train":
            out["labels"] = ((B, text_len), i32)
    else:  # decode: one new token against a seq_len-deep cache
        out["tokens"] = ((B, 1), i32)
    if cfg.family == "vlm" and shape.kind != "decode":
        # precomputed ViT patch embeddings (frontend is a stub)
        out["patch_embeds"] = ((B, cfg.num_patches, cfg.d_model), cfg.dtype)
    if cfg.family == "audio" and shape.kind != "decode":
        # precomputed conv-frontend frame embeddings
        out["audio_frames"] = ((B, cfg.encoder_frames, cfg.d_model), cfg.dtype)
    return out


# ---------------------------------------------------------------- registry ------

_REGISTRY: dict[str, tuple[ModelConfig, ModelConfig]] = {}


def register(full: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[full.name] = (full, smoke)
    return full


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    full, sm = _REGISTRY[name]
    return sm if smoke else full


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
