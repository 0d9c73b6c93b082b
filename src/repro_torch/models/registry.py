"""Model construction from configs."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models.lm import LM, ModelImpl


def build_model(cfg: ModelConfig | str, impl: ModelImpl | None = None,
                smoke: bool = False,
                device: torch.device | str | None = None) -> LM:
    """An ``LM`` for a config (or a registered arch name) on ``device``
    (default ``"cuda"``; raises without CUDA unless ``device="cpu"``)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg, smoke=smoke)
    return LM(cfg, impl=impl, device=device)
