"""Assigned architecture configs (one module per arch) + registry access."""
from repro_torch.configs.base import (ModelConfig, SHAPES, ShapeConfig,
                                      get_config, input_specs, list_archs,
                                      shape_applicable)

# importing the modules registers the configs
from repro_torch.configs import (granite_moe_1b_a400m,  # noqa: F401
                                 h2o_danube_1_8b, internvl2_2b,
                                 jamba_v0_1_52b, mamba2_780m, nemotron_4_15b,
                                 qwen3_moe_235b_a22b, stablelm_1_6b,
                                 whisper_tiny, yi_6b)

ALL_ARCHS = list_archs()

__all__ = ["ModelConfig", "SHAPES", "ShapeConfig", "get_config", "input_specs",
           "list_archs", "shape_applicable", "ALL_ARCHS"]
