"""Architecture registry of the port: ``--arch <id>`` resolution, the
reference's ten ids in the reference's order. An unknown id raises
``KeyError`` naming the available ones.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      MoEConfig, SSMConfig)

# arch id -> module
_ARCH_MODULES = {
    "kimi-k2-1t-a32b":       "repro_torch.configs.kimi_k2_1t_a32b",
    "qwen2-1.5b":            "repro_torch.configs.qwen2_1_5b",
    "rwkv6-1.6b":            "repro_torch.configs.rwkv6_1_6b",
    "zamba2-1.2b":           "repro_torch.configs.zamba2_1_2b",
    "qwen2.5-14b":           "repro_torch.configs.qwen2_5_14b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "paligemma-3b":          "repro_torch.configs.paligemma_3b",
    "granite-8b":            "repro_torch.configs.granite_8b",
    "granite-20b":           "repro_torch.configs.granite_20b",
    "mixtral-8x22b":         "repro_torch.configs.mixtral_8x22b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config"]
