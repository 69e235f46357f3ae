"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures whose models are ported resolve; every other id
of the reference's registry raises ``KeyError`` naming the ported ones.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      MoEConfig, SSMConfig)

# arch id -> module, for the architectures the port runs so far
_ARCH_MODULES = {
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported; available: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config"]
