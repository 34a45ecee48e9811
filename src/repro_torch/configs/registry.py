"""Architecture registry of the port: ``--arch <id>`` -> ArchConfig.

Every architecture of ``repro.configs.registry`` (the same ten ids).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# arch id -> module holding CONFIG
_MODULES: dict[str, str] = {
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "phi-3-vision-4.2b": "repro_torch.configs.phi_3_vision_4_2b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
}


def list_archs() -> list[str]:
    return list(_MODULES.keys())


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {', '.join(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
