"""Architecture registry of the port: ``--arch <id>`` -> ArchConfig.

It holds only the architectures the port can run; the others arrive with
their blocks (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# arch id -> module holding CONFIG
_MODULES: dict[str, str] = {
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
}


def list_archs() -> list[str]:
    return list(_MODULES.keys())


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {', '.join(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
