"""Architecture configs of the port."""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, list_archs

__all__ = ["ArchConfig", "get_config", "list_archs"]
