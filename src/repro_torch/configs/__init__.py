"""Architecture configs of the port."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, input_specs, shape_applicable
from repro_torch.configs.registry import get_config, list_archs

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "input_specs", "shape_applicable", "get_config",
           "list_archs"]
