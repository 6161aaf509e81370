from repro_torch.configs.base import (ARCH_NAMES, SHAPES, ModelConfig,
                                     ShapeConfig, all_cells, get, get_smoke,
                                     shape_cells)

__all__ = ["ARCH_NAMES", "SHAPES", "ModelConfig", "ShapeConfig", "all_cells",
           "get", "get_smoke", "shape_cells"]
