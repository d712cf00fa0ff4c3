from repro_torch.configs.base import (
    ARCH_NAMES,
    SHAPES,
    ArchConfig,
    ShapeCfg,
    cells,
    get,
    get_smoke,
)

__all__ = ["ARCH_NAMES", "SHAPES", "ArchConfig", "ShapeCfg", "cells", "get", "get_smoke"]
