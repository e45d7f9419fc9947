from repro_torch.configs.base import (
    FRONTEND_DIMS,
    SHAPES,
    ArchConfig,
    ShapeConfig,
    cell_skip_reason,
    get_arch,
    list_archs,
    reduce_config,
    register,
    valid_cells,
)

__all__ = [
    "ArchConfig",
    "FRONTEND_DIMS",
    "SHAPES",
    "ShapeConfig",
    "cell_skip_reason",
    "get_arch",
    "list_archs",
    "reduce_config",
    "register",
    "valid_cells",
]
