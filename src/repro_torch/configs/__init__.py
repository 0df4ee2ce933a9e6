from .base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
from .registry import (  # noqa: F401
    ARCHS,
    SMOKE_SHAPE,
    all_cells,
    cell_skip_reason,
    get_config,
    smoke_config,
)
