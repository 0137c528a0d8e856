"""Architecture configs: one module per assigned arch (+ shapes/registry)."""
from .base import (ARCH_IDS, SHAPES, SUBQUADRATIC_FAMILIES, ArchConfig,
                   ShapeSpec, all_cells, canonical, get, shape_applicable)

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC_FAMILIES", "ArchConfig",
           "ShapeSpec", "all_cells", "canonical", "get", "shape_applicable"]
