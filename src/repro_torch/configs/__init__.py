from .base import ArchSpec, ShapeSpec, get_arch, lm_shapes, register  # noqa: F401
