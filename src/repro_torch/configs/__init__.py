from .base import (  # noqa: F401
    ArchSpec,
    ShapeSpec,
    get_arch,
    lm_shapes,
    recsys_shapes,
    register,
)
