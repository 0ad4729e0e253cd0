"""Per-architecture configs (one module per arch of the reference + the
paper's own SIFT1M serving config).  ``get_arch`` / ``all_archs`` are the
public API."""

from .base import (  # noqa: F401
    ArchSpec,
    ShapeSpec,
    all_archs,
    get_arch,
    load_all,
    lm_shapes,
    recsys_shapes,
    register,
)
