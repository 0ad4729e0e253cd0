from .adamw import (  # noqa: F401
    OptConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    linear_schedule,
)
