from .ann_server import AnnServer, ServeStats  # noqa: F401
from .lm_server import generate  # noqa: F401
from .resilience import (  # noqa: F401
    CircuitBreaker,
    DegradationLadder,
    ResilienceConfig,
    ResilientAnnServer,
    Response,
    SearchFailure,
    default_tiers,
    validate_query,
)
