from .ann_server import AnnServer, ServeStats  # noqa: F401
from .lm_server import generate  # noqa: F401
