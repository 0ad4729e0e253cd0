from .ann_server import AnnServer, ServeStats  # noqa: F401
