from .synthetic import clustered_vectors  # noqa: F401
