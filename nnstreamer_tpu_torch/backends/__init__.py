from .base import (  # noqa: F401
    FilterBackend,
    get_backend,
    known_backends,
    register_backend,
)
