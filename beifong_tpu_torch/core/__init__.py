from .config import Band  # noqa: F401
