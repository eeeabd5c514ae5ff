from .tables import diffuse  # noqa: F401
