from .base import as_preconditioner  # noqa: F401
