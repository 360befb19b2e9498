"""Model zoo of the port."""
from . import transformer, vision  # noqa: F401
