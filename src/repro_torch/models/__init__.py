"""Model configurations of the port (port of ``repro.models.config``)."""
from . import config  # noqa: F401
