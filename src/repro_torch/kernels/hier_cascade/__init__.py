"""Lane-skipping cascade kernel for the packed multi-stream engine."""
from . import ops  # noqa: F401
