"""Optimizers of the port (port of ``repro.optim``)."""
from . import adamw  # noqa: F401
