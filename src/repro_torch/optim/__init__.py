"""Optimizers of the port (port of ``repro.optim``)."""
from . import adamw, compression  # noqa: F401
