"""Synthetic data streams of the port."""
from . import rmat  # noqa: F401
