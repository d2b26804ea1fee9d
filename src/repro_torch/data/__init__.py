"""Synthetic data streams of the port."""
from . import rmat, tokens  # noqa: F401
