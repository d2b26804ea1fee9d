"""Sorted-union merge with a semiring fold: ``assoc.add`` on the card."""
from . import ops  # noqa: F401
