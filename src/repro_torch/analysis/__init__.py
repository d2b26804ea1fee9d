"""Analytic cost models of the port (``flops``: FLOP and HBM-byte counts
an architecture's steps need, the bounds for the card's numbers)."""
from . import flops  # noqa: F401
