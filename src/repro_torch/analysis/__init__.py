"""Analytic cost models of the port (``flops``: FLOP and HBM-byte counts
an architecture's steps need, the bounds for the card's numbers;
``roofline``: the three-term roofline on an H100; ``report``: the dry
run's table)."""
from . import flops  # noqa: F401
