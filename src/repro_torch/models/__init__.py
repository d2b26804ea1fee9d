"""The LM side of the port (port of ``repro.models``): configurations, the
layers, MLA, Mamba-2, MoE, the transformer forward, static-cache decode and
the weight carry-over from the reference's param trees."""
from . import config  # noqa: F401
