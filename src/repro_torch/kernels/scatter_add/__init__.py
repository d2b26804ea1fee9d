"""Row flush into a dense table: ``row_accum.to_dense`` on the card."""
from . import ops  # noqa: F401
