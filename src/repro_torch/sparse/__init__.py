"""Row-valued associative arrays and the hierarchical embedding-gradient
path (port of ``repro.sparse``)."""
from . import convert, hier_grad, row_accum  # noqa: F401
