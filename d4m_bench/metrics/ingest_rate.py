"""ingest_rate (updates/s): every update accepted in the window over the
whole window, which ends at a synchronize (the paper's metric)."""
from d4m_bench.readers import rate as read  # noqa: F401
