"""ingest_rate.query (updates/s): the ingest rate of a query cell in its
traced window: every update accepted over the whole window, queries and
all (host clock).  A query waits behind the updates queued before it."""
from d4m_bench.readers import rate as read  # noqa: F401
