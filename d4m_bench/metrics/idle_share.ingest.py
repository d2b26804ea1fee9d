"""idle_share.ingest (%): the share of the traced window of an ingest cell
in which no operation ran on the device."""
from d4m_bench.readers import idle_share as read  # noqa: F401
