"""idle_share.query (%): the share of the traced window of a query cell in
which no operation ran on the device."""
from d4m_bench.readers import idle_share as read  # noqa: F401
