"""publish_roofline (%): the least time the views of the traced window need
at the card's HBM bandwidth (roofline.snapshot_bytes: every live entry of
the state read once, every entry of the view written once), over the
device time of the operations launched inside ``D4MStream.view``."""
from d4m_bench import roofline
from d4m_bench.readers import range_device_s


def read(rec):
    busy = range_device_s(rec, "view")
    if busy <= 0 or not rec.view_entries or not rec.peak_bytes_per_s:
        return None
    need = sum(roofline.snapshot_bytes(s, v, rec.value_itemsize)
               for s, v in zip(rec.state_entries, rec.view_entries))
    return 100.0 * need / rec.peak_bytes_per_s / busy
