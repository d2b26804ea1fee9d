"""update_roofline.ingest (%): the least time the update work of the traced
window needs at the card's HBM bandwidth (roofline.update_bytes: updates
and cascades, each entry read once and written once), over the device time
of the operations launched inside ``D4MStream.update`` (canonicalization
and the cascade step)."""
from d4m_bench import roofline
from d4m_bench.readers import range_device_s


def read(rec):
    busy = range_device_s(rec, "update")
    if busy <= 0 or not rec.peak_bytes_per_s:
        return None
    need = roofline.update_bytes(rec.updates, rec.cascades, rec.cuts, rec.value_itemsize)
    return 100.0 * need / rec.peak_bytes_per_s / busy
