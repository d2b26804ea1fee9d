"""What the metric readers (``metrics/<metric>.py``) share.  Each returns
``None`` where the run holds nothing to read, and the harness then leaves
the metric out of the result."""


def rate(rec):
    """Every update accepted in the window over the whole window, which ends
    at a synchronize."""
    return rec.updates / rec.window_s if rec.window_s > 0 else None


def idle_share(rec):
    """% of the traced window in which no operation ran on the device."""
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def range_ms(rec, name):
    """Device time (ms) of the operations launched inside one of the
    benchmark's ``name`` ranges, averaged over those ranges."""
    t = rec.trace
    n = t.range_count.get(name, 0) if t is not None else 0
    if not n or not t.range_device_s.get(name):
        return None
    return 1e3 * t.range_device_s[name] / n


def range_device_s(rec, name):
    """Device time (s) of every operation launched inside the ``name``
    ranges of the traced window, or 0."""
    return rec.trace.range_device_s.get(name, 0.0) if rec.trace is not None else 0.0
