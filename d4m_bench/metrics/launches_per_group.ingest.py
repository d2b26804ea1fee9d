"""launches_per_group.ingest (count): device operations (kernels, copies,
fills) launched inside the benchmark's ``ingest`` ranges, per group."""


def read(rec):
    t = rec.trace
    n = t.range_count.get("ingest", 0) if t is not None else 0
    if not n or not t.range_ops.get("ingest"):
        return None
    return t.range_ops["ingest"] / n
