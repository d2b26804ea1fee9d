"""``repro_torch.obs`` against ``repro.obs``: histograms record, merge and
summarize the same nanosecond samples to the same integers; a registry
dump has the reference's shape; ``torch_profile`` is a no-op without a
directory.  Everything compared is exact."""
import json

import numpy as np
import pytest

from repro import obs as jo
from repro_torch import obs as to

SAMPLES = np.random.default_rng(3).lognormal(10, 3, 4000).astype(np.int64)


def _hist(mod, samples):
    h = mod.LatencyHistogram("x")
    for s in samples.tolist():
        h.record(int(s))
    return h


@pytest.mark.parametrize("cut", [0, 1, 1000, 4000])
def test_histogram_state_and_summary_are_the_reference_ones(cut):
    a, b = _hist(jo, SAMPLES[:cut]), _hist(to, SAMPLES[:cut])
    ja, ta = a.state(), b.state()
    assert json.dumps(ja, sort_keys=True, default=list) == json.dumps(ta, sort_keys=True, default=list)
    assert a.summary() == b.summary()
    for q in (0.01, 0.5, 0.9, 0.99, 1.0):
        assert a.percentile(q) == b.percentile(q)


def test_merge_and_percentiles_are_the_reference_ones():
    parts = [SAMPLES[:1000], SAMPLES[1000:2500], SAMPLES[2500:]]
    js = [_hist(jo, p).state() for p in parts]
    ts = [_hist(to, p).state() for p in parts]
    jm = jo.merge_states(jo.merge_states(js[0], js[1]), js[2])
    tm = to.merge_states(to.merge_states(ts[0], ts[1]), ts[2])
    assert np.array_equal(np.asarray(jm["counts"]), np.asarray(tm["counts"]))
    assert jo.summarize_state(jm) == to.summarize_state(tm)
    assert jo.state_percentile(jm, 0.99) == to.state_percentile(tm, 0.99)
    assert [jo.bucket_index(int(s)) for s in SAMPLES[:50]] == [
        to.bucket_index(int(s)) for s in SAMPLES[:50]
    ]


def _dump(mod):
    reg = mod.MetricsRegistry()
    reg.counter("c").inc(5)
    reg.gauge("g").set(2.5)
    h = reg.histogram("serve.publish_ns")
    for s in SAMPLES[:100].tolist():
        h.record(int(s))
    return reg


def test_registry_dump_and_prometheus_have_the_reference_shape():
    j, t = _dump(jo), _dump(to)
    jd, td = j.dump(), t.dump()
    assert json.dumps(jd, sort_keys=True, default=list) == json.dumps(td, sort_keys=True, default=list)
    assert j.to_prometheus() == t.to_prometheus()
    assert to.MetricsRegistry.merge_dumps([td, td])["counters"] == jo.MetricsRegistry.merge_dumps(
        [jd, jd]
    )["counters"]
    assert to.OBS_ENV_VAR == jo.OBS_ENV_VAR


def test_torch_profile_is_a_no_op_without_a_directory(tmp_path):
    with to.torch_profile(None):
        x = 1
    with to.torch_profile(""):
        x += 1
    assert x == 2 and not any(tmp_path.iterdir())


def test_torch_profile_writes_a_trace_into_its_directory(tmp_path):
    import torch

    with to.torch_profile(str(tmp_path)):
        torch.ones(4).sum()
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in json.loads(files[0].read_text())


def test_trace_ring_keeps_the_newest_events():
    ring = to.TraceRing(capacity=3)
    for i in range(5):
        ring.append("update", i, i + 1, batch=i)
    assert [e["batch"] for e in ring.events()] == [2, 3, 4] and ring.total == 5
