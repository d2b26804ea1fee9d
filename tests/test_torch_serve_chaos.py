"""The serve-layer chaos cases of ``tests/faults/test_serve_chaos.py`` that
the port's serve tests did not mirror yet, against the port's
``D4MServer`` with the reference's seeds (``tests/faults/seeds.json``):
a producer's truncated frame and a peer reset (every record accounted:
``records_in == records_fed + records_dropped``, the torn tail counted
malformed), a stalled consumer under ``block`` backpressure (nothing lost,
the snapshot bit-identical to an undisturbed run), and ``faults=None``."""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch import d4m, serve
from repro_torch.faults import FaultPlan, Trigger
from repro_torch.serve import wire

torch.set_num_threads(1)

BATCH = 32
CUTS = (8, 32)


def _seeds():
    with open(os.path.join(os.path.dirname(__file__), "faults", "seeds.json")) as f:
        return json.load(f)


def _records(seed, n, space=64):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, space, n).astype(np.int32),
        rng.integers(0, space, n).astype(np.int32),
        np.ones(n, np.float32),
    )


def _session():
    return d4m.D4MStream(d4m.StreamConfig(
        cuts=CUTS, top_capacity=4096, batch_size=BATCH, instances_per_device=1, snapshot_cap=8192,
    ), device="cpu")


def _assert_bit_identical(got, want):
    for a, b in ((got.rows, want.rows), (got.cols, want.cols), (got.vals, want.vals)):
        assert torch.equal(a, b)


def _serve_tcp(session, faults, send):
    src = serve.TCPSource(port=0, encoding="binary", linger=False)
    server = serve.D4MServer(
        session, src, d4m.ServeConfig(max_latency_ms=1e9, drain_timeout_s=600.0, faults=faults),
    ).start()
    t = threading.Thread(target=send, args=(src.port,), daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    server.join(timeout=600)
    return server.report()


@pytest.mark.parametrize("seed", _seeds()["record_seeds"])
def test_truncated_frame_is_counted_never_folded(seed):
    n = 8 * BATCH
    r, c, v = _records(seed, n)
    plan = FaultPlan().add("wire.truncate_frame", Trigger.nth(4))
    sent_box = {}

    def send(port):
        sent_box["sent"] = wire.send_triples("127.0.0.1", port, r, c, v, encoding="binary",
                                             chunk_records=BATCH, faults=plan)

    report = _serve_tcp(_session(), None, send)
    sent = sent_box["sent"]
    assert sent == 3 * BATCH, "the 4th chunk was the truncated one"
    assert report.records_fed == sent
    assert report.records_in == report.records_fed + report.records_dropped
    assert report.malformed >= 1, "the torn tail must be counted"
    assert plan.summary()["wire.truncate_frame"]["fires"] == 1


@pytest.mark.parametrize("seed", _seeds()["record_seeds"])
def test_connection_reset_loses_only_the_unparsed_tail(seed):
    n = 8 * BATCH
    r, c, v = _records(seed, n)
    plan = FaultPlan().add("source.conn_reset", Trigger.once_at(BATCH))

    def send(port):
        try:
            wire.send_triples("127.0.0.1", port, r, c, v, encoding="binary", chunk_records=BATCH, faults=None)
        except OSError:
            pass  # the receiver closed on us: expected

    report = _serve_tcp(_session(), plan, send)
    assert plan.summary()["source.conn_reset"]["fires"] == 1
    assert BATCH <= report.records_fed <= n
    assert report.records_in == report.records_fed + report.records_dropped
    assert report.telemetry.source_records == report.records_in


def test_slow_consumer_with_block_backpressure_is_lossless():
    n = 12 * BATCH
    r, c, v = _records(seed=1, n=n)
    ref = _session()
    ref.serve(serve.ArraySource(r, c, v, chunk_records=BATCH), max_latency_ms=1e9)
    want = ref.snapshot()
    plan = FaultPlan().add("router.slow_consumer", Trigger.nth(1), args={"seconds": 0.4})
    sess = _session()
    report = sess.serve(serve.ArraySource(r, c, v, chunk_records=BATCH), max_latency_ms=1e9, queue_depth=2,
                        backpressure="block", faults=plan)
    assert report.drained
    assert report.records_fed == n
    assert report.records_dropped == 0
    assert plan.summary()["router.slow_consumer"]["fires"] == 1
    _assert_bit_identical(sess.snapshot(), want)


def test_faults_none_leaves_serve_untouched():
    n = 4 * BATCH
    r, c, v = _records(seed=3, n=n)
    sess = _session()
    report = sess.serve(serve.ArraySource(r, c, v, chunk_records=BATCH), max_latency_ms=1e9)
    assert report.drained and report.records_fed == n
