"""``repro_torch.serve`` against ``repro.serve``, on the CPU.

* ``route_numpy`` equals the reference's ``route_numpy`` and the port's
  device router ``multistream.route_to_instances``, bit for bit;
* wire frames made by one package decode in the other, unchanged;
* an ``ArraySource`` served into a port session gives a state and
  snapshot bit-identical to a JAX session fed the same routed microbatches
  through ``update`` (the reference's library path, not its serve loop);
* kill -> restore -> replay lands bit-identical to the uninterrupted run
  (K=1 and K=8, as ``tests/serve/test_checkpoint_serve.py``);
* the drop policy counts every record it loses;
* ``ServeConfig`` validates as the reference's and its wire form crosses.
"""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import d4m as jd4m
from repro.serve import router as jrouter
from repro.serve import wire as jwire
from repro_torch import d4m as td4m
from repro_torch import serve as tserve
from repro_torch.core import multistream as tm
from repro_torch.faults import FaultPlan, Trigger
from repro_torch.serve import router as trouter
from repro_torch.serve import wire as twire

from _torch_parity import PAD, assert_assoc_same, assert_hier_same, assert_same

torch.set_num_threads(1)

BATCH = 32
CUTS = (8, 32)  # cascades fire during the run and during the replay
N = 40 * BATCH


def _records(seed, n=N, space=64):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, space, n).astype(np.int32),
        rng.integers(0, space, n).astype(np.int32),
        rng.integers(1, 4, n).astype(np.float32),
    )


def _cfg(k, engine="auto"):
    return jd4m.StreamConfig(
        cuts=CUTS, top_capacity=4096, batch_size=BATCH, instances_per_device=k,
        snapshot_cap=8192, engine=engine,
    )


def _port(k, engine="auto", **kw):
    return td4m.D4MStream.from_dict(_cfg(k, engine).to_dict(), device="cpu", **kw)


# -- routing ----------------------------------------------------------------

@pytest.mark.parametrize("k,slot_cap", [(1, 64), (8, 64), (8, 6), (5, 16)])
def test_route_numpy_equals_both_routers(k, slot_cap):
    rng = np.random.default_rng(k * 100 + slot_cap)
    r = rng.integers(-2**31, 2**31 - 1, 64, dtype=np.int64).astype(np.int32)
    c = rng.integers(-2**31, 2**31 - 1, 64, dtype=np.int64).astype(np.int32)
    r[::7] = PAD
    v = rng.normal(size=64).astype(np.float32)
    got = trouter.route_numpy(r, c, v, k, slot_cap, 0.0)
    want = jrouter.route_numpy(r, c, v, k, slot_cap, 0.0)
    dev = tm.route_to_instances(torch.tensor(r), torch.tensor(c), torch.tensor(v), k, slot_cap)
    for g, w, d in zip(got[:3], want[:3], dev[:3]):
        assert_same(g, w)
        assert_same(g, d)
    assert got[3] == want[3] == int(dev[3])
    np.testing.assert_array_equal(
        trouter.key_hash32_numpy(r, c), jrouter.key_hash32_numpy(r, c)
    )


# -- the wire ----------------------------------------------------------------

@pytest.mark.parametrize("encoding", ["text", "binary"])
@pytest.mark.parametrize("src,dst", [(twire, jwire), (jwire, twire)])
def test_wire_frames_decode_in_the_other_package(encoding, src, dst):
    r, c, v = _records(5, 50)
    v = v * np.float32(1.37)
    req = src.QueryRequest(op="row", args={"r": 3}, id=7)
    rep = src.QueryReply(
        id=7, ok=True, view_seq=4, view_records=90, staleness=2,
        scalars={"r": 3}, arrays={"cols": c[:5], "vals": v[:5]},
    )
    buf = src.encode(r, c, v, encoding) + src.encode_request(req, encoding)
    buf += src.encode_reply(rep, encoding)
    messages, rest, bad = dst.decode_messages(buf, encoding)
    assert rest == b"" and bad == 0
    kinds = [kind for kind, _ in messages]
    assert kinds == ["insert", "query", "reply"]
    (gr, gc, gv) = messages[0][1]
    np.testing.assert_array_equal(gr, r)
    np.testing.assert_array_equal(gc, c)
    np.testing.assert_array_equal(gv.view(np.int32), v.view(np.int32))
    assert messages[1][1].to_json() == req.to_json()
    got = messages[2][1]
    assert (got.id, got.ok, got.view_seq, got.view_records, got.staleness, got.scalars) == (
        7, True, 4, 90, 2, {"r": 3}
    )
    for name, a in rep.arrays.items():
        np.testing.assert_array_equal(got.arrays[name].view(np.int32), a.view(np.int32))
    assert twire.PROTOCOL_VERSION == jwire.PROTOCOL_VERSION


# -- served snapshot vs the reference library path ----------------------------

_REFS = {}


def _reference(k, r, c, v):
    """The JAX session fed the same routed microbatches through ``update``;
    one compiled session per K for the whole file."""
    if k not in _REFS:
        _REFS[k] = jd4m.D4MStream(_cfg(k))
    ref = _REFS[k].reset()
    for lo in range(0, r.shape[0], BATCH):
        br = np.full(BATCH, PAD, np.int32)
        bc = np.full(BATCH, PAD, np.int32)
        bv = np.zeros(BATCH, np.float32)
        n = min(BATCH, r.shape[0] - lo)
        br[:n], bc[:n], bv[:n] = r[lo:lo + n], c[lo:lo + n], v[lo:lo + n]
        if k > 1:
            br, bc, bv, dropped = jrouter.route_numpy(br, bc, bv, k, BATCH, 0.0)
            assert dropped == 0
        ref.update(jnp.asarray(br), jnp.asarray(bc), jnp.asarray(bv))
    return ref


@pytest.mark.parametrize("k,engine", [(1, "auto"), (8, "auto"), (8, "cuda")])
def test_served_snapshot_equals_the_reference_library_path(k, engine):
    r, c, v = _records(k)
    n = N - 7  # a ragged tail: the drain flushes a PAD-padded partial batch
    port = _port(k, engine)
    report = port.serve(tserve.ArraySource(r[:n], c[:n], v[:n], chunk_records=48), max_latency_ms=1e9)
    assert report.drained and report.records_fed == n and report.records_dropped == 0
    ref = _reference(k, r[:n], c[:n], v[:n])
    assert_hier_same(port.state, ref.state, "served")
    assert_assoc_same(port.snapshot(), ref.snapshot(), "snapshot")
    assert port.nnz() == ref.nnz() and not port.overflowed()


# -- kill -> restore -> replay --------------------------------------------------

@pytest.mark.parametrize("k", [1, 8])
def test_kill_restore_replay_is_bit_identical(k, tmp_path):
    r, c, v = _records(seed=10 + k)
    sess = _port(k, checkpoint_dir=str(tmp_path))
    server = tserve.D4MServer(
        sess,
        tserve.ArraySource(r, c, v, chunk_records=BATCH, throttle_s=0.004),
        td4m.ServeConfig(max_latency_ms=1e9, checkpoint_every=3),
    ).start()
    deadline = time.monotonic() + 30
    while not server.checkpoints and time.monotonic() < deadline:
        time.sleep(0.005)
    assert server.checkpoints, "no checkpoint happened within the deadline"
    server.stop(drain=False, timeout=30)
    report = server.report()
    assert not report.drained and report.records_fed < N

    fresh = _port(k, checkpoint_dir=str(tmp_path))
    cursor = fresh.restore()["cursor"]
    assert 0 < cursor < N and cursor % BATCH == 0
    replay = fresh.serve(
        tserve.ArraySource(r[cursor:], c[cursor:], v[cursor:], chunk_records=BATCH),
        max_latency_ms=1e9, timeout=30,
    )
    assert replay.drained and replay.records_fed == N - cursor
    ref = _reference(k, r, c, v)
    assert_hier_same(fresh.state, ref.state, "replayed")
    assert_assoc_same(fresh.snapshot(), ref.snapshot(), "snapshot")


def test_drain_takes_a_final_checkpoint(tmp_path):
    r, c, v = _records(seed=2, n=6 * BATCH)
    sess = _port(1, checkpoint_dir=str(tmp_path))
    report = sess.serve(
        tserve.ArraySource(r, c, v, chunk_records=BATCH), max_latency_ms=1e9, checkpoint_every=4
    )
    assert [cp["step"] for cp in report.checkpoints] == [4, 6]
    fresh = _port(1, checkpoint_dir=str(tmp_path))
    extra = fresh.restore()
    assert extra["cursor"] == 6 * BATCH and extra["final"]
    assert_assoc_same(fresh.snapshot(), sess.snapshot(), "restored")


# -- backpressure ------------------------------------------------------------------

def test_drop_policy_counts_every_lost_record():
    r, c, v = _records(seed=3)
    sess = _port(8)
    plan = FaultPlan().add("router.slow_consumer", Trigger.always(), args={"seconds": 0.005})
    report = sess.serve(
        tserve.ArraySource(r, c, v, chunk_records=4 * BATCH),
        max_latency_ms=1e9, queue_depth=1, backpressure="drop", faults=plan, timeout=30,
    )
    assert report.drained
    assert report.records_dropped > 0, "the slow consumer never made the queue drop"
    assert report.records_fed + report.records_dropped == report.records_in == N
    assert report.telemetry.routing_dropped == 0


def test_block_policy_loses_nothing():
    r, c, v = _records(seed=4)
    report = _port(8).serve(
        tserve.ArraySource(r, c, v, chunk_records=4 * BATCH), max_latency_ms=1e9, queue_depth=1,
        faults=FaultPlan().add("router.slow_consumer", Trigger.nth(2), args={"seconds": 0.005}),
    )
    assert report.records_fed == N and report.records_dropped == 0


# -- ServeConfig ---------------------------------------------------------------------

@pytest.mark.parametrize(
    "bad",
    [
        dict(max_batch=0), dict(max_latency_ms=0), dict(queue_depth=0),
        dict(backpressure="lossy"), dict(checkpoint_every=0),
        dict(checkpoint_every=2, backpressure="drop"), dict(publish_every=0),
        dict(publish_cap=8), dict(poll_interval_s=0), dict(drain_timeout_s=0),
        dict(metrics=1), dict(profile_dir=3),
    ],
)
def test_serve_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jd4m.ServeConfig(**bad).validate()
    with pytest.raises(ValueError):
        td4m.ServeConfig(**bad).validate()


def test_serve_config_wire_form_crosses_both_ways():
    t = td4m.ServeConfig(max_batch=16, publish_every=2, publish_cap=512, metrics=True,
                         checkpoint_every=4, profile_dir="/x")
    j = jd4m.ServeConfig.from_dict(t.to_dict())
    assert j.to_dict() == t.to_dict()
    assert td4m.ServeConfig.from_dict(j.to_dict()) == t
    sc = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=16, serve=t)
    back = jd4m.StreamConfig.from_dict(sc.to_dict())
    assert back.serve.to_dict() == t.to_dict()
    assert td4m.StreamConfig.from_dict(back.to_dict()) == sc
    with pytest.raises(ValueError, match="must not exceed"):
        td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, serve=t).validate()


def test_a_server_wants_the_sessions_device(monkeypatch):
    """A session (and so its server) given no device wants the card and
    raises without it; there is no CPU fallback on the serve path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td4m.D4MStream(td4m.StreamConfig.from_dict(_cfg(1).to_dict()))
