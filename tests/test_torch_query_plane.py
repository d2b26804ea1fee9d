"""The port's query plane against the reference's, on the CPU.

Every :class:`StreamView` op and every ``sess.query`` op over a published
view equals the reference's op over its view of the same stream, bit for
bit (the reference's analytics jitted: eagerly they take tens of seconds to
dispatch).  A view stays valid across later updates, ``sess.query`` binds
to the latest published view while a serve runs, the serve loop's seeded
degree vectors equal the reference's reduction, and a loopback
``QueryClient`` run answers each query from the view it names.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import d4m as jd4m
from repro.core import analytics as jan
from repro.core import assoc as jas
from repro_torch import d4m as td4m
from repro_torch import serve as tserve

from _torch_parity import assert_assoc_same, assert_same

torch.set_num_threads(1)

BATCH, CUTS, SPACE, SNAP = 32, (8, 32), 40, 1024

J = {
    "degrees": jax.jit(jan.degrees, static_argnames=("cap", "sr")),
    "undirected_view": jax.jit(jan.undirected_view, static_argnames=("cap", "sr")),
    "triangle_count": jax.jit(jan.triangle_count, static_argnames=("cap_sq", "max_fanout", "sr")),
    "common_neighbors": jax.jit(jan.common_neighbors, static_argnames=("u", "v", "cap", "sr")),
    "jaccard": jax.jit(jan.jaccard, static_argnames=("u", "v", "cap", "sr")),
    "reachable_within": jax.jit(jan.reachable_within, static_argnames=("steps", "cap", "max_fanout", "sr")),
    "extract_row": jax.jit(jas.extract_row, static_argnames=("cap", "sr")),
    "get": jax.jit(jas.get, static_argnames=("sr",)),
}


@jax.jit
def _masked_sum(und):
    """The reference's triangle sum before its ``/ 6``: tr(A^3) as
    ``sum(A^2 (x) A)`` over the undirected support."""
    sq = jas.matmul(und, und, cap=4 * SNAP, max_fanout=32)
    masked = jas.elem_mul(sq, und, cap=4 * SNAP)
    return jnp.where(masked.rows != jas.PAD, masked.vals, 0.0).sum()


def _ref_triangles(rv):
    """The reference's ``StreamView.triangles`` as it runs (eagerly: the
    sum, then an IEEE float32 division by 6), with the sum jitted."""
    und = J["undirected_view"](rv.snap, cap=2 * SNAP, sr=jd4m.PLUS_TIMES)
    assert rv.plan.max_fanout == 32
    return np.float32(_masked_sum(und)) / np.float32(6.0)


def _records(seed, n):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, SPACE, n).astype(np.int32),
        rng.integers(0, SPACE, n).astype(np.int32),
        rng.integers(1, 4, n).astype(np.float32),
    )


def _cfg(k):
    return jd4m.StreamConfig(
        cuts=CUTS, top_capacity=2048, batch_size=BATCH, instances_per_device=k, snapshot_cap=SNAP
    )


@pytest.fixture(scope="module")
def views():
    """A reference and a port session (K=1) fed the same 12 batches, each
    with a published view after 8 of them.  K=8 views are held to the
    reference below, through the serve loop."""
    k = 1
    ref = jd4m.D4MStream(_cfg(k))
    port = td4m.D4MStream.from_dict(_cfg(k).to_dict(), device="cpu")
    r, c, v = _records(k, 12 * BATCH)
    out = {}
    for t in range(12):
        s = slice(t * BATCH, (t + 1) * BATCH)
        ref.ingest(jnp.asarray(r[s]), jnp.asarray(c[s]), jnp.asarray(v[s]))
        port.ingest(r[s], c[s], v[s])
        if t == 7:
            out["rv"] = ref.view(records=8 * BATCH)
            out["pv"] = port.view(records=8 * BATCH)
            out["pv_rows"] = out["pv"].snap.rows.clone()
    out.update(ref=ref, port=port)
    return out


def _ref_degrees(vw):
    return J["degrees"](vw.snap, cap=vw.plan.snapshot_cap, sr=vw.sr)


OPS = {
    "snapshot": lambda pv, rv: assert_assoc_same(pv.snap, rv.snap, "snap"),
    "degrees": lambda pv, rv: [
        assert_assoc_same(g, w, "degrees") for g, w in zip(pv.degrees(), _ref_degrees(rv))
    ],
    "top_k_out": lambda pv, rv: [
        assert_same(g, w, "top_k") for g, w in zip(pv.top_k(7), jan.top_k_vertices(_ref_degrees(rv)[0], 7))
    ],
    "top_k_in": lambda pv, rv: [
        assert_same(g, w, "top_k") for g, w in zip(pv.top_k(5, by="in"), jan.top_k_vertices(_ref_degrees(rv)[1], 5))
    ],
    "row": lambda pv, rv: assert_assoc_same(
        pv.row(3), J["extract_row"](rv.snap, 3, cap=SNAP, sr=rv.sr), "row"
    ),
    "get": lambda pv, rv: [
        assert_same(pv.get(r, c), J["get"](rv.snap, r, c, sr=rv.sr), f"get{r},{c}")
        for r, c in ((3, 5), (0, 0), (SPACE + 1, 2))
    ],
    # the reference's own view op, which runs eagerly: jitted whole, XLA
    # divides by 6 as a multiply by 1/6 (ROADMAP C18, test below)
    "triangles": lambda pv, rv: assert_same(pv.triangles(), np.asarray(_ref_triangles(rv)), "triangles"),
    "common_neighbors": lambda pv, rv: assert_same(
        pv.common_neighbors(1, 2), J["common_neighbors"](rv.snap, u=1, v=2, cap=SNAP), "cn"
    ),
    "jaccard": lambda pv, rv: assert_same(
        pv.jaccard(1, 2), J["jaccard"](rv.snap, u=1, v=2, cap=SNAP), "jaccard"
    ),
    "reachable_within": lambda pv, rv: assert_assoc_same(
        pv.reachable_within(2),
        J["reachable_within"](rv.snap, steps=2, cap=SNAP, max_fanout=rv.plan.max_fanout),
        "reach",
    ),
    "stats": lambda pv, rv: [
        (pv.stats()[key] == rv.stats()[key]) or pytest.fail(key)
        for key in ("seq", "records", "engine", "nnz", "overflowed")
    ],
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_view_op_equals_the_references(views, op):
    OPS[op](views["pv"], views["rv"])


@pytest.mark.parametrize("op", ["top_k_out", "row", "get", "triangles", "jaccard"])
def test_session_query_over_a_published_view_equals_the_references(views, op):
    """``sess.query`` while serving answers over the published view, not
    over the live state, which has four more batches."""
    port, rv = views["port"], views["rv"]
    port._serving = True
    try:
        bound = port.query._resolve()
        assert bound is views["pv"] and bound is port.latest_view()
        OPS[op](bound, rv)
    finally:
        port._serving = False


def test_reference_triangle_count_rounds_otherwise_under_jit(views):
    """A fact about the reference (ROADMAP C18): where the masked sum is
    not a multiple of 6, its jitted ``triangle_count`` differs from the
    eager one (which the port and ``StreamView.triangles`` give) in the
    last bit: XLA turns ``/ 6.0`` into ``* (1/6)``."""
    rv = views["rv"]
    und = J["undirected_view"](rv.snap, cap=2 * SNAP, sr=jd4m.PLUS_TIMES)
    jitted = np.asarray(J["triangle_count"](und, cap_sq=4 * SNAP, max_fanout=rv.plan.max_fanout))
    eager = np.asarray(_ref_triangles(rv))
    assert int(_masked_sum(und)) % 6 != 0, "this stream's sum is a multiple of 6"
    assert abs(int(jitted.view(np.int32)) - int(eager.view(np.int32))) == 1
    assert_same(views["pv"].triangles(), eager, "port = eager")


def test_view_stays_valid_across_later_updates(views):
    port, pv = views["port"], views["pv"]
    assert torch.equal(pv.snap.rows, views["pv_rows"])  # four batches later
    assert port.nnz() > int(pv.nnz)
    live = port.query._resolve()
    assert live is not pv and live.seq == pv.seq  # library mode: unpublished
    assert_assoc_same(live.snap, views["ref"].snapshot(), "live")
    nxt = port.view()
    assert nxt.seq == pv.seq + 1 and port.latest_view() is nxt


@pytest.mark.parametrize("k", [1, 8])
def test_served_views_seed_the_references_degrees(k):
    """The serve loop's incremental degree vectors, seeded into each
    published view, equal the reference's reduction of the same stream
    (integer weights: the fold is exact in any order).  At K=8 they are
    held to the port's own reduction of its snapshot, which
    ``test_torch_serve`` holds to the reference's snapshot bit for bit
    (one more reference K=8 session here would cost seconds)."""
    n = 20 * BATCH
    r, c, v = _records(10 + k, n)
    port = td4m.D4MStream.from_dict(_cfg(k).to_dict(), device="cpu")
    report = port.serve(tserve.ArraySource(r, c, v, chunk_records=BATCH), max_latency_ms=1e9,
                        publish_every=5)
    assert report.drained and report.telemetry.views_published == 1 + 4 + 1
    final = port.latest_view()
    assert final.records == n and final.seq == 6
    if k == 1:
        ref = jd4m.D4MStream(_cfg(k))
        for lo in range(0, n, BATCH):
            s = slice(lo, lo + BATCH)
            ref.ingest(jnp.asarray(r[s]), jnp.asarray(c[s]), jnp.asarray(v[s]))
        want = J["degrees"](ref.snapshot(), cap=SNAP, sr=ref.sr)
    else:
        from repro_torch.core import analytics as tan

        want = tan.degrees(port.snapshot(), cap=SNAP, sr=port.sr)
    assert SNAP in final._degree_cache  # seeded, not reduced
    for g, w in zip(final.degrees(), want):
        assert_assoc_same(g, w, "seeded degrees")


def test_loopback_queries_answer_from_the_view_they_name():
    """A ``QueryClient`` inserts and queries on one loopback connection
    while the stream runs; each reply equals the same op on the published
    view whose sequence number it carries."""
    r, c, v = _records(21, 16 * BATCH)
    sess = td4m.D4MStream.from_dict(_cfg(8).to_dict(), device="cpu")
    published = {}
    view = sess.view

    def recording_view(*a, **kw):
        vw = view(*a, **kw)
        if kw.get("publish", True):
            published[vw.seq] = vw
        return vw

    sess.view = recording_view
    src = tserve.TCPSource(port=0, encoding="binary").start()
    replies = []

    def client():
        with tserve.QueryClient("127.0.0.1", src.port, encoding="binary", timeout_s=10) as qc:
            for t in range(16):
                qc.insert(r[t * BATCH:(t + 1) * BATCH], c[t * BATCH:(t + 1) * BATCH], v[t * BATCH:(t + 1) * BATCH])
                for op, args in (("degrees", {}), ("top_k", {"k": 4}), ("row", {"r": 2}),
                                 ("get", {"r": 2, "c": 3}), ("stats", {})):
                    replies.append((op, args, qc.request(op, **args)))

    th = threading.Thread(target=client, daemon=True)
    th.start()
    report = sess.serve(src, max_latency_ms=1e9, publish_every=2, timeout=30)
    th.join(timeout=30)
    assert not th.is_alive() and report.drained and report.records_fed == 16 * BATCH
    assert len(replies) == 16 * 5
    for op, args, rep in replies:
        assert rep.ok, rep.error
        vw = published[rep.view_seq]
        if op == "degrees":
            out, inn = vw.degrees()
            for name, a in (("out", out), ("in", inn)):
                n = int(a.nnz)
                np.testing.assert_array_equal(rep.arrays[f"{name}_ids"], a.rows[:n].numpy())
                np.testing.assert_array_equal(rep.arrays[f"{name}_vals"], a.vals[:n].numpy())
        elif op == "top_k":
            ids, vals = vw.top_k(4)
            np.testing.assert_array_equal(rep.arrays["ids"], ids.numpy())
            np.testing.assert_array_equal(rep.arrays["vals"], vals.numpy())
        elif op == "row":
            a = vw.row(2)
            np.testing.assert_array_equal(rep.arrays["cols"], a.cols[: int(a.nnz)].numpy())
            np.testing.assert_array_equal(rep.arrays["vals"], a.vals[: int(a.nnz)].numpy())
        elif op == "get":
            assert rep.scalars["value"] == float(vw.get(2, 3))
        else:
            assert rep.scalars["seq"] == vw.seq and rep.scalars["records"] == vw.records
