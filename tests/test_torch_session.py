"""The port's ``D4MStream`` against the reference's, on the CPU.

One ``repro.d4m.StreamConfig`` goes to both packages through its
``to_dict()`` wire form, the same numpy batches go through ``ingest``, and
snapshots, ``nnz``, ``overflowed``, the telemetry arrays,
``query.top_k`` and the graph queries must be bit-identical.  The reference's ``pallas`` engine
is held against the port's ``cuda`` engine (its plain version, on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import d4m as jd4m
from repro.core import analytics as jan
from repro.core import assoc as jas
from repro.core import hierarchical as jh
from repro.core import multistream as jm
from repro.d4m import session as jsession
from repro_torch import d4m as td4m
from repro_torch.core import assoc as tassoc
from repro_torch.core import convert
from repro_torch.core import hierarchical as th
from repro_torch.core import multistream as tm
from repro_torch.kernels.hier_cascade import ops as tops

from _torch_parity import assert_assoc_same, assert_same, stream

torch.set_num_threads(1)

SPACE = 64
SNAP_CAP = 1024


def _pair(engine, k, cuts=(8, 32), top=256, batch=16, srn="plus.times"):
    cfg = jd4m.StreamConfig(
        cuts=cuts, top_capacity=top, batch_size=batch, instances_per_device=k,
        engine=engine, semiring=srn,
    )
    ref = jd4m.D4MStream(cfg)
    port = td4m.D4MStream.from_dict(cfg.to_dict(), device="cpu")
    return ref, port


def _assert_sessions_same(port, ref, cap=SNAP_CAP):
    assert_assoc_same(port.snapshot(cap=cap), ref.snapshot(cap=cap), "snapshot")
    assert port.nnz() == ref.nnz()
    assert port.overflowed() == ref.overflowed()
    tp, tr = port.telemetry(), ref.telemetry()
    for key in ("nnz_total", "overflowed", "n_instances", "instances_per_device", "state_bytes"):
        assert tp[key] == tr[key], key
    for key in ("cascades", "cascades_per_instance", "nnz_per_instance", "overflowed_per_instance"):
        assert (key in tp) == (key in tr), key
        if key in tr:
            assert_same(tp[key], np.asarray(tr[key]), key)
    if "nnz_per_layer" in tr:
        assert tp["nnz_per_layer"] == tr["nnz_per_layer"]
    # the reference's query.top_k, jitted: degrees over its default-cap
    # snapshot, then top_k (eager, it takes tens of seconds to dispatch)
    deg = jax.jit(jan.degrees, static_argnames=("cap", "sr"))(
        ref.snapshot(), cap=ref.plan.snapshot_cap, sr=ref.sr
    )
    for got, want in zip(port.query.top_k(10), jan.top_k_vertices(deg[0], 10)):
        assert_same(got, want, "top_k")
    for got, want in zip(port.query.top_k(5, by="in"), jan.top_k_vertices(deg[1], 5)):
        assert_same(got, want, "top_k in")


def _feed(sessions, seed, steps, batch, space=SPACE):
    r, c, v = stream(seed, (steps, batch), space)
    for t in range(steps):
        drops = [int(s.ingest(r[t], c[t], v[t])) for s in sessions]
        assert len(set(drops)) == 1, drops


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize(
    "cuts,top", [((512,), 2048), ((8, 32), 256), ((8,), 40)],
    ids=["absent", "forced", "overflow"],
)
def test_session_matches_reference(k, cuts, top):
    ref, port = _pair("auto", k, cuts, top)
    assert port.kind == ref.kind == ("single" if k == 1 else "packed")
    _feed([ref, port], 0, 6, 16, space=SPACE if top > 100 else 256)
    _assert_sessions_same(port, ref)
    fired = int(port.state.cascades[..., 1:].sum())
    assert (fired == 0) if cuts == (512,) else (fired > 0)
    if top < 100 and k == 1:
        assert port.overflowed()


@pytest.mark.parametrize("srn,k", [("max.plus", 8), ("min.plus", 1), ("union.first", 1)])
def test_session_semirings(srn, k):
    ref, port = _pair("auto", k, srn=srn)
    _feed([ref, port], 1, 5, 16)
    _assert_sessions_same(port, ref)


def test_pallas_engine_maps_to_cuda_engine():
    ref, port = _pair("pallas", 2)
    assert ref.kind == "pallas" and port.kind == "cuda"
    assert port.config.to_dict()["engine"] == "pallas"  # the reference's wire name
    _feed([ref, port], 2, 4, 16, space=24)
    assert int(port.state.cascades[:, 1].sum()) > 0
    _assert_sessions_same(port, ref)


def test_ingest_stream_and_route():
    ref, port = _pair("auto", 8)
    r, c, v = stream(3, (5, 16), SPACE)
    routed = [port.route(r[t], c[t], v[t]) for t in range(5)]
    R, C, V = (torch.stack([x[i] for x in routed]) for i in range(3))
    for t in range(5):
        want = ref.route(r[t], c[t], v[t])
        for g, w in zip(routed[t], want):
            assert_same(g, w, "route")
    trace = port.ingest_stream(R, C, V)
    want = ref.ingest_stream(R.numpy(), C.numpy(), V.numpy())
    assert_same(trace, want, "trace")
    _assert_sessions_same(port, ref)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td4m.D4MStream(cfg)


@pytest.mark.parametrize("build", [
    lambda: tassoc.empty(4),
    lambda: th.init((8,), 64, 8),
    lambda: tm.init_packed(2, (8,), 64, 8),
    lambda: tops.init_state(2, (8,), 64, 8),
    lambda: convert.hier_from_numpy([], np.zeros(1, np.int32)),
], ids=["assoc.empty", "hierarchical.init", "init_packed", "init_state", "hier_from_numpy"])
def test_constructors_default_to_the_card(monkeypatch, build):
    """Every constructor of state runs on the card unless given a device:
    without CUDA it raises and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def test_config_rejects_what_is_not_ported():
    # devices > 1 resolves to the mesh engine, as in the reference, and a
    # session builds on a mesh of two shards
    two = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, devices=2)
    assert two.resolved_engine("cpu") == "mesh"
    assert jd4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, devices=2).resolved_engine() == "mesh"
    from repro_torch.core.mesh import Mesh

    sess = td4m.D4MStream(two, mesh=Mesh([torch.device("cpu")] * 2, ("data",)))
    assert sess.kind == "mesh" and sess.n_instances == 2
    with pytest.raises(ValueError, match="must not exceed"):
        td4m.StreamConfig(
            cuts=(8,), top_capacity=64, batch_size=8, serve=td4m.ServeConfig(max_batch=16)
        ).validate()
    cfg = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, instances_per_device=4)
    assert cfg.resolved_engine("cpu") == "packed"
    assert cfg.resolved_engine("cuda") == "cuda"
    ref = jd4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, instances_per_device=4)
    assert cfg.plan() == td4m.StreamConfig.from_dict(ref.to_dict()).plan()
    assert cfg.plan().layer_caps == ref.plan().layer_caps
    assert cfg.plan().total_bytes == ref.plan().total_bytes


@pytest.mark.parametrize("engine", ["packed", "pallas"])
def test_state_carried_across(engine):
    """Run the reference 3 steps, carry its state into the port with
    ``hier_from_numpy``, run both 3 more steps: identical."""
    k, batch = 8, 16
    ref, port = _pair("packed", k)
    _feed([ref], 4, 3, batch)
    h = ref.state
    if engine == "pallas":  # the kernel engine's power-of-two layout
        h = jax.vmap(jh.pad_layers_pow2)(h)
        port = td4m.D4MStream.from_dict(
            dict(ref.config.to_dict(), engine="pallas"), device="cpu"
        )
        assert port.kind == "cuda"
    layers = [
        tuple(np.asarray(x) for x in (l.rows, l.cols, l.vals, l.nnz, l.overflow))
        for l in h.layers
    ]
    port.state = convert.hier_from_numpy(layers, np.asarray(h.cascades), device="cpu")
    r, c, v = stream(5, (3, batch), SPACE)
    for t in range(3):
        assert int(ref.ingest(r[t], c[t], v[t])) == int(port.ingest(r[t], c[t], v[t]))
    _assert_sessions_same(port, ref)


def test_single_session_graph_queries_match_reference():
    """``query.triangles/common_neighbors/jaccard/reachable_within/row/get``
    of a ``single`` session against the reference's analytics on the
    reference session's snapshot, bit for bit."""
    ref, port = _pair("auto", 1, cuts=(8, 32), top=256)
    assert port.kind == "single"
    _feed([ref, port], 6, 6, 16, space=24)
    snap = ref.snapshot()
    plan = ref.plan
    und = jax.jit(jan.undirected_view, static_argnames=("cap", "sr"))(
        snap, cap=2 * plan.snapshot_cap, sr=jd4m.PLUS_TIMES
    )
    tri = jax.jit(jan.triangle_count, static_argnames=("cap_sq", "max_fanout", "sr"))(
        und, cap_sq=4 * plan.snapshot_cap, max_fanout=plan.max_fanout
    )
    assert_same(port.query.triangles(), tri, "triangles")
    assert float(port.query.triangles()) > 0
    for u, v in ((1, 2), (3, 3)):
        want = jax.jit(jan.common_neighbors, static_argnames=("u", "v", "cap", "sr"))(
            snap, u=u, v=v, cap=plan.snapshot_cap)
        assert_same(port.query.common_neighbors(u, v), want, "common_neighbors")
        want = jax.jit(jan.jaccard, static_argnames=("u", "v", "cap", "sr"))(
            snap, u=u, v=v, cap=plan.snapshot_cap)
        assert_same(port.query.jaccard(u, v), want, "jaccard")
    want = jax.jit(jan.reachable_within, static_argnames=("steps", "cap", "max_fanout", "sr"))(
        snap, steps=2, cap=plan.snapshot_cap, max_fanout=plan.max_fanout)
    assert_assoc_same(port.query.reachable_within(2), want, "reachable_within")
    assert_assoc_same(port.query.row(3), jax.jit(jas.extract_row, static_argnames=("cap", "sr"))(
        snap, 3, cap=plan.snapshot_cap), "row")
    assert_same(port.query.get(3, 5), jas.get(snap, 3, 5), "get")


@pytest.mark.parametrize("k", [None, 4])
def test_scan_ingest_and_snapshot_matches_reference(k):
    cuts = (8, 32)
    shape = (5, 16) if k is None else (5, k, 16)
    r, c, v = stream(7, shape, 24)
    if k is None:
        hj, ht = jh.init(cuts, 256, 16), th.init(cuts, 256, 16, device="cpu")
    else:
        hj = jax.vmap(lambda _: jh.init(cuts, 256, 16))(jnp.arange(k))
        ht = tm.init_packed(k, cuts, 256, 16, device="cpu")
    want = jsession.scan_ingest_and_snapshot(hj, r, c, v, cuts, 512, instances=k)
    got = td4m.scan_ingest_and_snapshot(
        ht, torch.tensor(r), torch.tensor(c), torch.tensor(v), cuts, 512, instances=k
    )
    assert_assoc_same(got[1], want[1], "snapshot")
    assert_same(got[2], want[2], "trace")
    if k is not None:
        assert_same(tm.cascades_per_instance(got[0]), jm.cascades_per_instance(want[0]))
