"""The port's mesh (``repro_torch.core.mesh``) and mesh engine
(``MultiStreamEngine``, ``D4MStream``'s ``mesh`` kind) on the CPU.

The collectives are held to numpy on a 2 x 3 grid, and counted.  A mesh
engine of D=4 shards x K=2 instances on a repeated CPU device is held to
the reference's ``packed`` engine at K=8 in this process: the same hash
route sends every key to the same one of the 8 instances, so the gathered
``[8]`` hierarchy must be bit-identical after every step, and so must the
snapshots, ``nnz``, the telemetry and the query plane.  D=1 is held to the
reference's one-device mesh."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import d4m as jd4m
from repro.core import analytics as jan
from repro.core import multistream as jm
from repro_torch import d4m as td4m
from repro_torch.benchmarks import bench_scaling
from repro_torch.core import mesh as tmesh
from repro_torch.core import multistream as tm
from repro_torch.core.mesh import Mesh, NamedSharding, P, Sharded

from _torch_parity import assert_assoc_same, assert_hier_same, assert_same, stream

CPU = torch.device("cpu")
SPACE = 64


def _grid(shape, names):
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [CPU] * devs.size
    return Mesh(devs.reshape(shape), names)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

GRID = (2, 3)
AXES = ("a", "b")


def _fold(op, xs):
    acc = xs[0].copy()
    for x in xs[1:]:
        acc = op(acc, x)
    return acc


def _numpy_collective(op, arr, idx, pos, n):
    """What device ``idx`` gets from ``op`` along axis ``pos``, in numpy."""
    group = [arr[idx[:pos] + (k,) + idx[pos + 1:]] for k in range(n)]
    if op == "psum":
        return _fold(np.add, group)
    if op == "pmax":
        return _fold(np.maximum, group)
    return np.stack([x[idx[pos]] for x in group])  # all_to_all


KINDS = {"psum": "all-reduce", "pmax": "all-reduce", "all_to_all": "all-to-all"}


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", sorted(KINDS))
def test_collective_equals_numpy_and_counts(op, axis, dtype):
    """float32 as the values, int32 as the dropped counts the session sums."""
    mesh = _grid(GRID, AXES)
    pos = AXES.index(axis)
    n = GRID[pos]
    rng = np.random.default_rng(hash((op, axis)) % 2**32)
    arr = (rng.normal(size=GRID + (n, 4)) * 1000).astype(dtype)
    xs = [torch.from_numpy(arr[idx].copy()) for idx in np.ndindex(GRID)]
    got = getattr(mesh, op)(xs, axis)
    for i, idx in enumerate(np.ndindex(GRID)):
        assert got[i].dtype == xs[i].dtype
        assert_same(got[i], _numpy_collective(op, arr, idx, pos, n), f"{op} {axis} {idx}")
    want = dict.fromkeys(tmesh.COLLECTIVES, 0)
    want[KINDS[op]] = 1
    assert mesh.collectives == want
    mesh.reset_collectives()
    assert sum(mesh.collectives.values()) == 0


def test_mesh_over_a_kind_of_device(monkeypatch):
    """The first n devices of a kind, or the devices in turn with repeat;
    fewer devices than shards without repeat raise, naming the mesh that
    repeats one."""
    one = Mesh.over("cpu", 1)
    assert one.device_list == [CPU] and one.axis_names == ("data",)
    four = Mesh.over("cpu", 4, axis="x", repeat=True)
    assert four.device_list == [CPU] * 4 and four.shape == {"x": 4} and four.distinct_devices() == 1
    with pytest.raises(ValueError, match=r"only 1 cpu device.*Mesh\(\[torch.device\('cpu'\)\] \* 4"):
        Mesh.over("cpu", 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = Mesh.over("cuda", 5, repeat=True)
    assert [d.index for d in cards.device_list] == [0, 1, 2, 0, 1]
    assert cards.distinct_devices() == 3
    assert [d.index for d in Mesh.over("cuda", 2).device_list] == [0, 1]
    with pytest.raises(ValueError, match="only 3 cuda"):
        Mesh.over("cuda", 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no cuda device"):
        Mesh.over("cuda", 1, repeat=True)


def test_mesh_reads_as_the_reference_reads_its_mesh():
    mesh = _grid(GRID, AXES)
    assert mesh.shape == {"a": 2, "b": 3} and mesh.axis_names == AXES and mesh.size == 6
    assert mesh.devices.shape == GRID and all(d == CPU for d in mesh.devices.ravel())
    assert mesh.axis_index("a") == [0, 0, 0, 1, 1, 1]
    assert mesh.axis_index("b") == [0, 1, 2, 0, 1, 2]
    assert mesh.distinct_devices() == 1
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    one = _grid((1, 1), ("data", "model"))
    assert dict(jmesh.shape) == one.shape and jmesh.axis_names == one.axis_names
    with pytest.raises(ValueError, match="2-d grid"):
        Mesh([CPU] * 4, ("a", "b"))
    with pytest.raises(ValueError, match="leading dimension of 3"):
        mesh.all_to_all([torch.zeros(2)] * 6, "b")
    with pytest.raises(ValueError, match="6 tensors"):
        mesh.psum([torch.zeros(1)] * 5, "a")


@pytest.mark.parametrize("spec,chunks", [
    (P(), [0] * 6), (P("a"), [0, 0, 0, 1, 1, 1]), (P("b"), [0, 1, 2, 0, 1, 2]),
    (P(("a", "b")), [0, 1, 2, 3, 4, 5]), (P(("b", "a")), [0, 2, 4, 1, 3, 5]),
])
def test_device_put_and_gather(spec, chunks):
    mesh = _grid(GRID, AXES)
    x = torch.arange(36, dtype=torch.float32).reshape(6, 6)
    placed = tmesh.device_put(x, NamedSharding(mesh, spec))
    assert mesh.chunk_of(spec) == (chunks, max(chunks) + 1)
    n = max(chunks) + 1
    for i, c in enumerate(chunks):
        assert_same(placed.shards[i], x[c * 6 // n:(c + 1) * 6 // n] if spec.axes else x)
    assert_same(placed.gather(), x)
    np.testing.assert_array_equal(np.asarray(placed), x.numpy())
    assert sum(mesh.collectives.values()) == 0  # placement is a transfer, not a collective
    # a view where the chunk already lies on its device, owned buffers with copy=True
    owned = tmesh.device_put(x, NamedSharding(mesh, spec), copy=True)
    assert placed.shards[-1].data_ptr() >= x.data_ptr()
    assert all(s.untyped_storage().data_ptr() != x.untyped_storage().data_ptr() for s in owned.shards)


def test_device_put_trees_and_specs():
    mesh = _grid((4,), ("data",))
    state = {"w": torch.arange(8.0).reshape(4, 2), "b": (torch.ones(4), np.arange(4, dtype=np.int32))}
    placed = tmesh.device_put(state, {"b": NamedSharding(mesh, P("data")),
                                      "w": NamedSharding(mesh, P())})
    assert isinstance(placed["w"], Sharded) and placed["w"].shards[3].shape == (4, 2)
    assert placed["b"][1].shards[2].tolist() == [2]
    with pytest.raises(ValueError, match="does not split"):
        tmesh.device_put(torch.ones(6), NamedSharding(mesh, P("data")))
    assert P(None, "data").axes == ("data",) and P(None, "data").dim_axes(0) == ()
    per_device = tmesh.local_shards(placed, mesh.size)
    assert len(per_device) == 4 and per_device[1]["b"][1].tolist() == [1]


def test_gather_and_split_a_packed_hierarchy():
    mesh = _grid((4,), ("data",))
    h = tm.init_packed(8, (8,), 64, 16, device="cpu")
    for i, l in enumerate(h.layers):
        l.rows.copy_(torch.arange(l.rows.numel(), dtype=torch.int32).reshape(l.rows.shape) + i)
        l.nnz.copy_(torch.arange(8, dtype=torch.int32))
    shards = tm.split_packed(h, mesh)
    assert len(shards) == 4 and all(s.cascades.shape == (2, 2) for s in shards)
    assert_same(shards[1].layers[0].nnz, torch.tensor([2, 3], dtype=torch.int32))
    back = tm.gather_packed(shards, "cpu")
    assert_hier_same(back, h)
    shards[0].layers[0].rows.fill_(0)  # owned: the source is untouched
    assert int(h.layers[0].rows[0, 1]) == 1


# ---------------------------------------------------------------------------
# the engine against the reference
# ---------------------------------------------------------------------------

def _engine(mesh, cuts, top, batch, k, srn="plus.times"):
    cfg = td4m.StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch, semiring=srn)
    return tm.MultiStreamEngine(mesh, cuts, top, batch, instances_per_device=k, sr=cfg.sr)


def _telemetry_same(tp, tr):
    """Equal counters; ``instances_per_device`` is K on both sides."""
    for key in ("nnz_total", "n_instances"):
        assert tp[key] == tr[key], key
    for key in ("nnz_per_instance", "cascades_per_instance", "overflowed_per_instance"):
        assert_same(tp[key], np.asarray(tr[key]), key)


@pytest.mark.parametrize("cuts,top,srn,records", [
    ((8, 32), 256, "plus.times", 16), ((512,), 2048, "plus.times", 16), ((8,), 4, "plus.times", 64),
    ((8, 32), 256, "max.plus", 16),
], ids=["forced", "absent", "overflow", "max.plus"])
def test_engine_d4_k2_equals_reference_packed_k8(cuts, top, srn, records):
    batch = 16
    ref = jd4m.D4MStream(jd4m.StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch,
                                           instances_per_device=8, engine="packed", semiring=srn))
    mesh = _grid((4,), ("data",))
    eng = _engine(mesh, cuts, top, batch, 2, srn)
    assert eng.n_instances == 8 and eng.n_devices == 4
    h = eng.init_state()
    r, c, v = stream(0, (6, records), SPACE if top > 100 else 256)
    for t in range(6):
        h, dropped = eng.ingest(h, torch.from_numpy(r[t]), torch.from_numpy(c[t]), torch.from_numpy(v[t]))
        assert sum(mesh.collectives.values()) == 0  # the update path holds no collective
        assert_same(dropped, np.asarray(ref.ingest(r[t], c[t], v[t])), "dropped")
        assert_hier_same(tm.gather_packed(h, "cpu"), ref.state, f"step {t}")
    fired = int(tm.gather_packed(h, "cpu").cascades[:, 1:].sum())
    assert (fired == 0) if cuts == (512,) else (fired > 0)
    assert bool(eng.overflowed_per_instance(h).any()) == (top < 100)
    cap = 1024
    assert_assoc_same(eng.snapshot(h, cap), ref.snapshot(cap=cap, per_instance=True), "snapshot")
    assert_assoc_same(eng.snapshot_global(h, cap), ref.snapshot(cap=cap), "snapshot_global")
    assert int(eng.global_nnz(h)) == ref.nnz()
    assert mesh.collectives["all-reduce"] == 1
    tel = eng.telemetry(h)
    assert tel.engine == "mesh" and ref.telemetry().engine == "packed"
    _telemetry_same(tel, ref.telemetry())


def test_session_on_the_mesh_equals_reference_packed_k8():
    """``D4MStream(cfg, mesh=...)``: route, ingest, snapshots, nnz,
    telemetry and the query plane against the reference's K=8 session."""
    cuts, top, batch = (8, 32), 256, 16
    ref = jd4m.D4MStream(jd4m.StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch,
                                           instances_per_device=8, engine="packed"))
    cfg = td4m.StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch, instances_per_device=2)
    sess = td4m.D4MStream(cfg, mesh=_grid((4,), ("data",)))
    assert sess.kind == "mesh" and sess.n_instances == 8 and sess.config.devices == 4
    assert dataclasses.asdict(sess.plan) == dataclasses.asdict(ref.plan) and sess.device == CPU
    r, c, v = stream(1, (6, batch), SPACE)
    for t in range(6):
        br, bc, bv, dropped = sess.route(r[t], c[t], v[t])
        for g, w in zip((br, bc, bv, dropped), ref.route(r[t], c[t], v[t])):
            assert_same(g.gather() if isinstance(g, Sharded) else g, np.asarray(w), "route")
        sess.update(br, bc, bv)
        ref.ingest(r[t], c[t], v[t])
    assert_hier_same(tm.gather_packed(sess.state, "cpu"), ref.state)
    assert_assoc_same(sess.snapshot(), ref.snapshot(), "snapshot")
    assert_assoc_same(sess.snapshot(cap=512, per_instance=True), ref.snapshot(cap=512, per_instance=True))
    assert sess.nnz() == ref.nnz() and sess.overflowed() == ref.overflowed()
    tp, tr = sess.telemetry(), ref.telemetry()
    assert tp.engine == "mesh" and tp["state_bytes"] == tr["state_bytes"]
    _telemetry_same(tp, tr)
    deg = jax.jit(jan.degrees, static_argnames=("cap", "sr"))(ref.snapshot(), cap=ref.plan.snapshot_cap, sr=ref.sr)
    for got, want in zip(sess.query.top_k(10), jan.top_k_vertices(deg[0], 10)):
        assert_same(got, want, "top_k")
    view = sess.view()
    assert view.engine == "mesh" and view.nnz == ref.nnz()
    assert_same(view.get(int(r[0, 0]), int(c[0, 0])), np.asarray(ref.query.get(int(r[0, 0]), int(c[0, 0]))))


def test_d1_equals_the_reference_one_device_mesh():
    cuts, top, batch, k = (16,), 512, 32, 4
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref_eng = jm.MultiStreamEngine(jmesh, cuts, top_capacity=top, batch_size=batch, instances_per_device=k)
    ref_sess = jd4m.D4MStream(jd4m.StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch,
                                                instances_per_device=k), mesh=jmesh)
    mesh = _grid((1,), ("data",))
    eng = _engine(mesh, cuts, top, batch, k)
    sess = td4m.D4MStream(td4m.StreamConfig(cuts=cuts, top_capacity=top, batch_size=batch,
                                            instances_per_device=k), mesh=mesh)
    assert sess.kind == ref_sess.kind == "mesh"
    jh, h = ref_eng.init_state(), eng.init_state()
    r, c, v = stream(2, (5, batch), SPACE)
    for t in range(5):
        jh, jd = ref_eng.ingest(jh, r[t], c[t], v[t])
        h, d = eng.ingest(h, torch.from_numpy(r[t]), torch.from_numpy(c[t]), torch.from_numpy(v[t]))
        assert_same(d, np.asarray(jd))
        assert_same(sess.ingest(r[t], c[t], v[t]), np.asarray(ref_sess.ingest(r[t], c[t], v[t])))
        assert_hier_same(tm.gather_packed(h, "cpu"), jh, f"step {t}")
    assert_hier_same(tm.gather_packed(sess.state, "cpu"), ref_sess.state)
    assert int(eng.global_nnz(h)) == int(ref_eng.global_nnz(jh)) == sess.nnz()
    assert_assoc_same(eng.snapshot_global(h, 1024), ref_eng.snapshot_global(jh, 1024))
    _telemetry_same(eng.telemetry(h), ref_eng.telemetry(jh))


@pytest.mark.parametrize("n_dev,k", [(None, 4), (4, 2), (1, 1)])
def test_update_path_collectives_are_zero(n_dev, k):
    out = bench_scaling.update_path_collectives(n_dev, k_per_device=k, device="cpu")
    assert list(out) == ["all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"]
    assert out == dict.fromkeys(out, 0)


def test_ingest_stream_raises_on_the_mesh_kind():
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = jd4m.D4MStream(jd4m.StreamConfig(cuts=(16,), top_capacity=256, batch_size=16), mesh=jmesh)
    sess = td4m.D4MStream(td4m.StreamConfig(cuts=(16,), top_capacity=256, batch_size=16),
                          mesh=_grid((2,), ("data",)))
    assert ref.kind == sess.kind == "mesh"
    z = np.zeros((2, 2, 16), np.int32)
    with pytest.raises(NotImplementedError, match="update()"):
        sess.ingest_stream(z, z, np.ones((2, 2, 16), np.float32))
    with pytest.raises(NotImplementedError):
        ref.ingest_stream(z[:, :1], z[:, :1], np.ones((2, 1, 16), np.float32))


def test_engine_consumes_a_placed_or_a_whole_stream():
    """``update`` takes :meth:`shard_stream`'s placement or an
    ``[n_instances, B]`` tensor alike; shards of one device keep their own
    buffers."""
    mesh = _grid((4,), ("data",))
    eng = _engine(mesh, (8,), 64, 16, 2)
    r, c, v = stream(5, (8, 16), 20)
    a = eng.update(eng.init_state(), *eng.shard_stream(torch.from_numpy(r), torch.from_numpy(c),
                                                       torch.from_numpy(v)))
    b = eng.update(eng.init_state(), torch.from_numpy(r), torch.from_numpy(c), torch.from_numpy(v))
    assert_hier_same(tm.gather_packed(a, "cpu"), tm.gather_packed(b, "cpu"))
    ptrs = {l.rows.data_ptr() for s in a for l in s.layers}
    assert len(ptrs) == 4 * len(a[0].layers)
