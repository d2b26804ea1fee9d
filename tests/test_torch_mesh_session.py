"""The ``mesh`` kind of the port's session around its engine, on the CPU:
engine resolution against the reference, building a mesh from
``devices=D``, checkpoints in both directions (a port mesh restored by
the reference's ``packed`` K*D session, the reference's D=4 mesh
restored by the port's mesh; ``_torch_mesh_ref_main.py``), a served mesh
session, ``runtime.elastic``'s ``rebuild_mesh``/``reshard_state`` and the
``core.streaming`` shims."""
import warnings

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ref_main as mesh_ref
from repro import d4m as jd4m
from repro.core import hierarchical as jh
from repro.core import streaming as jstreaming
from repro.runtime import elastic as jelastic
from repro_torch import d4m as td4m
from repro_torch import serve as tserve
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import hierarchical as th
from repro_torch.core import multistream as tm
from repro_torch.core import streaming as tstreaming
from repro_torch.core.mesh import Mesh, NamedSharding, P, Sharded, local_shards
from repro_torch.d4m import session as tsession
from repro_torch.d4m.config import ENGINE_ENV_VAR
from repro_torch.runtime import elastic

from _torch_parity import PAD, assert_assoc_same, assert_hier_same, assert_same, stream

CPU = torch.device("cpu")


def _mesh(d):
    return Mesh([CPU] * d, ("data",))


def _resolve(cfg, *args):
    try:
        return cfg.resolved_engine(*args)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("env", [None, "mesh", "packed", "pallas"])
@pytest.mark.parametrize("engine", ["auto", "mesh", "packed"])
@pytest.mark.parametrize("d,k", [(1, 1), (1, 4), (2, 1), (4, 2)])
def test_engine_resolution_equals_reference(monkeypatch, env, engine, d, k):
    kw = dict(cuts=(8,), top_capacity=64, batch_size=8, instances_per_device=k, devices=d,
              engine=engine)
    if env is None:
        monkeypatch.delenv(ENGINE_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(ENGINE_ENV_VAR, env)
    ref = _resolve(jd4m.StreamConfig(**kw))
    want = {"pallas": "cuda"}.get(ref, ref)
    assert _resolve(td4m.StreamConfig(**kw), "cpu") == want
    if d > 1 and engine == "auto":
        assert want == "mesh"


def test_devices_beyond_the_mesh_raise_and_none_means_every_card(monkeypatch):
    cfg = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, devices=4)
    with pytest.raises(ValueError, match=r"Mesh\(\[torch.device\('cpu'\)\] \* 4"):
        td4m.D4MStream(cfg, device="cpu")
    with pytest.raises(ValueError, match="4 devices"):
        jd4m.D4MStream(jd4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, devices=4))
    # on the card: devices=None means every card; D beyond them raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    auto = td4m.D4MStream(td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, devices=None))
    assert auto.kind == "mesh" and auto.mesh.device_list == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert auto.config.devices == 2 and auto.n_instances == 2
    with pytest.raises(ValueError, match="only 2 cuda"):
        td4m.D4MStream(cfg)
    one = td4m.D4MStream(td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, devices=None),
                         device="cpu")
    assert one.kind == "single" and one.config.devices == 1
    with pytest.raises(ValueError, match="first device"):
        td4m.D4MStream(cfg, mesh=_mesh(4), device="cuda")


# -- checkpoints both ways ------------------------------------------------------

CUTS, TOP, BATCH, K, D = (8, 32), 256, 16, 2, 4


def _port_mesh(**kw):
    cfg = td4m.StreamConfig(cuts=CUTS, top_capacity=TOP, batch_size=BATCH, instances_per_device=K)
    return td4m.D4MStream(cfg, mesh=_mesh(D), **kw)


def _feed(sessions, seed, steps):
    r, c, v = stream(seed, (steps, BATCH), 64)
    for t in range(steps):
        drops = {int(s.ingest(r[t], c[t], v[t])) for s in sessions}
        assert drops == {0}


def test_port_mesh_checkpoint_restores_in_the_reference_packed_session(tmp_path):
    port = _port_mesh(checkpoint_dir=str(tmp_path))
    _feed([port], 0, 5)
    port.checkpoint(5, extra={"cursor": 5 * BATCH})
    port.wait_checkpoint()
    ref = jd4m.D4MStream(jd4m.StreamConfig(cuts=CUTS, top_capacity=TOP, batch_size=BATCH,
                                           instances_per_device=K * D, engine="packed"),
                         checkpoint_dir=str(tmp_path))
    extra = ref.restore()
    assert extra["cursor"] == 5 * BATCH and extra["step"] == 5
    assert_hier_same(tm.gather_packed(port.state, "cpu"), ref.state, "restored")
    _feed([port, ref], 1, 3)  # both go on alike from the restored state
    assert_hier_same(tm.gather_packed(port.state, "cpu"), ref.state, "after")
    assert_assoc_same(port.snapshot(), ref.snapshot(), "snapshot")


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    return mesh_ref.reference(tmp_path_factory)


def test_reference_mesh_checkpoint_restores_in_the_port_mesh(ref_dir):
    """The reference's D=4 mesh session (four forced host devices, K=2)
    checkpointed; the port's D=4 x K=2 mesh restores it, each shard's
    slice into buffers of its own, equal to the reference's state and to
    the port's own ingest of the same stream."""
    want = np.load(ref_dir / "ref.npz")
    cfg = td4m.StreamConfig(**mesh_ref.SESSION)
    port = td4m.D4MStream(cfg, mesh=_mesh(mesh_ref.D), checkpoint_dir=str(ref_dir / "ckpt"))
    extra = port.restore()
    assert extra["cursor"] == mesh_ref.SESSION_STEPS * mesh_ref.SESSION["batch_size"]
    got = tm.gather_packed(port.state, "cpu")
    for i, l in enumerate(got.layers):
        for f in ("rows", "cols", "vals", "nnz", "overflow"):
            assert_same(getattr(l, f), want[f"session.state.layers{i}.{f}"], f"layer{i}.{f}")
    assert_same(got.cascades, want["session.state.cascades"])
    ptrs = [l.rows.untyped_storage().data_ptr() for s in port.state for l in s.layers]
    assert len(set(ptrs)) == len(ptrs)
    # the port's own mesh, fed the same stream, holds the same state
    own = td4m.D4MStream(cfg, mesh=_mesh(mesh_ref.D))
    r, c, v = mesh_ref.session_stream()
    for t in range(mesh_ref.SESSION_STEPS):
        assert_same(own.ingest(r[t], c[t], v[t]), want[f"session.dropped{t}"])
    assert_hier_same(tm.gather_packed(own.state, "cpu"), got)
    snap = port.snapshot(cap=mesh_ref.SESSION_CAP)
    for f in ("rows", "cols", "vals", "nnz", "overflow"):
        assert_same(getattr(snap, f), want[f"session.snapshot.{f}"], f"snapshot.{f}")
    assert port.nnz() == int(want["session.nnz"])


def test_mesh_restores_a_cuda_engine_checkpoint(tmp_path):
    """The ``cuda`` engine writes power-of-two widths; a mesh of the same
    K*D instances cuts them to its own capacities on the host."""
    cfg = td4m.StreamConfig(cuts=CUTS, top_capacity=TOP, batch_size=BATCH, instances_per_device=K * D,
                            engine="cuda")
    src = td4m.D4MStream(cfg, device="cpu", checkpoint_dir=str(tmp_path))
    _feed([src], 3, 4)
    src.checkpoint(4)
    src.wait_checkpoint()
    port = _port_mesh(checkpoint_dir=str(tmp_path))
    port.restore()
    assert_hier_same(tm.gather_packed(port.state, "cpu"), src.state)
    assert [l.capacity for l in port.state[0].layers] == list(port.plan.layer_caps)


def test_manager_restore_places_by_shardings(tmp_path):
    port = _port_mesh(checkpoint_dir=str(tmp_path))
    _feed([port], 4, 2)
    port.checkpoint(2)
    port.wait_checkpoint()
    like = port.state[0]
    mesh = _mesh(D)
    placed, extra = CheckpointManager(str(tmp_path)).restore(
        like, shardings=NamedSharding(mesh, P("data")))
    assert extra["step"] == 2 and isinstance(placed.layers[0].rows, Sharded)
    shards = port.engine.primaries(port.state)
    for i in range(D):
        assert_same(placed.layers[0].rows.shards[i], shards[i].layers[0].rows)
        assert_same(placed.cascades.shards[i], shards[i].cascades)


# -- serving ------------------------------------------------------------------------

def test_served_mesh_drains_to_the_library_mode_state():
    """``D4MStream.serve`` on a D=4 x K=2 mesh: the routed ``[K*D, B]``
    microbatches are split by ``shard_stream``; the drained state equals
    library-mode ingest of the same microbatches."""
    n = 9 * BATCH - 5  # a ragged tail: the drain flushes a PAD-padded batch
    r, c, v = stream(6, (n,), 64)
    served = _port_mesh()
    report = served.serve(tserve.ArraySource(r, c, v, chunk_records=BATCH), max_latency_ms=1e9)
    assert report.drained and report.records_fed == n and report.records_dropped == 0
    assert report.telemetry.engine == "mesh" and report.telemetry.n_instances == K * D
    lib = _port_mesh()
    for lo in range(0, n, BATCH):
        br, bc = np.full(BATCH, PAD, np.int32), np.full(BATCH, PAD, np.int32)
        bv = np.zeros(BATCH, np.float32)
        m = min(BATCH, n - lo)
        br[:m], bc[:m], bv[:m] = r[lo:lo + m], c[lo:lo + m], v[lo:lo + m]
        assert int(lib.ingest(br, bc, bv)) == 0
    assert_hier_same(tm.gather_packed(served.state, "cpu"), tm.gather_packed(lib.state, "cpu"))
    assert_assoc_same(served.snapshot(), lib.snapshot(), "snapshot")


# -- runtime.elastic --------------------------------------------------------------

def test_rebuild_mesh_and_reshard_live_state():
    """``tests/test_runtime.py``'s case on both packages, then a split
    over a rebuilt 4 x 1 mesh."""
    jmesh = jelastic.rebuild_mesh(jax.devices(), jelastic.ElasticConfig(model_axis=1))
    mesh = elastic.rebuild_mesh([CPU], elastic.ElasticConfig(model_axis=1))
    assert mesh.shape == dict(jmesh.shape) and mesh.axis_names == jmesh.axis_names == ("data", "model")
    state = {"w": torch.arange(16.0).reshape(4, 4)}
    out = elastic.reshard_state(state, mesh, lambda m, s: {"w": P()})
    jout = jelastic.reshard_state({"w": jax.numpy.arange(16.0).reshape(4, 4)}, jmesh,
                                  lambda m, s: {"w": jax.sharding.PartitionSpec()})
    np.testing.assert_allclose(np.asarray(out["w"]), np.asarray(jout["w"]))
    four = elastic.rebuild_mesh([CPU] * 5, elastic.ElasticConfig(model_axis=1))
    assert four.shape == {"data": 5, "model": 1}
    four = elastic.rebuild_mesh([CPU] * 4, elastic.ElasticConfig(model_axis=1))
    split = elastic.reshard_state(state, four, lambda m, s: {"w": P("data")})
    assert [s.tolist() for s in split["w"].shards] == state["w"].unsqueeze(1).tolist()
    assert split["w"].shards[0].untyped_storage().data_ptr() != state["w"].untyped_storage().data_ptr()
    with pytest.raises(RuntimeError, match="cannot sustain"):
        elastic.rebuild_mesh([CPU] * 3, elastic.ElasticConfig(model_axis=4))


def test_reshard_a_mesh_state_onto_fewer_shards():
    """A live D=4 x K=2 state re-placed on a D=2 mesh (K=4 a shard) steps
    on as the D=4 one does."""
    port = _port_mesh()
    _feed([port], 7, 3)
    whole = tm.gather_packed(port.state, "cpu")
    two = elastic.rebuild_mesh([CPU] * 2, elastic.ElasticConfig(model_axis=1))
    placed = elastic.reshard_state(whole, two, lambda m, s: P(("data", "model")))
    cfg = td4m.StreamConfig(cuts=CUTS, top_capacity=TOP, batch_size=BATCH, instances_per_device=4)
    small = td4m.D4MStream(cfg, mesh=two)
    small.state = local_shards(placed, two.size)
    _feed([port, small], 8, 3)
    assert_hier_same(tm.gather_packed(small.state, "cpu"), tm.gather_packed(port.state, "cpu"))


# -- the core.streaming shims -----------------------------------------------------

def test_streaming_shims_warn_and_equal_the_session():
    cuts, steps, batch = (16,), 6, 32
    r, c, v = stream(9, (steps, batch), 64)
    R, C, V = (torch.from_numpy(x) for x in (r, c, v))
    with pytest.warns(DeprecationWarning, match="build_update_step"):
        step = tstreaming.make_update_fn(cuts, donate=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jstep = jstreaming.make_update_fn(cuts, donate=False)
    h = th.init(cuts, 1024, batch, device="cpu")
    jstate = jh.init(cuts, top_capacity=1024, batch_size=batch)
    for t in range(steps):
        h = step(h, R[t], C[t], V[t])
        jstate = jstep(jstate, r[t], c[t], v[t])
    assert_hier_same(h, jstate, "make_update_fn")
    with pytest.warns(DeprecationWarning, match="scan_ingest"):
        h2, trace = tstreaming.ingest_stream(th.init(cuts, 1024, batch, device="cpu"), R, C, V, cuts)
    h3, trace3 = tsession.scan_ingest(th.init(cuts, 1024, batch, device="cpu"), R, C, V, cuts)
    assert_hier_same(h2, h3)
    assert_same(trace, trace3)
    assert_hier_same(h2, h)
    with pytest.warns(DeprecationWarning, match="scan_ingest_and_snapshot"):
        _, snap, _ = tstreaming.ingest_and_snapshot(
            th.init(cuts, 1024, batch, device="cpu"), R, C, V, cuts, 1024)
    assert_assoc_same(snap, th.snapshot(h, cap=1024), "snapshot")
