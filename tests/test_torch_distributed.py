"""``repro_torch.core.distributed`` against ``repro.core.distributed`` on
the CPU: ownership and bucketing on the same inputs, ``ShardedAssoc`` at
D=1 in this process and at D=4 against the reference on a forced 4-device
mesh (one subprocess, ``_torch_mesh_ref_main.py``), bit for bit: state,
``dropped`` and ``get``; and the ``ParallelHierStream`` shim."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ref_main as mesh_ref
from repro.core import distributed as jdist
from repro_torch import d4m as td4m
from repro_torch.core import distributed as tdist
from repro_torch.core import multistream as tms
from repro_torch.core.mesh import Mesh

from _torch_parity import PAD, assert_same


def _cpu_mesh(d):
    return Mesh([torch.device("cpu")] * d, ("data",))


def _stacked(hs):
    """Per-shard hierarchies stacked on a leading ``[D]`` axis (the
    reference's ``P(axis)``-sharded state read back whole)."""
    return tms.gather_packed([tms.HierAssoc(
        layers=tuple(tms.Assoc(l.rows[None], l.cols[None], l.vals[None], l.nnz[None], l.overflow[None])
                     for l in h.layers),
        cascades=h.cascades[None]) for h in hs], "cpu")


def _same_state(got, want, what):
    for i, (g, w) in enumerate(zip(got.layers, want.layers)):
        for f in ("rows", "cols", "vals", "nnz", "overflow"):
            assert_same(getattr(g, f), np.asarray(getattr(w, f)), f"{what}.layers{i}.{f}")
    assert_same(got.cascades, np.asarray(want.cascades), f"{what}.cascades")


@pytest.mark.parametrize("n_shards,key_space", [(8, 256), (4, 64), (3, 100), (5, 3)])
def test_owner_of_equals_reference(n_shards, key_space):
    rows = np.array([0, 1, 31, 32, 63, 64, 99, 255, 1000, PAD], np.int32)
    got = tdist.owner_of(torch.from_numpy(rows), n_shards, key_space)
    want = jdist.owner_of(jnp.asarray(rows), n_shards, key_space)
    assert_same(got, np.asarray(want))


def _bucket_case(seed, n, space, pads):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, space, n).astype(np.int32)
    cols = rng.integers(0, 16, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    rows[rng.random(n) < pads] = PAD
    return rows, cols, vals


@pytest.mark.parametrize("fn", ["bucket_by_owner", "bucket_by_owner_sorted"])
@pytest.mark.parametrize("case", [
    dict(seed=0, n=64, space=256, pads=0.0, n_shards=8, slot_cap=64),  # no drop
    dict(seed=1, n=48, space=64, pads=0.2, n_shards=4, slot_cap=6),  # overflow counted
    dict(seed=2, n=16, space=8, pads=0.5, n_shards=4, slot_cap=2),  # one hot owner
], ids=["roomy", "overflow", "hot"])
def test_bucketing_equals_reference(fn, case):
    rows, cols, vals = _bucket_case(case["seed"], case["n"], case["space"], case["pads"])
    args = (case["n_shards"], case["space"], case["slot_cap"])
    got = getattr(tdist, fn)(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), *args)
    want = getattr(jdist, fn)(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), *args)
    for g, w, what in zip(got, want, ("rows", "cols", "vals", "dropped")):
        assert_same(g, np.asarray(w), what)
    if case["seed"]:
        assert int(got[3]) > 0


def test_sharded_assoc_single_device_equals_reference():
    """The reference test's case at D=1, the state, ``dropped``, ``get``
    and the update's collectives: 3 ``all-to-all`` and 1 ``all-reduce``."""
    kw = dict(cuts=(8,), top_capacity=256, batch_size=16, key_space=64)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    ref = jdist.ShardedAssoc(jmesh, "data", **kw)
    mesh = _cpu_mesh(1)
    port = tdist.ShardedAssoc(mesh, "data", **kw)
    jh, th = ref.init_state(), port.init_state()
    r = np.asarray([[5, 5, 9, 63] + [0] * 12], np.int32)
    c = np.asarray([[1, 1, 2, 3] + [0] * 12], np.int32)
    v = np.ones((1, 16), np.float32)
    for step in range(3):
        mesh.reset_collectives()
        th, tdrop = port.update(th, torch.from_numpy(r), torch.from_numpy(c), torch.from_numpy(v))
        assert mesh.collectives == {"all-gather": 0, "all-reduce": 1, "reduce-scatter": 0,
                                    "all-to-all": 3, "collective-permute": 0}
        jh, jdrop = ref.update(jh, jnp.asarray(r), jnp.asarray(c), jnp.asarray(v))
        assert_same(tdrop, np.asarray(jdrop), "dropped")
        _same_state(_stacked(th), jh, f"step{step}")
        r = (r + 7) % 64
    for q in [(5, 1), (63, 3), (12, 2), (0, 0)]:
        got = port.get(th, *q)
        assert_same(got, np.asarray(ref.get(jh, jnp.asarray(q[0], jnp.int32), jnp.asarray(q[1], jnp.int32))))
    assert float(port.get(th, 5, 1)) == 2.0


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return np.load(mesh_ref.reference(tmp_path_factory) / "ref.npz")


@pytest.mark.parametrize("case", sorted(mesh_ref.SHARDED_CASES))
def test_sharded_assoc_d4_equals_reference(ref, case):
    """D=4 shards on a repeated CPU device against the reference on four
    forced host devices, after every step; each update counts 3
    ``all-to-all`` and 1 ``all-reduce``."""
    mesh = _cpu_mesh(mesh_ref.D)
    sa = tdist.ShardedAssoc(mesh, "data", **mesh_ref.SHARDED_CASES[case])
    h = sa.init_state()
    rows, cols, vals, qr, qc = mesh_ref.sharded_inputs(case)
    for t in range(mesh_ref.SHARDED_STEPS):
        mesh.reset_collectives()
        h, dropped = sa.update(h, torch.from_numpy(rows[t]), torch.from_numpy(cols[t]),
                               torch.from_numpy(vals[t]))
        assert mesh.collectives["all-to-all"] == 3 and mesh.collectives["all-reduce"] == 1
        assert_same(dropped, ref[f"{case}.dropped{t}"], f"dropped{t}")
        got = _stacked(h)
        for i, l in enumerate(got.layers):
            for f in ("rows", "cols", "vals", "nnz", "overflow"):
                assert_same(getattr(l, f), ref[f"{case}.step{t}.layers{i}.{f}"], f"step{t}.{i}.{f}")
        assert_same(got.cascades, ref[f"{case}.step{t}.cascades"])
    assert_same(sa.get(h, torch.from_numpy(qr), torch.from_numpy(qc)), ref[f"{case}.get"], "get")
    assert (case == "tight") == (int(ref[f"{case}.dropped0"]) > 0)


def test_sharded_assoc_over_a_second_axis():
    """On a ``("data", "model")`` mesh the state is replicated over
    ``model`` and ``dropped`` is ``pmax``-ed over it, as in the reference;
    the answers equal the one-axis mesh's."""
    cfg = mesh_ref.SHARDED_CASES["tight"]
    rows, cols, vals, qr, qc = mesh_ref.sharded_inputs("tight")
    flat = tdist.ShardedAssoc(_cpu_mesh(4), "data", **cfg)
    grid = Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(4, 2), ("data", "model"))
    two = tdist.ShardedAssoc(grid, "data", **cfg)
    hf, h2 = flat.init_state(), two.init_state()
    for t in range(2):
        grid.reset_collectives()
        hf, df = flat.update(hf, torch.from_numpy(rows[t]), torch.from_numpy(cols[t]), torch.from_numpy(vals[t]))
        h2, d2 = two.update(h2, torch.from_numpy(rows[t]), torch.from_numpy(cols[t]), torch.from_numpy(vals[t]))
        assert grid.collectives["all-to-all"] == 3 and grid.collectives["all-reduce"] == 2
        assert_same(d2, df)
    assert_same(two.get(h2, torch.from_numpy(qr), torch.from_numpy(qc)),
                flat.get(hf, torch.from_numpy(qr), torch.from_numpy(qc)))
    for replica in range(2):
        _same_state_t(_stacked(h2[replica::2]), _stacked(hf))


def _same_state_t(got, want):
    for g, w in zip(got.layers, want.layers):
        for f in ("rows", "cols", "vals", "nnz", "overflow"):
            assert_same(getattr(g, f), getattr(w, f), f)
    assert_same(got.cascades, want.cascades)


def test_parallel_hier_stream_warns_and_equals_the_session():
    mesh = _cpu_mesh(2)
    with pytest.warns(DeprecationWarning, match="ParallelHierStream"):
        ps = tdist.ParallelHierStream(mesh, (8,), top_capacity=512, batch_size=16)
    assert ps.session.kind == "mesh" and ps.n_instances == 2 and ps.engine is ps.session.engine
    sess = td4m.D4MStream(td4m.StreamConfig(cuts=(8,), top_capacity=512, batch_size=16), mesh=mesh)
    h = ps.init_state()
    rng = np.random.default_rng(3)
    for _ in range(4):
        r = torch.from_numpy(rng.integers(0, 40, 16).astype(np.int32))
        c = torch.from_numpy(rng.integers(0, 40, 16).astype(np.int32))
        h, dropped = ps.ingest(h, r, c, torch.ones(16))
        assert int(sess.ingest(r, c, torch.ones(16))) == int(dropped) == 0
    assert int(ps.global_nnz(h)) == sess.nnz()
    _same_state_t(tms.gather_packed(h, "cpu"), tms.gather_packed(sess.state, "cpu"))
    # the reference's single-device case through the placed-stream surface
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        one = tdist.ParallelHierStream(_cpu_mesh(1), (8,), top_capacity=512, batch_size=16)
        jone = jdist.ParallelHierStream(jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",)),
                                        (8,), top_capacity=512, batch_size=16)
    r = np.arange(16, dtype=np.int32)[None]
    c = np.zeros((1, 16), np.int32)
    v = np.ones((1, 16), np.float32)
    h1 = one.update(one.init_state(), *one.shard_stream(torch.from_numpy(r), torch.from_numpy(c),
                                                        torch.from_numpy(v)))
    jh1 = jone.update(jone.init_state(), *jone.shard_stream(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v)))
    assert int(one.global_nnz(h1)) == int(jone.global_nnz(jh1)) == 16
    _same_state(tms.gather_packed(h1, "cpu"), jh1, "one device")


def test_parallel_hier_stream_on_a_sub_axis_mesh():
    """Named axes that are not the mesh's own take the direct engine, as
    in the reference; each replica over the other axis steps alike."""
    grid = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("data", "model"))
    with pytest.warns(DeprecationWarning):
        ps = tdist.ParallelHierStream(grid, (8,), top_capacity=256, batch_size=16,
                                      axis_names=("data",), instances_per_device=2)
    assert not hasattr(ps, "session") and ps.n_instances == 4 and ps.axes == ("data",)
    h = ps.init_state()
    rng = np.random.default_rng(4)
    for _ in range(3):
        r = torch.from_numpy(rng.integers(0, 40, 16).astype(np.int32))
        c = torch.from_numpy(rng.integers(0, 40, 16).astype(np.int32))
        h, dropped = ps.ingest(h, r, c, torch.ones(16))
        assert int(dropped) == 0
    assert len(h) == 4 and ps.engine.primary == [0, 2]
    _same_state_t(_pair(h[0], h[2]), _pair(h[1], h[3]))
    assert int(ps.global_nnz(h)) == int(ps.engine.nnz_per_instance(h).sum())


def _pair(a, b):
    return tms.gather_packed([a, b], "cpu")
