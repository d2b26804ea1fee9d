"""The port's sharding layer on the CPU: ``models/sharding.py``'s plans
spec for spec against the reference's (all ten archs, the four strategies,
the 16 x 16 and 2 x 16 x 16 meshes; the reference on a device-free
``AbstractMesh``), ``launch/mesh.py`` and ``launch/shapes.py`` against the
reference's, and ``core/mesh.py``'s n-d placement (any dimension split over
one axis or several, uneven splits padded as GSPMD pads them) and its
``all_gather`` / ``psum_scatter`` with their counters, against numpy."""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.launch import shapes as JSH
from repro.models import sharding as JSD
from repro.optim import adamw as JA
from repro_torch.configs import get_config as tget
from repro_torch.core import mesh as tmesh
from repro_torch.core.mesh import Mesh, NamedSharding, P
from repro_torch.launch import mesh as TLM
from repro_torch.launch import shapes as TSH
from repro_torch.launch import steps as TST
from repro_torch.models import sharding as TSD
from repro_torch.optim import adamw as TA

from _torch_parity import assert_same

MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jflat(tree):
    """A reference spec tree as {path of dict keys and indices: tuple}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        key = tuple(e.key if isinstance(e, jax.tree_util.DictKey) else e.idx for e in path)
        out[key] = tuple(leaf)
    return out


def _tflat(tree, path=()):
    """The port's spec tree the same way."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tflat(v, path + (k,)))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        for i, v in enumerate(tree):
            out.update(_tflat(v, path + (i,)))
    else:
        assert isinstance(tree, P), (path, tree)
        out[path] = tuple(tree)
    return out


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), TLM.make_production_mesh(multi_pod=name == "multi", device="cpu")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_and_opt_specs_equal_the_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in ARCH_IDS:
        jc, tc = jget(arch), tget(arch)
        jp, tp = JSH.params_struct(jc), TSH.params_struct(tc)
        jo, to = jax.eval_shape(JA.init, jp), TA.init(tp)
        for strategy in TST.STRATEGIES:
            got, want = _tflat(TSD.param_specs(tc, tm, tp, strategy)), _jflat(JSD.param_specs(jc, jm, jp, strategy))
            assert got == want, (arch, strategy, [k for k in want if got.get(k) != want[k]][:4])
            got, want = _tflat(TSD.opt_specs(tc, tm, to, strategy)), _jflat(JSD.opt_specs(jc, jm, jo, strategy))
            assert got == want, (arch, strategy, [k for k in want if got.get(k) != want[k]][:4])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_and_cache_specs_equal_the_reference(mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch in ARCH_IDS:
        jc, tc = jget(arch), tget(arch)
        for strategy in TST.STRATEGIES:
            assert _tflat(TSD.batch_specs(tc, tm, strategy)) == _jflat(JSD.batch_specs(jc, jm, strategy))
            jb, tb = JSD.batch_axes(jc, jm, strategy), TSD.batch_axes(tc, tm, strategy)
            assert jb == tb, (arch, strategy, jb, tb)
        for shape in ("decode_32k", "long_500k"):
            sh = JSH.SHAPES[shape]
            _, jcache = JSH.decode_inputs(jc, sh)
            _, tcache = TSH.decode_inputs(tc, TSH.SHAPES[shape])
            got = _tflat(TSD.cache_specs(tc, tm, tcache, sh.batch))
            assert got == _jflat(JSD.cache_specs(jc, jm, jcache, sh.batch)), (arch, shape)


def test_mesh_axes_fsdp_and_flat_spec():
    for name in MESHES:
        jm, tm = _meshes(name)
        assert TSD.mesh_axes(tm) == TSD.MeshAxes(dp=JSD.mesh_axes(jm).dp, tp=JSD.mesh_axes(jm).tp)
        assert TSD.mesh_axes(tm).dp_spec == JSD.mesh_axes(jm).dp_spec
        ax = TSD.mesh_axes(tm)
        for shape in [(151936, 896), (896,), (7, 5), (48, 4096), (2, 16, 16), ()]:
            want = tuple(JSD._fsdp_flat_spec(shape, jm, JSD.mesh_axes(jm)))
            assert tuple(TSD._fsdp_flat_spec(shape, tm, ax)) == want, (name, shape)
    for arch in ARCH_IDS:
        assert TSD.use_fsdp(tget(arch)) == JSD.use_fsdp(jget(arch)), arch
    assert TSD._pad_spec(P("model"), 3) == P(None, None, "model")
    assert TSD._path_names(("stages", 0, 1, "attn", "wq")) == ("stages", "attn", "wq")
    assert TSD.shardings_of(TLM.make_local_mesh(device="cpu"), {"a": [P("data")]})["a"][0].spec == P("data")


def test_launch_meshes_and_shapes():
    single = TLM.make_production_mesh(device="cpu")
    multi = TLM.make_production_mesh(multi_pod=True, device="cpu")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert single.distinct_devices() == 1
    local = TLM.make_local_mesh(model=2, data=2, device="cpu")
    assert local.axis_names == ("data", "model") and local.shape == {"data": 2, "model": 2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TLM.make_local_mesh()
    assert {k: (v.name, v.kind, v.seq, v.batch) for k, v in TSH.SHAPES.items()} == \
        {k: (v.name, v.kind, v.seq, v.batch) for k, v in JSH.SHAPES.items()}
    assert TSH.GRAD_ACCUM == JSH.GRAD_ACCUM
    for arch in ARCH_IDS:
        jc, tc = jget(arch), tget(arch)
        for name, sh in JSH.SHAPES.items():
            assert TSH.cell_is_runnable(tc, TSH.SHAPES[name]) == JSH.cell_is_runnable(jc, sh)
            for dp in (1, 16, 32, 256, 512):
                assert TSH.grad_accum_steps(tc, TSH.SHAPES[name], dp) == JSH.grad_accum_steps(jc, sh, dp)
        sh = JSH.SHAPES["train_4k"]
        for fn in ("train_inputs", "prefill_inputs"):
            want = getattr(JSH, fn)(jc, sh)
            got = getattr(TSH, fn)(tc, TSH.SHAPES["train_4k"])
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape and got[k].device.type == "meta"
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (arch, fn, k)
        want = [tuple(x.shape) for x in jax.tree.leaves(JSH.params_struct(jc))]
        assert [tuple(x.shape) for x in TA.tree_leaves(TSH.params_struct(tc))] == want


# ---------------------------------------------------------------------------
# n-d placement and the new collectives
# ---------------------------------------------------------------------------

GRID, AXES = (2, 3), ("a", "b")


def _grid():
    devs = np.empty(6, dtype=object)
    devs[:] = [torch.device("cpu")] * 6
    return Mesh(devs.reshape(GRID), AXES)


def _numpy_block(x, spec, idx):
    """Device ``idx``'s block of ``x`` in numpy: each split dimension cut in
    ``ceil(n / k)`` pieces, the last ones zero-padded."""
    out = x
    for d in range(x.ndim):
        axes = spec.dim_axes(d)
        if not axes:
            continue
        ks = [GRID[AXES.index(a)] for a in axes]
        c = int(np.ravel_multi_index([idx[AXES.index(a)] for a in axes], ks))
        k = int(np.prod(ks))
        s = -(-x.shape[d] // k)
        piece = np.take(out, range(min(c * s, x.shape[d]), min((c + 1) * s, x.shape[d])), axis=d)
        pad = [(0, 0)] * x.ndim
        pad[d] = (0, s - piece.shape[d])
        out = np.pad(piece, pad)
    return out


SPECS = [P(), P("a"), P(None, "b"), P("b", "a"), P(("a", "b")), P(None, ("b", "a")), P("a", None, "b"),
         P(None, None, ("a", "b"))]


@pytest.mark.parametrize("shape", [(6, 6, 6), (5, 7, 4), (2, 3, 1)])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_n_d_placement_against_numpy(spec, shape):
    mesh = _grid()
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1
    even = all(shape[d] % int(np.prod([GRID[AXES.index(a)] for a in spec.dim_axes(d)])) == 0
               for d in range(3) if spec.dim_axes(d))
    if not even:
        with pytest.raises(ValueError, match="does not split"):
            tmesh.device_put(torch.from_numpy(x), NamedSharding(mesh, spec))
    placed = tmesh.device_put(torch.from_numpy(x), NamedSharding(mesh, spec), pad=True)
    assert (placed.shape is None) == even
    for i, idx in enumerate(itertools.product(*map(range, GRID))):
        assert_same(placed.shards[i], _numpy_block(x, spec, idx), (spec, idx))
        assert tuple(placed.shards[i].shape) == tmesh.block_shape(mesh, spec, shape)
    assert_same(placed.gather(), torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(placed), x)
    assert sum(mesh.collectives.values()) == 0  # placement is a transfer


@pytest.mark.parametrize("axis,dim", [("a", 0), ("b", 1), (("a", "b"), 0), (("b", "a"), 1)])
def test_all_gather_and_psum_scatter_against_numpy(axis, dim):
    mesh = _grid()
    rng = np.random.default_rng(5)
    n = int(np.prod([GRID[AXES.index(a)] for a in ((axis,) if isinstance(axis, str) else axis)]))
    arr = rng.normal(size=GRID + (2 * n, 3 * n)).astype(np.float32)
    xs = [torch.from_numpy(arr[idx].copy()) for idx in np.ndindex(GRID)]
    names = (axis,) if isinstance(axis, str) else axis

    def group(idx):
        """The devices that share every coordinate but ``axis``, row-major over it."""
        free = [AXES.index(a) for a in names]
        out = []
        for coords in itertools.product(*(range(GRID[p]) for p in free)):
            j = list(idx)
            for p, c in zip(free, coords):
                j[p] = c
            out.append(tuple(j))
        return out

    got = mesh.all_gather(xs, axis, dim)
    for i, idx in enumerate(np.ndindex(GRID)):
        assert_same(got[i], np.concatenate([arr[j] for j in group(idx)], axis=dim), (axis, idx))
    summed = mesh.psum_scatter(xs, axis, dim)
    for i, idx in enumerate(np.ndindex(GRID)):
        g = group(idx)
        acc = arr[g[0]].copy()
        for j in g[1:]:
            acc = acc + arr[j]
        want = np.split(acc, len(g), axis=dim)[g.index(idx)]
        np.testing.assert_array_equal(got_ := summed[i].numpy(), want, err_msg=str((axis, idx)))
        assert got_.base is None or summed[i].untyped_storage().data_ptr() != xs[i].untyped_storage().data_ptr()
    want = dict.fromkeys(tmesh.COLLECTIVES, 0)
    want.update({"all-gather": 1, "reduce-scatter": 1})
    assert mesh.collectives == want
    assert mesh.collective_bytes["all-gather"] == got[0].numel() * 4
    assert mesh.collective_bytes["reduce-scatter"] == summed[0].numel() * 4
    with pytest.raises(ValueError, match="multiple of"):
        mesh.psum_scatter([torch.zeros(n + 1)] * 6, axis, 0)
    mesh.psum(xs, "a")
    assert mesh.collective_bytes["all-reduce"] == xs[0].numel() * 4
    mesh.reset_collectives()
    assert sum(mesh.collective_bytes.values()) == 0 and sum(mesh.collectives.values()) == 0
