"""The port's associative-array core against the JAX reference, on the CPU.

Same numpy inputs through ``repro.core`` and ``repro_torch.core``; every
result is compared bit-exactly, float values by bit pattern.  That includes
``from_triples`` on random float32 values with long duplicate runs, where
the fold order of ``lax.associative_scan`` decides the result bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytics as ja
from repro.core import assoc as jas
from repro.core import hierarchical as jh
from repro.core import multistream as jm
from repro.core import semiring as js
from repro_torch.core import analytics as ta
from repro_torch.core import assoc as tas
from repro_torch.core import convert
from repro_torch.core import hierarchical as th
from repro_torch.core import multistream as tm
from repro_torch.core import semiring as ts

from _torch_parity import assert_assoc_same, assert_hier_same, assert_same, stream

torch.set_num_threads(1)

SEMIRINGS = ["plus.times", "max.plus", "min.plus", "union.first"]


_jax_from_triples = jax.jit(jas.from_triples, static_argnames=("cap", "sr"))


def _both(r, c, v, cap, srn, valid=None):
    j = _jax_from_triples(
        jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), cap=cap, sr=js.get(srn),
        valid=None if valid is None else jnp.asarray(valid),
    )
    t = tas.from_triples(
        torch.tensor(r), torch.tensor(c), torch.tensor(v), cap=cap, sr=ts.get(srn),
        valid=None if valid is None else torch.tensor(valid),
    )
    return j, t


def test_semiring_registry_matches():
    assert sorted(ts.REGISTRY) == sorted(js.REGISTRY)
    for name, s in ts.REGISTRY.items():
        ref = js.REGISTRY[name]
        assert np.float32(s.zero).tobytes() == np.float32(ref.zero).tobytes()
        assert np.float32(s.one).tobytes() == np.float32(ref.one).tobytes()
    folds = {n: s.fold for n, s in ts.REGISTRY.items()}
    assert folds["plus.times"] == folds["count"] == ts.FOLD_PLUS
    assert folds["union.first"] == ts.FOLD_FIRST
    assert {folds[n] for n in folds if n.startswith("max.")} == {ts.FOLD_MAX}
    assert {folds[n] for n in folds if n.startswith("min.")} == {ts.FOLD_MIN}


@pytest.mark.parametrize("srn", SEMIRINGS)
@pytest.mark.parametrize("n", [1, 2, 7, 64, 333])
def test_from_triples_bit_identical(n, srn):
    """Many duplicates per key (keys from a 6x3 space) on random floats."""
    r, c, v = stream(n, (n,), 6)
    c = c % 3
    for cap in (max(1, n // 4), n):
        j, t = _both(r, c, v, cap, srn)
        assert_assoc_same(t, j, f"n={n} cap={cap}")


def test_from_triples_valid_mask_and_negative_zero():
    r, c, v = stream(11, (40,), 5)
    v[::3] = -0.0
    valid = np.arange(40) % 4 != 1
    j, t = _both(r, c, v, 40, "plus.times", valid)
    assert_assoc_same(t, j)
    j1, t1 = _both(r[:1], c[:1], np.float32([-0.0]), 1, "plus.times")
    assert_assoc_same(t1, j1, "single element keeps -0.0")


def _pair(seed, n, space, srn, cap=None):
    r, c, v = stream(seed, (n,), space)
    return _both(r, c, v, cap or n, srn)


@pytest.mark.parametrize("srn", SEMIRINGS)
def test_add_bit_identical(srn):
    ja1, ta1 = _pair(20, 40, 9, srn)
    ja2, ta2 = _pair(21, 24, 9, srn)
    for cap in (10, 64):
        want = jax.jit(jas.add, static_argnames=("cap", "sr"))(ja1, ja2, cap=cap, sr=js.get(srn))
        got = tas.add(ta1, ta2, cap=cap, sr=ts.get(srn))
        assert_assoc_same(got, want, f"cap={cap}")


def test_transpose_reduce_get_extract_row():
    srn = "plus.times"
    j, t = _pair(30, 80, 12, srn)
    assert_assoc_same(tas.transpose(t), jax.jit(jas.transpose)(j), "transpose")
    assert_assoc_same(tas.reduce_rows(t, 16), jax.jit(jas.reduce_rows, static_argnums=1)(j, 16), "reduce_rows")
    assert_assoc_same(tas.reduce_cols(t, 16), jax.jit(jas.reduce_cols, static_argnums=1)(j, 16), "reduce_cols")
    qr = np.array([0, 3, 5, 11, 40], np.int32)
    qc = np.array([1, 3, 7, 2, 0], np.int32)
    assert_same(tas.get(t, torch.tensor(qr), torch.tensor(qc)), jas.get(j, qr, qc), "get")
    assert_same(tas.get(t, 3, 3), jas.get(j, 3, 3), "get scalar")
    for row in (0, 5, 99):
        want = jax.jit(jas.extract_row, static_argnums=2)(j, row, 16)
        assert_assoc_same(tas.extract_row(t, row, 16), want, f"row {row}")
    assert bool(tas.is_sorted_unique(t)) and bool(jas.is_sorted_unique(j))


def test_topk_ties_keep_lower_index_first():
    """Tied degrees: ``lax.top_k`` puts the lower index first; so must the
    port (``torch.topk`` promises no order)."""
    r = np.array([1, 1, 2, 3, 3, 4, 5, 6, 6, 7], np.int32)
    c = np.arange(10, dtype=np.int32)
    v = np.ones(10, np.float32)
    j, t = _both(r, c, v, 16, "plus.times")
    jo, ji = ja.degrees(j, cap=16)
    to, ti = ta.degrees(t, cap=16)
    for k in (1, 3, 6, 16):
        for got, want in zip(ta.top_k_vertices(to, k), ja.top_k_vertices(jo, k)):
            assert_same(got, want, f"out k={k}")
        for got, want in zip(ta.top_k_vertices(ti, k), ja.top_k_vertices(ji, k)):
            assert_same(got, want, f"in k={k}")


def test_key_hash32_on_int32_edges():
    edges = np.array(
        [0, 1, -1, 2, -2, 2**31 - 1, -(2**31), 2**31 - 2, -(2**31) + 1, 0x12345678, -0x12345678],
        np.int32,
    )
    rr, cc = np.meshgrid(edges, edges)
    rr, cc = rr.ravel(), cc.ravel()
    want = np.asarray(jm.key_hash32(jnp.asarray(rr), jnp.asarray(cc))).astype(np.int64)
    got = tm.key_hash32(torch.tensor(rr), torch.tensor(cc)).numpy()
    np.testing.assert_array_equal(got, want)
    for k in (1, 3, 8):
        assert_same(
            tm.instance_of(torch.tensor(rr), torch.tensor(cc), k),
            jm.instance_of(jnp.asarray(rr), jnp.asarray(cc), k),
        )


@pytest.mark.parametrize("k,slot_cap", [(1, 64), (8, 64), (8, 4)])
def test_route_to_instances_bit_identical(k, slot_cap):
    r, c, v = stream(40, (64,), 1000)
    r[::7] = 2**31 - 1  # dead slots
    c[::7] = 2**31 - 1
    want = jm.route_to_instances(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), k, slot_cap)
    got = tm.route_to_instances(torch.tensor(r), torch.tensor(c), torch.tensor(v), k, slot_cap)
    for g, w, what in zip(got[:3], want[:3], ("rows", "cols", "vals")):
        assert_same(g, w, what)
    assert int(got[3]) == int(want[3])
    if slot_cap == 4:
        assert int(got[3]) > 0


def test_hierarchy_snapshot_and_state_round_trip():
    """A JAX hierarchy carried into the port snapshots identically, and
    ``hier_to_numpy`` gives the same leaves back."""
    cuts = (8, 32)
    r, c, v = stream(50, (5, 16), 48)
    h = jh.init(cuts, top_capacity=256, batch_size=16)
    step = jax.jit(lambda hh, a, b, x: jh.update_triples(hh, a, b, x, cuts))
    for t in range(5):
        h = step(h, r[t], c[t], v[t])
    leaves = [tuple(np.asarray(x) for x in (l.rows, l.cols, l.vals, l.nnz, l.overflow)) for l in h.layers]
    port = convert.hier_from_numpy(leaves, np.asarray(h.cascades), device="cpu")
    assert_hier_same(port, h)
    want = jax.jit(lambda hh: jh.snapshot(hh, 512))(h)
    assert_assoc_same(th.snapshot(port, 512), want, "snapshot")
    back, casc = convert.hier_to_numpy(port)
    for got, want in zip(back, leaves):
        for g, w in zip(got, want):
            assert_same(g, w)
    assert_same(casc, np.asarray(h.cascades))
    assert th.memory_bytes(port) == jh.memory_bytes(h)


def test_pad_layers_pow2_matches_reference():
    """Padding to power-of-two widths: the same leaves as the reference's
    ``pad_layers_pow2``, and ``init(pad_pow2=True)`` gives that layout."""
    cuts = (10,)
    r, c, v = stream(60, (6,), 8)
    h = jh.update_triples(jh.init(cuts, top_capacity=100, batch_size=6), r, c, v, cuts)
    leaves = [tuple(np.asarray(x) for x in (l.rows, l.cols, l.vals, l.nnz, l.overflow)) for l in h.layers]
    port = th.pad_layers_pow2(convert.hier_from_numpy(leaves, np.asarray(h.cascades), device="cpu"))
    assert_hier_same(port, jh.pad_layers_pow2(h))
    empty = th.init(cuts, 100, 6, pad_pow2=True, device="cpu")
    assert [l.capacity for l in empty.layers] == [l.capacity for l in port.layers]
