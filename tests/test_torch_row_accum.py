"""The port's row accumulator (``repro_torch.sparse.row_accum``) against the
JAX reference ``repro.sparse.row_accum``, on the CPU, bit for bit: ids,
row bits (NaN and ``-0.0`` included), nnz, overflow and cascade counters.
``to_dense`` runs ``scatter_add``'s plain version here (CPU tensors).

Also the converters of ``repro_torch.sparse.convert`` that carry a
``RowAccum``/``HierRowAccum`` between the two packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import row_accum as jra
from repro_torch.sparse import convert
from repro_torch.sparse import row_accum as tra

from _torch_parity import assert_same

torch.set_num_threads(1)

V, D, T = 40, 5, 12  # vocabulary, row width, pairs per microbatch
CUTS = (16, 48)
TOP = 64

_j_from_pairs = jax.jit(jra.from_pairs, static_argnames=("cap",))
_j_merge = jax.jit(jra.merge, static_argnames=("cap",))
_j_to_dense = jax.jit(jra.to_dense, static_argnames=("v",))
_j_update = jax.jit(jra.hier_update, static_argnames=("cuts",))
_j_flush = jax.jit(jra.hier_flush)


def _rows(rng, n, special=True):
    """float32 rows of which about a quarter each are NaN and -0.0."""
    r = rng.normal(size=(n, D)).astype(np.float32)
    if special:
        pick = rng.integers(0, 8, (n, D))
        r[pick == 0] = np.nan
        r[(pick == 1) | (pick == 2)] = -0.0
    return r


def _pairs(seed, n=T, space=V, special=True):
    rng = np.random.default_rng(seed)
    return rng.integers(0, space, n).astype(np.int32), _rows(rng, n, special)


def assert_acc_same(got, want, what=""):
    for f in ("ids", "rows", "nnz", "overflow"):
        assert_same(getattr(got, f), getattr(want, f), f"{what}.{f}")


def assert_hier_rows_same(got, want, what=""):
    assert len(got.layers) == len(want.layers)
    for i, (g, w) in enumerate(zip(got.layers, want.layers)):
        assert_acc_same(g, w, f"{what}.layer{i}")
    assert_same(got.cascades, want.cascades, f"{what}.cascades")


def _both_from_pairs(ids, rows, cap):
    return (
        tra.from_pairs(torch.tensor(ids), torch.tensor(rows), cap),
        _j_from_pairs(jnp.asarray(ids), jnp.asarray(rows), cap=cap),
    )


@pytest.mark.parametrize("n,cap", [(1, 4), (2, 4), (T, 2 * T), (33, 40), (33, 6)])
def test_from_pairs_matches_reference(n, cap):
    """Duplicates fold in input order; a singleton -0.0 row comes out +0.0
    (the scan's interleave) unless the input has one pair; a cap below the
    distinct count overflows."""
    ids, rows = _pairs(n, n, space=12)
    got, want = _both_from_pairs(ids, rows, cap)
    assert_acc_same(got, want)
    if cap == 6:
        assert bool(got.overflow)


@pytest.mark.parametrize("cap", [None, 30, 9])
def test_merge_matches_reference(cap):
    a_t, a_j = _both_from_pairs(*_pairs(1, 20, space=16), 20)
    b_t, b_j = _both_from_pairs(*_pairs(2, 14, space=16), 14)
    a_t.overflow, a_j.overflow = torch.tensor(True), jnp.asarray(True)
    got = tra.merge(a_t, b_t, cap)
    want = _j_merge(a_j, b_j, cap=cap)
    assert_acc_same(got, want, f"cap={cap}")
    assert bool(got.overflow)


def test_to_dense_matches_reference():
    """Ids outside [0, v) and PAD slots drop; negative ids wrap."""
    a_t, a_j = _both_from_pairs(*_pairs(3, 20, space=16), 24)
    for v in (16, 10):
        assert_same(tra.to_dense(a_t, v), _j_to_dense(a_j, v=v), f"v={v}")
    ids = np.array([-3, 2, 7, 30], np.int32)
    rows = _rows(np.random.default_rng(4), 4)
    a_t, a_j = _both_from_pairs(ids, rows, 6)
    assert_same(tra.to_dense(a_t, 8), _j_to_dense(a_j, v=8), "negative and large ids")


def _stream(seed, steps):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (steps, T)).astype(np.int32)
    return ids, np.stack([_rows(rng, T) for _ in range(steps)])


def test_hier_update_flush_reset_matches_reference():
    """Microbatches through the cascade with layer 1 -> 2 firing, compared
    after every step; then the flush, the overflow flag and the reset."""
    ids, rows = _stream(5, 10)
    ht = tra.hier_init(CUTS, TOP, T, D, device="cpu")
    hj = jra.hier_init(CUTS, top_capacity=TOP, batch=T, d=D)
    for s in range(ids.shape[0]):
        ht = tra.hier_update(ht, torch.tensor(ids[s]), torch.tensor(rows[s]), CUTS)
        hj = _j_update(hj, jnp.asarray(ids[s]), jnp.asarray(rows[s]), cuts=CUTS)
        assert_hier_rows_same(ht, hj, f"step {s}")
    assert int(ht.cascades[1]) > 0, "layer 1 -> 2 fired"
    assert_acc_same(tra.hier_flush(ht), _j_flush(hj), "flush")
    assert not bool(tra.hier_overflowed(ht))
    assert_hier_rows_same(tra.hier_reset(ht), jra.hier_reset(hj), "reset")


def test_hier_overflow_matches_reference():
    """A top layer too small for the distinct ids: both packages overflow
    in the same layer at the same step."""
    cuts, top = (4,), 2
    ids, rows = _stream(6, 6)
    ht = tra.hier_init(cuts, top, T, D, device="cpu")
    hj = jra.hier_init(cuts, top_capacity=top, batch=T, d=D)
    for s in range(ids.shape[0]):
        ht = tra.hier_update(ht, torch.tensor(ids[s]), torch.tensor(rows[s]), cuts)
        hj = _j_update(hj, jnp.asarray(ids[s]), jnp.asarray(rows[s]), cuts=cuts)
    assert_hier_rows_same(ht, hj)
    assert bool(tra.hier_overflowed(ht)) and bool(jra.hier_overflowed(hj))


def test_converters_carry_state_both_ways():
    """A reference cascade carried into the port continues bit-identically;
    the port's state converts back to the same numpy leaves; the carried
    tensors own their memory."""
    ids, rows = _stream(7, 8)
    hj = jra.hier_init(CUTS, top_capacity=TOP, batch=T, d=D)
    for s in range(4):
        hj = _j_update(hj, jnp.asarray(ids[s]), jnp.asarray(rows[s]), cuts=CUTS)
    layers = [tuple(np.asarray(x) for x in (l.ids, l.rows, l.nnz, l.overflow)) for l in hj.layers]
    casc = np.asarray(hj.cascades)
    ht = convert.hier_rows_from_numpy(layers, casc, device="cpu")
    assert_hier_rows_same(ht, hj, "carried")
    back, back_casc = convert.hier_rows_to_numpy(ht)
    for got, want in zip(back, layers):
        for g, w in zip(got, want):
            assert_same(g, w)
    assert_same(back_casc, casc)
    src = np.array(layers[0][1], copy=True)
    a = convert.row_accum_from_numpy(layers[0][0], src, *layers[0][2:], device="cpu")
    src[:] = 7.0
    assert_same(a.rows, layers[0][1], "owned copy")
    for s in range(4, 8):
        ht = tra.hier_update(ht, torch.tensor(ids[s]), torch.tensor(rows[s]), CUTS)
        hj = _j_update(hj, jnp.asarray(ids[s]), jnp.asarray(rows[s]), cuts=CUTS)
    assert_hier_rows_same(ht, hj, "continued")
    assert_same(convert.row_accum_to_numpy(tra.hier_flush(ht))[1], np.asarray(_j_flush(hj).rows))


def test_constructors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tra.hier_init(CUTS, TOP, T, D)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tra.empty(4, D)
