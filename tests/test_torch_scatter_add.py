"""The port's ``scatter_add`` wrapper against the JAX reference, on the CPU.

On CPU tensors the wrapper runs its plain version (``scatter_add_plain``);
the CUDA kernel is held to that plain version bit for bit on the card by
``chip_smoke.py`` (and by the card-only test at the end, which skips
here).  The oracle is the JAX package's ``scatter_add_ref``; everything is
compared bit for bit, values included: float32 and bfloat16 tables and
rows, PAD tails with NaN in the PAD rows, NaN and ``-0.0`` in the table and
in live rows, negative and out-of-range ids, ``k = 0`` and odd widths.
One exception: a NaN written to a bfloat16 table is compared as NaN, not by
its bits, because PyTorch's CPU rounding to bfloat16 writes it as
``0xFFFF`` where XLA writes ``0x7FC0`` (on the card, kernel and plain
version both round with the card's ``cvt`` and are compared bit for bit).

ROADMAP C10: the oracle sends each PAD slot to row 0 with a masked
``+0.0``, so whenever ids hold a PAD, a ``-0.0`` in row 0 turns ``+0.0``,
whether or not id 0 is live; the TPU kernel skips PAD slots instead.  The
port follows the oracle (``test_pad_turns_row0_negative_zero``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.scatter_add.ref import scatter_add_ref
from repro_torch import kernels
from repro_torch.kernels.scatter_add import ops as tops
from repro_torch.sparse import row_accum as tra

from _torch_parity import PAD, assert_same, assert_same_but_nan_bits, np_of, to_torch

torch.set_num_threads(1)

_jax_ref = jax.jit(scatter_add_ref)

DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _run(ids, rows, table, table_dt="float32", rows_dt="float32"):
    """The oracle and the port on the same numpy inputs (cast to the two
    types by numpy, so both packages see the same bits)."""
    (nt, tt), (nr, tr) = DTYPES[table_dt], DTYPES[rows_dt]
    want = _jax_ref(jnp.asarray(ids, jnp.int32), jnp.asarray(rows.astype(nr)), jnp.asarray(table.astype(nt)))
    t = to_torch(table, tt)
    got = tops.scatter_add(torch.tensor(ids, dtype=torch.int32), to_torch(rows, tr), t)
    assert got is t, "the table is updated in place and returned"
    return got, want


def _special(rng, shape):
    """float32 normals of which about a quarter each are NaN and -0.0."""
    v = rng.normal(size=shape).astype(np.float32)
    pick = rng.integers(0, 4, shape)
    v[pick == 0] = np.nan
    v[pick == 1] = -0.0
    return v


@pytest.mark.parametrize("v,d,k", [(32, 8, 4), (64, 16, 8), (128, 128, 32), (1000, 64, 100)])
def test_shapes_match_oracle(v, d, k):
    """The JAX kernel tests' shapes (``tests/kernels/test_kernels.py``)."""
    rng = np.random.default_rng(v + d + k)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = np.sort(rng.choice(v, size=k, replace=False)).astype(np.int32)
    rows = rng.normal(size=(k, d)).astype(np.float32)
    got, want = _run(ids, rows, table)
    assert_same(got, want)


def test_pad_ids_skipped():
    table = np.zeros((16, 4), np.float32)
    ids = np.array([2, 5, PAD, PAD], np.int32)
    rows = np.ones((4, 4), np.float32)
    got, want = _run(ids, rows, table)
    assert_same(got, want)
    g = np_of(got)
    assert g[2].sum() == 4 and g[5].sum() == 4 and g.sum() == 8


@pytest.mark.parametrize("table_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows_dt", ["float32", "bfloat16"])
def test_dtypes_special_values_and_pad_tail(table_dt, rows_dt):
    """NaN and -0.0 in the table and in live rows, NaN in every PAD row,
    and float32 rows into a bfloat16 table rounded twice (cast, then add)."""
    rng = np.random.default_rng(7)
    v, d, k = 64, 24, 20
    table = _special(rng, (v, d))
    ids = np.full(k, PAD, np.int32)
    ids[:12] = np.sort(rng.choice(v, 12, replace=False))
    rows = _special(rng, (k, d))
    rows[12:] = np.nan
    got, want = _run(ids, rows, table, table_dt, rows_dt)
    if table_dt == "bfloat16":
        assert_same_but_nan_bits(got, want)
    else:
        assert_same(got, want)


@pytest.mark.parametrize("row0_live", [False, True], ids=["row0-dead", "row0-live"])
@pytest.mark.parametrize("pad", [False, True], ids=["no-pad", "pad"])
@pytest.mark.parametrize("table_dt", ["float32", "bfloat16"])
def test_pad_turns_row0_negative_zero(row0_live, pad, table_dt):
    """C10: with a PAD slot, row 0's -0.0 turns +0.0 (live or not); without
    one it stays -0.0 where nothing is added."""
    v, d = 8, 4
    table = np.ones((v, d), np.float32)
    table[0] = [-0.0, -0.0, np.nan, 1.0]
    ids = [0, 3] if row0_live else [2, 3]
    ids = np.array(ids + ([PAD] if pad else []), np.int32)
    rows = np.ones((len(ids), d), np.float32)
    if row0_live:
        rows[0] = [-0.0, 2.0, 1.0, -0.0]  # -0.0 + -0.0 = -0.0 before the PAD's +0.0
    got, want = _run(ids, rows, table, table_dt)
    assert_same(got, want)
    row0 = np_of(got)[0].astype(np.float32)
    assert np.signbit(row0[0]) == (not pad)


def test_negative_and_out_of_range_ids():
    """A negative id wraps to V + id (also onto a row a non-negative id
    adds to), an id outside [-V, V) drops."""
    rng = np.random.default_rng(3)
    v, d = 16, 5
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = np.array([-40, -16, -3, -1, 0, 4, 13, 16, 99, PAD], np.int32)
    rows = rng.normal(size=(len(ids), d)).astype(np.float32)
    for table_dt in ("float32", "bfloat16"):
        got, want = _run(ids, rows, table, table_dt)
        assert_same(got, want, table_dt)


@pytest.mark.parametrize("d", [1, 3])
def test_empty_and_odd_widths(d):
    rng = np.random.default_rng(d)
    table = _special(rng, (10, d))
    got, want = _run(np.zeros(0, np.int32), np.zeros((0, d), np.float32), table)
    assert_same(got, want, "k=0")
    ids = np.array([1, 4, 9, PAD, PAD], np.int32)
    got, want = _run(ids, _special(rng, (5, d)), table, "bfloat16")
    assert_same_but_nan_bits(got, want, "d odd")


def test_wrapper_counts_only_kernel_launches():
    """The CPU path is the plain version: no launch is counted, and
    ``row_accum.to_dense`` gives the same table inside ``plain_versions()``."""
    rng = np.random.default_rng(11)
    ids = torch.tensor([0, 2, 5, PAD], dtype=torch.int32)
    rows = torch.tensor(_special(rng, (4, 6)))
    before = tops.launch_count
    a = tra.RowAccum(ids=ids, rows=rows, nnz=torch.tensor(3, dtype=torch.int32), overflow=torch.tensor(False))
    dense = tra.to_dense(a, 8)
    with kernels.plain_versions():
        plain = tra.to_dense(a, 8)
    assert tops.launch_count == before
    assert_same(dense, plain)
    want = _jax_ref(jnp.asarray(ids.numpy()), jnp.asarray(rows.numpy()), jnp.zeros((8, 6), jnp.float32))
    assert_same(dense, want)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    rng = np.random.default_rng(5)
    v, d = 100, 40
    for table_dt in ("float32", "bfloat16"):
        for rows_dt in ("float32", "bfloat16"):
            tt, tr = DTYPES[table_dt][1], DTYPES[rows_dt][1]
            table = to_torch(_special(rng, (v, d)), tt).cuda()
            ids = np.full(50, PAD, np.int32)
            ids[:30] = np.sort(rng.choice(v, 30, replace=False))
            ids_t = torch.tensor(ids, device="cuda")
            rows = to_torch(_special(rng, (50, d)), tr).cuda()
            want = tops.scatter_add_plain(ids_t, rows, table.clone())
            got = tops.scatter_add(ids_t, rows, table)
            torch.cuda.synchronize()
            assert_same(got, want, (table_dt, rows_dt))
