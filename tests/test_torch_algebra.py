"""The port's Fig. 1 algebra against the JAX reference, on the CPU:
``elem_mul``, ``matmul`` (with and without fanout overflow), ``to_dense``,
``cap_policy`` and the operators on ``Assoc``.  Same numpy inputs through
both packages; results compared bit for bit (the operators against the
reference's module functions at the caps the policy gives, which the
reference's own tests prove equal to its operators).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assoc as jas
from repro.core import semiring as js
from repro_torch import d4m as td4m
from repro_torch.core import assoc as tas
from repro_torch.core import semiring as ts

from _torch_parity import assert_assoc_same, assert_same

torch.set_num_threads(1)

SPACE = 32
CAP = 32

_jax = {
    "from_triples": jax.jit(jas.from_triples, static_argnames=("cap", "sr")),
    "add": jax.jit(jas.add, static_argnames=("cap", "sr")),
    "elem_mul": jax.jit(jas.elem_mul, static_argnames=("cap", "sr")),
    "matmul": jax.jit(jas.matmul, static_argnames=("cap", "max_fanout", "sr")),
    "transpose": jax.jit(jas.transpose, static_argnames=("sr",)),
    "extract_row": jax.jit(jas.extract_row, static_argnames=("cap", "sr")),
    "to_dense": jax.jit(jas.to_dense, static_argnames=("nrows", "ncols", "sr")),
}


def _rand(seed, n=24, cap=CAP, srn="plus.times"):
    """One random array in both packages (values in [0.5, 2), as the
    reference's algebra tests draw them)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, SPACE, n).astype(np.int32)
    c = rng.integers(0, SPACE, n).astype(np.int32)
    v = rng.uniform(0.5, 2.0, n).astype(np.float32)
    j = _jax["from_triples"](jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), cap=cap, sr=js.get(srn))
    t = tas.from_triples(torch.tensor(r), torch.tensor(c), torch.tensor(v), cap, ts.get(srn))
    return j, t


@pytest.mark.parametrize("srn", ["plus.times", "max.plus", "min.plus", "union.first"])
def test_elem_mul_matches_reference(srn):
    sr_j, sr_t = js.get(srn), ts.get(srn)
    ja, ta = _rand(1, srn=srn)
    jb, tb = _rand(2, srn=srn)
    jb = dataclasses.replace(jb, overflow=jnp.bool_(True))
    tb.overflow = torch.tensor(True)
    for cap in (None, 4):
        want = _jax["elem_mul"](ja, jb, cap=cap, sr=sr_j)
        assert_assoc_same(tas.elem_mul(ta, tb, cap, sr_t), want, f"cap={cap}")


@pytest.mark.parametrize("srn", ["plus.times", "max.min"])
@pytest.mark.parametrize("fanout", [2, 16], ids=["clipped", "fits"])
def test_matmul_matches_reference(srn, fanout):
    """``max_fanout`` 2 is below the inner keys' true fanout: the products
    beyond it drop and ``overflow`` is set, in both packages alike."""
    sr_j, sr_t = js.get(srn), ts.get(srn)
    ja, ta = _rand(3, n=48, cap=64, srn=srn)
    jb, tb = _rand(4, n=48, cap=64, srn=srn)
    for cap in (256, 8):
        want = _jax["matmul"](ja, jb, cap=cap, max_fanout=fanout, sr=sr_j)
        got = tas.matmul(ta, tb, cap, fanout, sr_t)
        assert_assoc_same(got, want, f"cap={cap}")
        if fanout == 2:
            assert bool(got.overflow)
    if fanout == 16:
        assert not bool(tas.matmul(ta, tb, 256, fanout, sr_t).overflow)


def test_matmul_batch_axes():
    """A [2]-batch of products equals the two unbatched products."""
    pairs = [(_rand(5 + k)[1], _rand(7 + k)[1]) for k in range(2)]
    a = tas.Assoc(*(torch.stack([getattr(p[0], f) for p in pairs]) for f in ("rows", "cols", "vals", "nnz", "overflow")))
    b = tas.Assoc(*(torch.stack([getattr(p[1], f) for p in pairs]) for f in ("rows", "cols", "vals", "nnz", "overflow")))
    got = tas.matmul(a, b, 128, 8)
    for k, (x, y) in enumerate(pairs):
        want = tas.matmul(x, y, 128, 8)
        one = tas.Assoc(got.rows[k], got.cols[k], got.vals[k], got.nnz[k], got.overflow[k])
        assert_assoc_same(one, want, k)


def test_to_dense_matches_reference():
    ja, ta = _rand(9)
    for shape in ((SPACE, SPACE), (10, 20)):
        assert_same(tas.to_dense(ta, *shape), _jax["to_dense"](ja, nrows=shape[0], ncols=shape[1]), shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_operators_match_reference_functions(seed):
    """``+ & @ .T [r,:] [:,c] [r,c]`` under the default policy."""
    ja, ta = _rand(10 + seed)
    jb, tb = _rand(20 + seed)
    assert_assoc_same(ta + tb, _jax["add"](ja, jb, cap=2 * CAP), "+")
    assert_assoc_same(ta & tb, _jax["elem_mul"](ja, jb, cap=CAP), "&")
    assert_assoc_same(ta @ tb, _jax["matmul"](ja, jb, cap=2 * CAP, max_fanout=32), "@")
    assert_assoc_same(ta.T, _jax["transpose"](ja), ".T")
    r = int(np.asarray(ja.rows)[0])
    c = int(np.asarray(ja.cols)[1])
    assert_assoc_same(ta[r, :], _jax["extract_row"](ja, r, cap=CAP), "[r, :]")
    col = _jax["transpose"](_jax["extract_row"](_jax["transpose"](ja), c, cap=CAP))
    assert_assoc_same(ta[:, c], col, "[:, c]")
    assert_same(ta[r, c], jas.get(ja, r, c), "[r, c]")
    assert ta[:, :] is ta


def test_cap_policy_scoping_and_nesting():
    _, a = _rand(30)
    _, b = _rand(31)
    with td4m.cap_policy(add_cap=16):
        assert (a + b).capacity == 16
        with td4m.cap_policy(mul_cap=8, row_cap=5):
            assert (a + b).capacity == 16  # the outer add_cap still holds
            assert (a & b).capacity == 8
            assert a[3, :].capacity == 5
        assert td4m.current_policy().mul_cap is None
    assert (a + b).capacity == a.capacity + b.capacity
    assert td4m.current_policy() == td4m.OpPolicy()
    with pytest.raises(TypeError, match="2-D"):
        a[3]
    with pytest.raises(TypeError, match="full ':' slice"):
        a[1:3, :]


@pytest.mark.parametrize("srn", ["max.plus", "min.plus"])
def test_operators_respect_policy_semiring(srn):
    sr_j, sr_t = js.get(srn), ts.get(srn)
    ja, ta = _rand(40, srn=srn)
    jb, tb = _rand(41, srn=srn)
    with td4m.cap_policy(sr=sr_t, matmul_cap=96, max_fanout=8):
        assert_assoc_same(ta + tb, _jax["add"](ja, jb, cap=2 * CAP, sr=sr_j), "+")
        assert_assoc_same(ta & tb, _jax["elem_mul"](ja, jb, cap=CAP, sr=sr_j), "&")
        assert_assoc_same(ta @ tb, _jax["matmul"](ja, jb, cap=96, max_fanout=8, sr=sr_j), "@")


def test_fig1_oneliner_matches_reference():
    """The paper's Fig. 1 chain, through the operators, equals the
    reference's function composition."""
    ja, ta = _rand(50)
    with td4m.cap_policy(matmul_cap=512, max_fanout=16):
        hot = (ta + ta.T) & ta
        two_hop = ta @ ta
    jt = _jax["transpose"](ja)
    assert_assoc_same(hot, _jax["elem_mul"](_jax["add"](ja, jt, cap=2 * CAP), ja, cap=CAP), "hot")
    assert_assoc_same(two_hop, _jax["matmul"](ja, ja, cap=512, max_fanout=16), "two_hop")
    assert int(hot.nnz) > 0 and int(two_hop.nnz) > 0
    ids, counts = (ta + ta.T).topk(3)
    want_ids, want_counts = _jax["add"](ja, jt, cap=2 * CAP).topk(3)
    assert_same(ids, want_ids)
    assert_same(counts, want_counts)
