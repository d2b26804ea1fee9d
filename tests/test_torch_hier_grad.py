"""The port's embedding-gradient path (``repro_torch.sparse.hier_grad``) and
AdamW (``repro_torch.optim.adamw``) against the JAX reference, on the CPU.

Tolerances:

* ``lr_schedule``: within 4 ulp.  Its float32 ``cos`` differs from XLA's
  by an ulp at some steps, and ``1 + cos`` near the end of the decay
  magnifies that (measured: at most 3 ulp over every 7th step to 12,000,
  and bit for bit at most steps);
* ``sparse_adamw_row_update``: bit for bit at steps where the learning
  rate agrees bit for bit (the test checks that first).  The rest is
  elementwise float32 (``pow``, ``sqrt`` included) that agrees with XLA's
  on these inputs.  Over several steps of training, where the learning
  rate may differ in its last bits, ``rtol=1e-6``;
* ``global_norm`` and the dense ``adamw.update``: ``rtol=1e-6``.  The norm
  is a float32 sum whose order is each library's own (XLA's reduction
  tree against PyTorch's vectorized one), and the clip scale of every
  update follows it;
* lazy AdamW against dense AdamW when every row is touched: the reference
  test's own ``rtol=2e-5, atol=2e-6`` (and ``1e-4, 1e-5`` over several
  steps); the two differ in the clip scale's rounding and the gradient's
  summation order.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jad
from repro.sparse import hier_grad as jhg
from repro.sparse import row_accum as jra
from repro_torch.sparse import convert
from repro_torch.optim import adamw as tad
from repro_torch.sparse import hier_grad as thg
from repro_torch.sparse import row_accum as tra

from _torch_parity import PAD, assert_same, np_of, to_torch

torch.set_num_threads(1)

V, D = 32, 6
OPT = dict(lr=1e-2, warmup_steps=4, total_steps=50)


def _cfgs(**kw):
    kw = {**OPT, **kw}
    return jad.AdamWConfig(**kw), tad.AdamWConfig(**kw)


def _step(s):
    return jnp.asarray(s, jnp.int32), torch.tensor(s, dtype=torch.int32)


def test_lr_schedule_within_4_ulp():
    """Warmup, the cosine decay and its floor, over every 7th step."""
    steps = np.arange(0, 12_000, 7, dtype=np.int32)
    for kw in ({}, dict(warmup_steps=100, total_steps=10_000), dict(warmup_steps=0)):
        cj, ct = _cfgs(**kw)
        want = np.asarray(jad.lr_schedule(cj, jnp.asarray(steps)))
        got = np_of(tad.lr_schedule(ct, torch.tensor(steps)))
        np.testing.assert_array_max_ulp(got, want, maxulp=4)
        assert (got == want).mean() > 0.9, kw


@pytest.mark.parametrize("table_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 3, 60])
def test_sparse_adamw_row_update_bit_exact(table_dt, step):
    """Duplicated ids folded by ``from_pairs``, a PAD tail, a clip scale;
    float32 and bfloat16 tables (float32 moments), each step a different
    point of the schedule."""
    rng = np.random.default_rng(step)
    cj, ct = _cfgs()
    table = rng.normal(size=(V, D)).astype(np.float32)
    if table_dt == "bfloat16":
        table = table.astype(ml_dtypes.bfloat16)
    m = (rng.normal(size=(V, D)) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=(V, D))) * 0.01).astype(np.float32)
    ids = rng.integers(0, V, 20).astype(np.int32)
    rows = rng.normal(size=(20, D)).astype(np.float32)
    fj = jra.from_pairs(jnp.asarray(ids), jnp.asarray(rows), cap=24)
    ft = tra.from_pairs(torch.tensor(ids), torch.tensor(rows), 24)
    assert_same(tad.lr_schedule(ct, _step(step + 1)[1]), jad.lr_schedule(cj, _step(step + 1)[0]), "lr")
    want = jhg.sparse_adamw_row_update(fj, jnp.asarray(table), jnp.asarray(m), jnp.asarray(v), _step(step)[0], cj, scale=0.7)
    e = convert.embedding_from_numpy({"table": table, "m": m, "v": v}, device="cpu")
    got = thg.sparse_adamw_row_update(ft, e["table"], e["m"], e["v"], _step(step)[1], ct, scale=0.7)
    assert got[0] is e["table"], "updated in place"
    for g, w, name in zip(got, want, ("table", "m", "v")):
        assert_same(g, w, name)
    back = convert.embedding_to_numpy(e)
    assert_same(back["table"], want[0], "converted back")


def test_pad_rows_never_touch_table():
    _, ct = _cfgs(weight_decay=0.0)
    table = torch.zeros((8, 4))
    flushed = tra.empty(4, 4, device="cpu")
    t2, m2, v2 = thg.sparse_adamw_row_update(flushed, table, torch.zeros((8, 4)), torch.zeros((8, 4)), _step(0)[1], ct)
    assert not t2.any() and not m2.any() and not v2.any()


def _tree(rng):
    return {
        "b": {"x": rng.normal(size=(4, 3)).astype(np.float32)},
        "a": rng.normal(size=(5,)).astype(np.float32),
        "c": [rng.normal(size=(2,)).astype(np.float32), rng.normal(size=(3, 1)).astype(np.float32)],
    }


def test_dense_adamw_update_matches_reference():
    """Nested dicts and lists; leaves in JAX's order (sorted keys); clipping
    engaged (the global norm is above ``grad_clip``)."""
    rng = np.random.default_rng(9)
    cj, ct = _cfgs(grad_clip=0.5)
    params, grads = _tree(rng), _tree(rng)
    pj, gj = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    pt, gt = tad.tree_map(torch.tensor, params), tad.tree_map(torch.tensor, grads)
    np.testing.assert_allclose(np_of(tad.global_norm(gt)), np.asarray(jad.global_norm(gj)), rtol=1e-6)
    sj, st = jad.init(pj), tad.init(pt)
    for _ in range(3):
        pj, sj, mj = jad.update(gj, sj, pj, cj)
        pt, st, mt = tad.update(gt, st, pt, ct)
        assert float(mt["grad_norm"]) > 0.5
        np.testing.assert_allclose(np_of(mt["grad_norm"]), np.asarray(mj["grad_norm"]), rtol=1e-6)
        assert_same(mt["lr"], mj["lr"])
        assert int(st["step"]) == int(sj["step"])
        for tree_t, tree_j in ((pt, pj), (st["m"], sj["m"]), (st["v"], sj["v"])):
            for lt, lj in zip(tad.tree_leaves(tree_t), jax.tree.leaves(tree_j)):
                np.testing.assert_allclose(np_of(lt), np.asarray(lj), rtol=1e-6)
    assert list(pt) == list(params) and isinstance(pt["c"], list)


def test_lazy_adamw_equals_dense_when_all_rows_touched():
    """The reference's lazy == dense check (``tests/test_sparse.py``), in
    the port, and the port's lazy result against the reference's."""
    rng = np.random.default_rng(2)
    v, d = 16, 8
    cj, ct = jad.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100), tad.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100)
    table = rng.normal(size=(v, d)).astype(np.float32)
    g = rng.normal(size=(v, d)).astype(np.float32)
    flushed = tra.from_pairs(torch.arange(v, dtype=torch.int32), torch.tensor(g), v)
    newp, newstate, _ = tad.update(
        {"t": torch.tensor(g)},
        {"m": {"t": torch.zeros(v, d)}, "v": {"t": torch.zeros(v, d)}, "step": torch.zeros((), dtype=torch.int32)},
        {"t": torch.tensor(table)},
        ct,
    )
    scale = min(1.0, ct.grad_clip / (float(np.sqrt((g.astype(np.float64) ** 2).sum())) + 1e-9))
    t_s, m_s, _ = thg.sparse_adamw_row_update(
        flushed, torch.tensor(table), torch.zeros(v, d), torch.zeros(v, d), _step(0)[1], ct, scale=scale
    )
    np.testing.assert_allclose(np_of(t_s), np_of(newp["t"]), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np_of(m_s), np_of(newstate["m"]["t"]), rtol=2e-5, atol=2e-6)
    fj = jra.from_pairs(jnp.arange(v, dtype=jnp.int32), jnp.asarray(g), cap=v)
    tj, mj, _ = jhg.sparse_adamw_row_update(fj, jnp.asarray(table), jnp.zeros((v, d)), jnp.zeros((v, d)), _step(0)[0], cj, scale=scale)
    assert_same(t_s, tj)
    assert_same(m_s, mj)


def test_end_to_end_sparse_embedding_training_matches_dense():
    """Several steps of dense gradients + dense AdamW against the cascade +
    lazy AdamW, every row touched every step (the reference's test), and
    the port's sparse trajectory against the reference's."""
    rng = np.random.default_rng(3)
    v, d, steps = 8, 4, 5
    kw = dict(lr=1e-2, weight_decay=0.0, grad_clip=1e9, warmup_steps=0)
    cj, ct = jad.AdamWConfig(**kw), tad.AdamWConfig(**kw)
    table = rng.normal(size=(v, d)).astype(np.float32)
    t_dense, t_sparse = torch.tensor(table), torch.tensor(table)
    m_d, v_d = torch.zeros(v, d), torch.zeros(v, d)
    m_s, v_s = torch.zeros(v, d), torch.zeros(v, d)
    tj, mj, vj = jnp.asarray(table), jnp.zeros((v, d)), jnp.zeros((v, d))
    hcfg = thg.HierGradConfig(cuts=(8,), top_capacity=4 * v)
    jcfg = jhg.HierGradConfig(cuts=(8,), top_capacity=4 * v)
    ids = np.tile(np.arange(v), 2).astype(np.int32)  # touch all rows
    for s in range(steps):
        rows = rng.normal(size=(len(ids), d)).astype(np.float32)
        gd = torch.zeros(v, d).index_add_(0, torch.tensor(ids, dtype=torch.int64), torch.tensor(rows))
        st = {"m": {"t": m_d}, "v": {"t": v_d}, "step": torch.tensor(s, dtype=torch.int32)}
        newp, newst, _ = tad.update({"t": gd}, st, {"t": t_dense}, ct)
        t_dense, m_d, v_d = newp["t"], newst["m"]["t"], newst["v"]["t"]
        h = thg.init_accumulator(hcfg, len(ids), d, device="cpu")
        h = thg.accumulate_microbatch(h, torch.tensor(ids).reshape(2, v), torch.tensor(rows).reshape(2, v, d), hcfg)
        flushed = tra.hier_flush(h)
        t_sparse, m_s, v_s = thg.sparse_adamw_row_update(flushed, t_sparse, m_s, v_s, torch.tensor(s, dtype=torch.int32), ct)
        hj = jhg.init_accumulator(jcfg, len(ids), d)
        hj = jhg.accumulate_microbatch(hj, jnp.asarray(ids).reshape(2, v), jnp.asarray(rows).reshape(2, v, d), jcfg)
        fj = jra.hier_flush(hj)
        assert_same(thg.dense_grad_of(flushed, v), jhg.dense_grad_of(fj, v))
        tj, mj, vj = jhg.sparse_adamw_row_update(fj, tj, mj, vj, jnp.asarray(s, jnp.int32), cj)
    np.testing.assert_allclose(np_of(t_sparse), np_of(t_dense), rtol=1e-4, atol=1e-5)
    for g, w in zip((t_sparse, m_s, v_s), (tj, mj, vj)):
        np.testing.assert_allclose(np_of(g), np.asarray(w), rtol=1e-6)
