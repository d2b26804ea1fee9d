"""int32 and float16 values (ROADMAP C12) and the engine's wire name
(C13), on the CPU, against the JAX reference.

On the CPU every kernel wrapper runs its plain version; the CUDA kernels
are held to those, bit for bit, in both types, by ``chip_smoke.py`` on the
card.  Compared bit for bit: keys, ``nnz``, overflow flags, cascade
counters and every live value (int32 ``plus`` wraps as XLA's add does;
float16 folds round after each operation).  The values of dead slots are
compared bit for bit in float16.  In int32 the reference writes a
semiring's ``inf`` or NaN zero into dead slots by a float-to-int
conversion that differs between its eager code (saturating:
``hierarchical.init``) and its jitted code (INT32_MIN: every update), C15;
the port writes the saturating value everywhere, and those slots are held
to it.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import d4m as jd4m
from repro.core import assoc as jas
from repro.core import semiring as js
from repro.kernels.hier_cascade import ops as jops
from repro_torch import d4m as td4m
from repro_torch.core import assoc as tas
from repro_torch.core import semiring as ts
from repro_torch.kernels import _launch
from repro_torch.kernels.hier_cascade import ops as tops

from _torch_parity import PAD, assert_same, np_of

torch.set_num_threads(1)

DTYPES = ["int32", "float16"]
SEMIRINGS = sorted(js.REGISTRY)


def _values(rng, dt, shape):
    """int32: extremes included, so plus wraps; float16: NaN, -0.0, +0.0,
    overflow to inf and normal values."""
    if dt == "int32":
        v = rng.integers(-(2**31), 2**31 - 1, shape, dtype=np.int64)
        v[rng.random(shape) < 0.5] = rng.integers(-5, 6, shape)[rng.random(shape) < 0.5][0]
        return v.astype(np.int32)
    v = (rng.normal(size=shape) * 3e4).astype(np.float32)
    pick = rng.integers(0, 5, shape)
    v[pick == 0] = np.nan
    v[pick == 1] = -0.0
    v[pick == 2] = 0.0
    return v.astype(np.float16)


def _assert_values(got, want, nnz, srn, dt, what):
    """Live values bit for bit; dead ones too in float16, in int32 the
    port's saturated zero (C15)."""
    g, w = np_of(got), np.asarray(want)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    nnz = np.broadcast_to(np.asarray(nnz), g.shape[:-1])
    live = np.arange(g.shape[-1]) < nnz[..., None]
    bits = np.int32 if dt == "int32" else np.int16
    np.testing.assert_array_equal(g.view(bits)[live], w.view(bits)[live], err_msg=what)
    if dt == "float16":
        np.testing.assert_array_equal(g.view(bits), w.view(bits), err_msg=what)
    else:
        assert (g[~live] == ts.get(srn).zero_as(torch.int32)).all(), what


def _assert_assoc(got, want, srn, dt, what):
    for f in ("rows", "cols", "nnz", "overflow"):
        assert_same(getattr(got, f), np.asarray(getattr(want, f)), f"{what}.{f}")
    _assert_values(got.vals, want.vals, np.asarray(want.nnz), srn, dt, what)


@pytest.mark.parametrize("srn", SEMIRINGS)
@pytest.mark.parametrize("dt", DTYPES)
def test_from_triples_and_add(dt, srn):
    """The two kernels' functions, ``sort_dedup``'s ``from_triples`` and
    ``merge_add``'s ``add``, in int32 and float16."""
    rng = np.random.default_rng(SEMIRINGS.index(srn) + 10 * DTYPES.index(dt))
    r, c = rng.integers(0, 6, (2, 2, 40)).astype(np.int32)
    r[:, ::9] = PAD
    v = _values(rng, dt, (2, 40))
    jsr, tsr = js.get(srn), ts.get(srn)
    # the reference eagerly: its primitives compile once for all semirings
    a = [jas.from_triples(jnp.asarray(r[i]), jnp.asarray(c[i]), jnp.asarray(v[i]), 24, sr=jsr) for i in range(2)]
    b = [tas.from_triples(torch.tensor(r[i]), torch.tensor(c[i]), torch.tensor(v[i]), 24, tsr) for i in range(2)]
    for i in range(2):
        _assert_assoc(b[i], a[i], srn, dt, f"from_triples{i}")
    # the reference's inputs to add: same keys, its own dead slots
    _assert_assoc(tas.add(b[0], b[1], 40, tsr), jas.add(a[0], a[1], 40, sr=jsr), srn, dt, "add")


@pytest.mark.parametrize("dt", DTYPES)
def test_single_session_matches_reference(dt):
    """The ``single`` engine's session in each type (``min.plus``: an int32
    zero the conversion saturates), held to the reference's session."""
    cfg = jd4m.StreamConfig(cuts=(8, 32), top_capacity=256, batch_size=16, engine="single",
                            dtype=dt, semiring="min.plus", snapshot_cap=512)
    ref = jd4m.D4MStream(cfg)
    port = td4m.D4MStream.from_dict(cfg.to_dict(), device="cpu")
    assert port.dtype == getattr(torch, dt)
    rng = np.random.default_rng(7)
    for _ in range(6):
        r, c = rng.integers(0, 24, (2, 16)).astype(np.int32)
        v = _values(rng, dt, 16)
        ref.ingest(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v))
        port.ingest(r, c, v)
    for i, (gl, wl) in enumerate(zip(port.state.layers, ref.state.layers)):
        _assert_assoc(gl, wl, "min.plus", dt, f"layer{i}")
    assert_same(port.state.cascades, np.asarray(ref.state.cascades), "cascades")
    assert int(np.asarray(ref.state.cascades)[..., 1:].sum()) > 0
    _assert_assoc(port.snapshot(), ref.snapshot(), "min.plus", dt, "snapshot")


def _cascade_stream(dt, k=2, batch=16):
    rng = np.random.default_rng(3)
    R = rng.integers(0, 20, (4, k, batch)).astype(np.int32)
    C = rng.integers(0, 20, (4, k, batch)).astype(np.int32)
    return R, C, _values(rng, dt, R.shape)


def _port_cascade(dt, srn, R, C, V, cuts=(8, 32), top=256, batch=16):
    got, caps = tops.init_state(R.shape[1], cuts, top, batch, ts.get(srn), getattr(torch, dt), device="cpu")
    for t in range(R.shape[0]):
        got = tops.cascade_update(got, torch.tensor(R[t]), torch.tensor(C[t]), torch.tensor(V[t]),
                                  cuts, caps, ts.get(srn))
    return got


@pytest.mark.parametrize("srn,dt", [("plus.times", "int32"), ("plus.times", "float16"), ("max.plus", "float16")])
def test_cascade_step_against_pallas_kernel_interpret(srn, dt):
    """The ``cuda`` engine's step (its plain version on the CPU) against
    the reference's Pallas kernel in interpret mode, as C11's bfloat16
    test holds it."""
    cuts, top, batch, k = (8, 32), 256, 16, 2
    R, C, V = _cascade_stream(dt)
    sr_j = js.get(srn)
    h, caps = jops.init_state(k, cuts, top, batch, sr_j, dtype=getattr(jnp, dt))
    step = jops.build_step(cuts, caps, sr_j, donate=False, interpret=True)
    for t in range(R.shape[0]):
        h = step(h, jnp.asarray(R[t]), jnp.asarray(C[t]), jnp.asarray(V[t]))
    got = _port_cascade(dt, srn, R, C, V)
    for i, (gl, wl) in enumerate(zip(got.layers, h.layers)):
        cap = gl.capacity
        _assert_values(gl.vals, np.asarray(wl.vals)[..., :cap], np.asarray(wl.nnz), srn, dt, f"l{i}")
        assert_same(gl.rows, np.asarray(wl.rows)[..., :cap], f"l{i}.rows")
        assert_same(gl.nnz, np.asarray(wl.nnz), f"l{i}.nnz")
    assert_same(got.cascades, np.asarray(h.cascades), "cascades")
    assert int(got.cascades[:, 1].sum()) > 0


def test_int32_cascade_with_an_infinite_zero_against_the_packed_engine():
    """The reference's Pallas kernel cannot take an int32 semiring whose
    zero is infinite or NaN (its ``jnp.asarray(sr.zero, int32)`` raises,
    C15), so the port's ``cuda`` step in int32 ``max.plus`` is held to the
    reference's branchless ``packed`` engine, which computes the same
    state."""
    from repro.core import multistream as jm

    R, C, V = _cascade_stream("int32")
    sr_j = js.get("max.plus")
    h, caps = jops.init_state(2, (8, 32), 256, 16, sr_j, dtype=jnp.int32)
    with pytest.raises(OverflowError):
        jops.build_step((8, 32), caps, sr_j, donate=False, interpret=True)(
            h, jnp.asarray(R[0]), jnp.asarray(C[0]), jnp.asarray(V[0])
        )
    ref = jm.init_packed(2, (8, 32), 256, 16, sr_j, dtype=jnp.int32)
    step = jax.jit(lambda h, r, c, v: jm.packed_update(h, r, c, v, (8, 32), sr_j))
    for t in range(R.shape[0]):
        ref = step(ref, jnp.asarray(R[t]), jnp.asarray(C[t]), jnp.asarray(V[t]))
    got = _port_cascade("int32", "max.plus", R, C, V)
    for i, (gl, wl) in enumerate(zip(got.layers, ref.layers)):
        _assert_assoc(gl, wl, "max.plus", "int32", f"l{i}")
    assert_same(got.cascades, np.asarray(ref.cascades), "cascades")
    assert int(got.cascades[:, 1].sum()) > 0


# -- C15: the reference's int32 zeros ---------------------------------------

@pytest.mark.parametrize("zero,eager,jitted", [
    (math.inf, 2**31 - 1, -(2**31)),
    (-math.inf, -(2**31), -(2**31)),
    (math.nan, 0, -(2**31)),
])
def test_reference_int32_zero_depends_on_jit(zero, eager, jitted):
    """A fact about the reference: ``jnp.full(shape, zero, int32)``
    saturates eagerly (NaN to 0) and gives INT32_MIN under jit, so its
    int32 dead slots hold one value after ``init`` and another after an
    update.  The port writes the eager (saturating) value everywhere."""
    assert int(jnp.full((1,), zero, jnp.int32)[0]) == eager
    assert int(jax.jit(lambda: jnp.full((1,), zero, jnp.int32))()[0]) == jitted
    assert ts.as_value(zero, torch.int32) == eager
    assert tas.empty(2, ts.Semiring("z", None, None, zero, zero, 0), torch.int32,
                     device="cpu").vals.tolist() == [eager, eager]


@pytest.mark.parametrize("dt", [torch.int32, torch.float16, torch.bfloat16, torch.float32])
def test_every_kernel_value_type_has_a_code(dt):
    assert _launch.dtype_code(torch.zeros(1, dtype=dt), "merge_add") == _launch.DTYPE_CODES[dt]
    bits = _launch.zero_bits(-math.inf, dt)
    want = torch.full((), ts.as_value(-math.inf, dt), dtype=dt)
    assert bits == int(want.view(torch.int16 if dt.itemsize == 2 else torch.int32)) & (
        0xFFFF if dt.itemsize == 2 else 0xFFFFFFFF
    )


def test_scatter_add_refuses_int32():
    from repro_torch.kernels.scatter_add import ops

    with pytest.raises(NotImplementedError, match="float32, bfloat16, float16"):
        _launch.dtype_code(torch.zeros(1, dtype=torch.int32), "scatter_add", ops.TYPES)


# -- C13: the engine's wire name ------------------------------------------------

@pytest.mark.parametrize("engine,k", [("auto", 4), ("single", 1), ("packed", 4), ("cuda", 4), ("pallas", 4)])
def test_port_wire_form_reads_in_the_reference(engine, k):
    cfg = td4m.StreamConfig(cuts=(8,), top_capacity=64, batch_size=8, instances_per_device=k,
                            engine=engine, dtype="float16")
    wire = cfg.to_dict()
    ref = jd4m.StreamConfig.from_dict(wire)
    assert ref.engine == {"cuda": "pallas"}.get(cfg.engine, cfg.engine)
    assert ref.to_dict() == wire
    assert td4m.StreamConfig.from_dict(ref.to_dict()) == cfg
