"""Helpers shared by the port's parity tests (``test_torch_*.py``): the same
numpy inputs go through the JAX reference and ``repro_torch``, and the
results are compared bit-exactly."""
import ml_dtypes
import numpy as np
import torch


PAD = 2**31 - 1


def stream(seed, shape, space):
    """Random ``(rows, cols, vals)`` int32/int32/float32 numpy triples."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, space, shape).astype(np.int32)
    c = rng.integers(0, space, shape).astype(np.int32)
    v = rng.normal(size=shape).astype(np.float32)
    return r, c, v


def special_values(rng, shape):
    """float32 values of which about a quarter each are NaN, -0.0, +0.0 and
    normal: the values whose bits a max/min or a ``+ 0`` can change."""
    v = rng.normal(size=shape).astype(np.float32)
    pick = rng.integers(0, 4, shape)
    v[pick == 0] = np.nan
    v[pick == 1] = -0.0
    v[pick == 2] = 0.0
    return v


def seeded_layers(seed, k, caps, fill, space, zero):
    """Leaves of a packed hierarchy that already holds entries: per layer
    ``(rows, cols, vals, nnz, overflow)`` with ``[K, cap]`` buffers, each
    instance holding ``fill[i]`` sorted unique keys whose values come from
    :func:`special_values`, and ``[K, L]`` zero cascade counters."""
    rng = np.random.default_rng(seed)
    layers = []
    for cap, n in zip(caps, fill):
        r = np.full((k, cap), PAD, np.int32)
        c = np.full((k, cap), PAD, np.int32)
        v = np.full((k, cap), zero, np.float32)
        for i in range(k):
            keys = np.sort(rng.choice(space * space, n, replace=False))
            r[i, :n], c[i, :n] = keys // space, keys % space
            v[i, :n] = special_values(rng, n)
        layers.append((r, c, v, np.full(k, n, np.int32), np.zeros(k, bool)))
    return layers, np.zeros((k, len(caps)), np.int32)


def np_of(x):
    """numpy of a tensor or array; bfloat16 as ``ml_dtypes.bfloat16``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def to_torch(x, dtype=None):
    """A tensor copy of numpy ``x``; ``dtype=torch.bfloat16`` rounds the
    values to bfloat16 as numpy's ``ml_dtypes`` does (so both packages get
    the same bits)."""
    x = np.asarray(x)
    if dtype == torch.bfloat16 or x.dtype == ml_dtypes.bfloat16:
        bits = x.astype(ml_dtypes.bfloat16).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.tensor(x, dtype=dtype)


def assert_same(got, want, what=""):
    """Bitwise equality (NaNs equal by bit pattern, -0.0 != +0.0)."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    if g.dtype == np.float32:
        g, w = g.view(np.int32), w.view(np.int32)
    elif g.dtype == ml_dtypes.bfloat16:
        g, w = g.view(np.int16), w.view(np.int16)
    np.testing.assert_array_equal(g, w, err_msg=str(what))


def assert_same_but_nan_bits(got, want, what=""):
    """:func:`assert_same` where the NaN bit patterns may differ: NaN in the
    same places, every other value bit for bit.  For bfloat16 on the CPU,
    where PyTorch's vectorized float32 -> bfloat16 rounding writes NaN as
    ``0xFFFF`` and its scalar one (and XLA's) as ``0x7FC0``."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.shape, w.shape, g.dtype, w.dtype)
    gn, wn = np.isnan(g.astype(np.float32)), np.isnan(w.astype(np.float32))
    np.testing.assert_array_equal(gn, wn, err_msg=f"{what}: NaN positions")
    bits = np.int16 if g.dtype == ml_dtypes.bfloat16 else np.int32
    np.testing.assert_array_equal(
        np.where(gn, 0, g.view(bits)), np.where(wn, 0, w.view(bits)), err_msg=str(what)
    )


def assert_assoc_same(got, want, what=""):
    for f in ("rows", "cols", "vals", "nnz", "overflow"):
        assert_same(getattr(got, f), getattr(want, f), f"{what}.{f}")


def assert_hier_same(got, want, what="", same_vals=assert_same):
    """Port hierarchy vs reference hierarchy, layer by layer.  One side's
    layer may be wider (the reference's Pallas engine pads to powers of
    two): the common prefix must be identical and the wider tail dead.
    ``same_vals`` compares the values (:func:`assert_same_but_nan_bits` for
    bfloat16 on the CPU)."""
    assert len(got.layers) == len(want.layers)
    for i, (g, w) in enumerate(zip(got.layers, want.layers)):
        cap = min(np_of(g.rows).shape[-1], np_of(w.rows).shape[-1])
        for f in ("rows", "cols", "vals"):
            gv, wv = np_of(getattr(g, f)), np_of(getattr(w, f))
            check = same_vals if f == "vals" else assert_same
            check(gv[..., :cap], wv[..., :cap], f"{what}.layer{i}.{f}")
        for x in (g, w):
            tail = np_of(x.rows)[..., cap:]
            assert (tail == PAD).all(), f"{what}.layer{i} tail not dead"
        assert_same(g.nnz, w.nnz, f"{what}.layer{i}.nnz")
        assert_same(g.overflow, w.overflow, f"{what}.layer{i}.overflow")
    assert_same(got.cascades, want.cascades, f"{what}.cascades")
