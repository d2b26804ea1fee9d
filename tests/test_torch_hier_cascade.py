"""The port's ``hier_cascade`` step against the JAX reference, on the CPU.

On CPU tensors the port's wrapper runs the kernel's plain version, so this
holds that plain version (and the wrapper's layout and flag handling) to the
reference bit-exactly: layers, nnz, cascade counters and overflow flags.
The reference is the JAX packed (branchless, vmapped) engine and the cond
engine, at the sizes of ``tests/kernels/test_hier_cascade.py``, plus one
case against the Pallas kernel itself in interpret mode.  The CUDA kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assoc as ja
from repro.core import hierarchical as jh
from repro.core import multistream as jm
from repro.core import semiring as js
from repro.kernels.hier_cascade import ops as jops
from repro_torch.core import convert
from repro_torch.core import hierarchical as th
from repro_torch.core import multistream as tm
from repro_torch.core import semiring as ts
from repro_torch.kernels import _build
from repro_torch.kernels.hier_cascade import ops as tops

from _torch_parity import (
    assert_hier_same,
    assert_same_but_nan_bits,
    seeded_layers,
    special_values,
    stream,
    to_torch,
)

torch.set_num_threads(1)

SPACE = 48


def _jax_hier(layers, cascades):
    return jh.HierAssoc(
        layers=tuple(ja.Assoc(*(jnp.asarray(x) for x in l)) for l in layers),
        cascades=jnp.asarray(cascades),
    )


def _run_port(cuts, top, batch, R, C, V, srn, init=None):
    sr = ts.get(srn)
    h, caps = tops.init_state(R.shape[1], cuts, top, batch, sr, device="cpu")
    if init is not None:
        h = convert.hier_from_numpy(*init, device="cpu")
    for t in range(R.shape[0]):
        h = tops.cascade_update(
            h, torch.tensor(R[t]), torch.tensor(C[t]), torch.tensor(V[t]), cuts, caps, sr
        )
    return h


def _run_branchless(cuts, top, batch, R, C, V, srn, init=None):
    sr = js.get(srn)
    h = jm.init_packed(R.shape[1], cuts, top_capacity=top, batch_size=batch, sr=sr)
    if init is not None:
        h = _jax_hier(*init)
    step = jax.jit(
        lambda hh, r, c, v: jm.packed_update(hh, r, c, v, cuts, sr, branchless=True)
    )
    for t in range(R.shape[0]):
        h = step(h, R[t], C[t], V[t])
    return h


def _run_cond(cuts, top, batch, R, C, V, srn, init=None):
    sr = js.get(srn)
    step = jax.jit(lambda hh, r, c, v: jh.update_triples(hh, r, c, v, cuts, sr))
    out = []
    for k in range(R.shape[1]):
        h = jh.init(cuts, top_capacity=top, batch_size=batch, sr=sr)
        if init is not None:
            layers, casc = init
            h = _jax_hier([tuple(x[k] for x in l) for l in layers], casc[k])
        for t in range(R.shape[0]):
            h = step(h, R[t, k], C[t, k], V[t, k])
        out.append(h)
    return out


def _assert_parity(cuts, top, batch, R, C, V, srn="plus.times", init=None):
    got = _run_port(cuts, top, batch, R, C, V, srn, init)
    assert_hier_same(got, _run_branchless(cuts, top, batch, R, C, V, srn, init), "packed")
    for k, want in enumerate(_run_cond(cuts, top, batch, R, C, V, srn, init)):
        assert_hier_same(tm.instance(got, k), want, f"cond[{k}]")
    return got


@pytest.mark.parametrize("k", [1, 8])
def test_parity_cascades_absent(k):
    R, C, V = stream(0, (5, k, 8), SPACE)
    h = _assert_parity((512,), 2048, 8, R, C, V)
    assert int(h.cascades[:, 1:].sum()) == 0


@pytest.mark.parametrize("k", [1, 8])
def test_parity_cascades_forced(k):
    R, C, V = stream(1, (6, k, 16), SPACE)
    h = _assert_parity((8, 32), 256, 16, R, C, V)
    assert (h.cascades[:, 1] > 0).all()
    assert int(h.cascades[:, 2].sum()) > 0


def test_parity_overflow():
    R, C, V = stream(2, (6, 2, 16), 256)
    h = _assert_parity((8,), 12, 16, R, C, V)
    assert bool(tm.overflowed_per_instance(h).any())


@pytest.mark.parametrize("srn", ["max.plus", "min.plus", "union.first"])
def test_parity_semirings(srn):
    R, C, V = stream(3, (5, 2, 16), SPACE)
    _assert_parity((8, 32), 256, 16, R, C, V, srn)


@pytest.mark.parametrize("srn", ["plus.times", "max.plus", "min.plus", "union.first"])
def test_parity_nan_and_negative_zero(srn):
    """NaN and -0.0 in the batches and in entries the layers already hold:
    max/min must propagate NaN and every merge must turn -0.0 into +0.0
    exactly as the reference does, bit for bit."""
    cuts, top, batch, k = (8, 32), 256, 16, 2
    caps = th.telescoped_caps(cuts, top, batch)
    init = seeded_layers(7, k, caps, (6, 20, 40), SPACE, ts.get(srn).zero)
    R, C, _ = stream(8, (5, k, batch), SPACE)
    V = special_values(np.random.default_rng(9), R.shape)
    h = _assert_parity(cuts, top, batch, R, C, V, srn, init)
    assert int(h.cascades[:, 2].sum()) > 0
    vals = torch.cat([l.vals.flatten() for l in h.layers])
    assert bool(vals.isnan().any())


def test_parity_against_pallas_kernel_interpret():
    """The port's step against the reference's Pallas kernel itself, run in
    interpret mode as the reference's own tests run it."""
    cuts, top, batch, k = (8, 32), 256, 16, 2
    R, C, V = stream(4, (4, k, batch), SPACE)
    h, caps = jops.init_state(k, cuts, top, batch, js.PLUS_TIMES)
    step = jops.build_step(cuts, caps, js.PLUS_TIMES, donate=False, interpret=True)
    for t in range(R.shape[0]):
        h = step(h, jnp.asarray(R[t]), jnp.asarray(C[t]), jnp.asarray(V[t]))
    got = _run_port(cuts, top, batch, R, C, V, "plus.times")
    assert_hier_same(got, h, "pallas")


@pytest.mark.parametrize("srn", ["plus.times", "max.plus"])
def test_bfloat16_against_pallas_kernel_interpret(srn):
    """bfloat16 values, NaN and -0.0 in the batches: the port's step (its
    plain version on the CPU) against the reference's Pallas kernel in
    interpret mode.  bfloat16 NaNs compare as NaN (PyTorch's vectorized CPU
    rounding writes 0xFFFF where XLA writes 0x7FC0); every other bit,
    -0.0 turned +0.0 included, exactly."""
    cuts, top, batch, k = (8, 32), 256, 16, 2
    R, C, _ = stream(4, (4, k, batch), SPACE)
    V = special_values(np.random.default_rng(11), R.shape)
    sr_j = js.get(srn)
    h, caps = jops.init_state(k, cuts, top, batch, sr_j, dtype=jnp.bfloat16)
    step = jops.build_step(cuts, caps, sr_j, donate=False, interpret=True)
    for t in range(R.shape[0]):
        h = step(h, jnp.asarray(R[t]), jnp.asarray(C[t]), jnp.asarray(V[t], jnp.bfloat16))
    sr = ts.get(srn)
    got, caps_t = tops.init_state(k, cuts, top, batch, sr, torch.bfloat16, device="cpu")
    for t in range(R.shape[0]):
        got = tops.cascade_update(
            got, torch.tensor(R[t]), torch.tensor(C[t]), to_torch(V[t], torch.bfloat16), cuts, caps_t, sr
        )
    assert got.layers[0].vals.dtype == torch.bfloat16
    assert_hier_same(got, h, "pallas-bf16", same_vals=assert_same_but_nan_bits)
    vals = torch.cat([l.vals.flatten().float() for l in got.layers])
    assert bool(vals.isnan().any()) and int(got.cascades[:, 1].sum()) > 0


def test_batch_overflow_flag_lands_on_layer_one():
    """A flagged batch raises layer 1's overflow (the reference ORs the
    batch flag in before the step)."""
    sr = ts.PLUS_TIMES
    h, caps = tops.init_state(2, (8,), 64, 8, sr, device="cpu")
    r = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    batch = tops.canonical_batch(r, r, torch.ones(2, 8), sr)
    batch.overflow = torch.tensor([True, False])
    h = tops.cascade_step(h, batch, (8,), caps, sr)
    assert h.layers[0].overflow.tolist() == [True, False]


def test_kernel_rejects_unpadded_state():
    """Layer buffers narrower than their true caps are refused; buffers of
    exactly the true caps (no power-of-two padding) are the port's layout."""
    caps = th.telescoped_caps((8,), 100, 8)
    r = torch.zeros((2, 8), dtype=torch.int32)
    h = tm.init_packed(2, (8,), top_capacity=100, batch_size=8, device="cpu")
    assert [l.capacity for l in h.layers] == list(caps)
    h = tops.cascade_update(h, r, r, torch.ones((2, 8)), (8,), caps)
    assert h.layers[0].nnz.tolist() == [1, 1]
    narrow = tm.init_packed(2, (8,), top_capacity=90, batch_size=8, device="cpu")
    with pytest.raises(ValueError, match="cannot hold its cap"):
        tops.cascade_update(narrow, r, r, torch.ones((2, 8)), (8,), caps)


def test_kernel_refuses_cpu_tensors():
    """The launch path takes CUDA tensors only: CPU tensors raise before any
    launch (``cascade_step`` sends them to the plain version instead)."""
    sr = ts.PLUS_TIMES
    h, caps = tops.init_state(2, (8,), 64, 8, sr, torch.bfloat16, device="cpu")
    r = torch.zeros((2, 8), dtype=torch.int32)
    batch = tops.canonical_batch(r, r, torch.ones((2, 8), dtype=torch.bfloat16), sr)
    before = tops.launch_count
    with pytest.raises(ValueError, match="one CUDA device"):
        tops.cascade_step_kernel(*tm.flat_layer_state(h), batch, (8,), caps, sr)
    assert tops.launch_count == before


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without a compiler the kernel's build raises; nothing falls back."""

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("hier_cascade")


def test_build_target_names_sources_and_flags(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    target = _build._target("hier_cascade")
    assert target.parent == tmp_path and target.name.startswith("libhier_cascade-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_plain_step_counts_no_launch():
    before = tops.launch_count
    R, C, V = stream(5, (2, 2, 8), SPACE)
    _run_port((8,), 64, 8, R, C, V, "plus.times")
    assert tops.launch_count == before


def _plain_update(h, rows, cols, vals, cuts, caps, sr):
    """What ``cascade_update`` computes, through the plain version on any
    device: the reference the kernel is held to on the card."""
    batch = tops.canonical_batch(rows, cols, vals, sr)
    bufs, nnz, cascades, overflow = tm.flat_layer_state(h)
    overflow[:, 0] |= batch.overflow
    tops.cascade_step_plain(bufs, nnz, cascades, overflow, batch, cuts, caps, sr)
    return tm.from_flat_layer_state(bufs, nnz, cascades, overflow)


def test_plain_update_matches_wrapper_on_cpu():
    """The card test's reference is the wrapper's own CPU path."""
    sr, cuts, top, batch, k = ts.PLUS_TIMES, (8, 32), 256, 16, 3
    R, C, V = stream(10, (6, k, batch), SPACE)
    hw, caps = tops.init_state(k, cuts, top, batch, sr, device="cpu")
    hp, _ = tops.init_state(k, cuts, top, batch, sr, device="cpu")
    for t in range(R.shape[0]):
        args = [torch.tensor(x[t]) for x in (R, C, V)]
        hw = tops.cascade_update(hw, *args, cuts, caps, sr)
        hp = _plain_update(hp, *args, cuts, caps, sr)
    assert_hier_same(hw, hp, "plain")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    sr = ts.PLUS_TIMES
    cuts, top, batch, k = (8, 32), 256, 16, 8
    R, C, V = stream(6, (6, k, batch), SPACE)
    for dt in (torch.float32, torch.bfloat16):
        hk, caps = tops.init_state(k, cuts, top, batch, sr, dt, device="cuda")
        hp, _ = tops.init_state(k, cuts, top, batch, sr, dt, device="cuda")
        for t in range(R.shape[0]):
            r, c = (torch.tensor(x[t], device="cuda") for x in (R, C))
            v = torch.tensor(V[t], device="cuda").to(dt)
            hk = tops.cascade_update(hk, r, c, v, cuts, caps, sr)
            hp = _plain_update(hp, r, c, v, cuts, caps, sr)
        torch.cuda.synchronize()
        assert_hier_same(hk, hp, f"kernel {dt}")


def test_step_scratch_lives_with_its_state():
    """The kernel's merged-layer scratch is kept per state (keyed by its
    layer-1 rows buffer), remade when the shape or value type changes, and
    freed with the state."""
    h, caps = tops.init_state(2, (8,), 64, 8, ts.PLUS_TIMES, device="cpu")
    rows0 = h.layers[0].rows
    s = tops._state_scratch(rows0, 2, max(caps), torch.float32)
    assert [tuple(t.shape) for t in s] == [(2, max(caps))] * 3 + [(2, 2)]
    assert tops._state_scratch(rows0, 2, max(caps), torch.float32) is s
    b = tops._state_scratch(rows0, 2, max(caps), torch.bfloat16)
    assert b is not s and b[2].dtype == torch.bfloat16
    n = len(tops._scratch)
    del h, rows0
    assert len(tops._scratch) == n - 1
