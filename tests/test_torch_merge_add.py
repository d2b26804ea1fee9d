"""The port's ``merge_add`` wrapper against the JAX reference, on the CPU.

On CPU tensors the wrapper runs its plain version (``assoc.add_plain``);
the CUDA kernel is held to that plain version bit for bit on the card by
``chip_smoke.py``.  Here:

* against the oracle, JAX ``assoc.add``: bit for bit, values included;
* against the TPU kernel, JAX ``merge_ops.merge_add`` (Pallas in interpret
  mode, as ``tests/kernels/test_kernels.py`` runs it): equal keys and nnz,
  values at ``rtol=1e-5``, the JAX tests' own tolerance.  The values are not
  bit-identical for two reasons: the TPU kernel folds duplicate keys in
  another order than the oracle's associative scan (a Hillis-Steele combine
  after a bitonic merge), and it keeps ``-0.0`` on entries that have no
  partner, where the oracle's scan interleave writes ``+0.0``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assoc as jas
from repro.core import semiring as js
from repro.kernels.merge_add import ops as merge_ops
from repro_torch import kernels
from repro_torch.core import assoc as tas
from repro_torch.core import semiring as ts
from repro_torch.kernels import _launch
from repro_torch.kernels.merge_add import ops as tops

from _torch_parity import assert_assoc_same, special_values, stream

torch.set_num_threads(1)

SEMIRINGS = ["plus.times", "max.plus", "min.plus", "union.first"]
SPACE = 9

_jax_from_triples = jax.jit(jas.from_triples, static_argnames=("cap", "sr"))
_jax_add = jax.jit(jas.add, static_argnames=("cap", "sr"))


def _pair(r, c, v, cap, srn):
    """One array in both packages, each built by its own from_triples."""
    j = _jax_from_triples(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), cap=cap, sr=js.get(srn))
    t = tas.from_triples(torch.tensor(r), torch.tensor(c), torch.tensor(v), cap=cap, sr=ts.get(srn))
    return j, t


def _both(seed, n, srn, special=False):
    r, c, v = stream(seed, (n,), SPACE)
    if special:
        v = special_values(np.random.default_rng(seed), (n,))
    return _pair(r, c, v, n, srn)


@pytest.mark.parametrize("srn", SEMIRINGS)
@pytest.mark.parametrize("special", [False, True], ids=["normal", "nan-negzero"])
def test_merge_add_matches_oracle(srn, special):
    """Caps above and below the union, NaN and -0.0 in both inputs."""
    ja1, ta1 = _both(20, 40, srn, special)
    ja2, ta2 = _both(21, 24, srn, special)
    for cap in (None, 10, 64):
        want = _jax_add(ja1, ja2, cap=cap, sr=js.get(srn))
        got = tops.merge_add(ta1, ta2, cap, ts.get(srn))
        assert_assoc_same(got, want, f"cap={cap}")
        if cap == 10:
            assert bool(got.overflow)


def test_merge_add_empty_inputs():
    ja, ta = _both(22, 16, "plus.times")
    jz, tz = jas.empty(16), tas.empty(16, device="cpu")
    for x, y, u, w in ((ta, tz, ja, jz), (tz, ta, jz, ja), (tz, tz, jz, jz)):
        assert_assoc_same(tops.merge_add(x, y, 32), _jax_add(u, w, cap=32), "empty")


def test_merge_add_width_zero_and_one():
    """Widths the reference cannot trace (a width-0 side): m + n = 1 runs no
    scan level, so -0.0 stays, as the oracle's ``_scan`` leaves a length-1
    input; m + n = 2 turns it into +0.0."""
    one = tas.from_triples(torch.tensor([2], dtype=torch.int32), torch.tensor([3], dtype=torch.int32),
                           torch.tensor([-0.0]), 1)
    none = tas.empty(0, device="cpu")
    got = tops.merge_add(one, none, 1)
    assert got.rows.tolist() == [2] and int(got.nnz) == 1 and np.signbit(got.vals.numpy()[0])
    got = tops.merge_add(none, one, 3)
    assert got.rows.tolist() == [2, tas.PAD, tas.PAD] and np.signbit(got.vals.numpy()[0])
    got = tops.merge_add(one, tas.empty(1, device="cpu"), 2)
    assert not np.signbit(got.vals.numpy()[0])
    got = tops.merge_add(none, none, 2)
    assert got.rows.tolist() == [tas.PAD, tas.PAD] and int(got.nnz) == 0


def test_merge_add_batch_axes_and_overflow_flags():
    """A [3, 2] batch: each group equals the reference's unbatched add, and
    the input overflow flags OR into the result."""
    srn = "max.plus"
    ja = [_both(30 + k, 32, srn, special=k % 2 == 1)[0] for k in range(6)]
    jb = [_both(40 + k, 24, srn)[0] for k in range(6)]
    ja[4] = dataclasses.replace(ja[4], overflow=jnp.bool_(True))

    def stack(xs):
        return tas.Assoc(*(
            torch.tensor(np.stack([np.asarray(getattr(x, f)) for x in xs])).reshape(
                (3, 2) + np.asarray(getattr(xs[0], f)).shape)
            for f in ("rows", "cols", "vals", "nnz", "overflow")
        ))

    got = tops.merge_add(stack(ja), stack(jb), 40, ts.get(srn))
    for k in range(6):
        i, j = divmod(k, 2)
        one = tas.Assoc(got.rows[i, j], got.cols[i, j], got.vals[i, j], got.nnz[i, j], got.overflow[i, j])
        assert_assoc_same(one, _jax_add(ja[k], jb[k], cap=40, sr=js.get(srn)), f"group {k}")
    assert bool(got.overflow[2, 0])


def test_merge_add_bfloat16_matches_oracle():
    """bfloat16 on integer-valued weights (exact in both packages)."""
    rng = np.random.default_rng(5)
    jx, tx = [], []
    for n in (40, 24):
        r = rng.integers(0, SPACE, n).astype(np.int32)
        c = rng.integers(0, SPACE, n).astype(np.int32)
        v = rng.integers(-4, 5, n).astype(np.float32)
        j = _jax_from_triples(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v, jnp.bfloat16), cap=n)
        t = tas.from_triples(torch.tensor(r), torch.tensor(c), torch.tensor(v).to(torch.bfloat16), cap=n)
        assert_assoc_same(
            tas.Assoc(t.rows, t.cols, t.vals.float(), t.nnz, t.overflow),
            jas.Assoc(j.rows, j.cols, j.vals.astype(jnp.float32), j.nnz, j.overflow),
        )
        jx.append(j)
        tx.append(t)
    got = tops.merge_add(tx[0], tx[1], 48)
    want = _jax_add(jx[0], jx[1], cap=48)
    assert got.vals.dtype == torch.bfloat16
    assert_assoc_same(
        tas.Assoc(got.rows, got.cols, got.vals.float(), got.nnz, got.overflow),
        jas.Assoc(want.rows, want.cols, want.vals.astype(jnp.float32), want.nnz, want.overflow),
    )


@pytest.mark.parametrize("srn", ["plus.times", "max.plus"])
def test_merge_add_against_tpu_kernel(srn):
    """The Pallas kernel in interpret mode: the same keys and nnz, values at
    rtol=1e-5 (fold order and -0.0 on unmatched entries differ; see the
    module docstring)."""
    sr = js.get(srn)
    ja1, ta1 = _both(50, 40, srn)
    ja2, ta2 = _both(51, 24, srn)
    want = merge_ops.merge_add(ja1, ja2, cap=64, sr=sr)
    got = tops.merge_add(ta1, ta2, 64, ts.get(srn))
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals), rtol=1e-5)
    assert int(got.nnz) == int(want.nnz)


def test_dispatch_and_plain_versions_switch(monkeypatch):
    """``assoc.add`` reaches the wrapper unless ``plain_versions()`` is
    active; a CPU tensor takes the plain version either way."""
    _, ta1 = _both(60, 40, "plus.times")
    _, ta2 = _both(61, 24, "plus.times")
    calls = []
    monkeypatch.setattr(tops, "merge_add", lambda *a, **k: calls.append(1) or tas.add_plain(*a, **k))
    tas.add(ta1, ta2)
    assert calls == [1]
    with kernels.plain_versions():
        assert kernels.plain_active()
        tas.add(ta1, ta2)
    assert calls == [1] and not kernels.plain_active()
    before = tops.launch_count
    assert_assoc_same(tops.merge_add(ta1, ta2, 32), tas.add_plain(ta1, ta2, 32))
    assert tops.launch_count == before  # the plain version launches nothing


def test_kernel_refuses_what_it_does_not_take():
    with pytest.raises(NotImplementedError, match="float32, bfloat16, int32, float16"):
        _launch.dtype_code(torch.zeros(2, dtype=torch.float64), "merge_add")
    with pytest.raises(ValueError, match="one CUDA device"):
        tops.merge_add_kernel(
            tas.empty(4, device="cpu"), tas.empty(4, device="cpu"), None, ts.PLUS_TIMES
        )


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the merge_add kernel runs on the card only")
    for srn in SEMIRINGS:
        sr = ts.get(srn)
        r, c, v = (torch.tensor(x, device="cuda") for x in stream(70, (2, 300), 40))
        a = tas.from_triples_plain(r, c, v, 300, sr)
        r, c, v = (torch.tensor(x, device="cuda") for x in stream(71, (2, 200), 40))
        b = tas.from_triples_plain(r, c, v, 200, sr)
        def cpu(x):
            return tas.Assoc(x.rows.cpu(), x.cols.cpu(), x.vals.cpu(), x.nnz.cpu(), x.overflow.cpu())

        for cap in (None, 100):
            assert_assoc_same(cpu(tops.merge_add(a, b, cap, sr)), cpu(tas.add_plain(a, b, cap, sr)), (srn, cap))


def test_merge_scratch_is_kept_and_grown(monkeypatch):
    """The merge kernels' tile scratch: one per device and stream, kept
    between calls, grown when a merge needs more; its finish counters are
    zeroed when made (the count pass leaves them zero), and the regions
    (offsets, splits, counts) follow one another without overlap."""
    monkeypatch.setattr(_launch, "_merge_scratch", {})
    monkeypatch.setattr(_launch, "index", lambda dev: 0)
    monkeypatch.setattr(_launch, "stream", lambda dev: 7)
    cpu = torch.device("cpu")
    splits, counts, offsets, done = _launch.merge_scratch(cpu, 3, 5)
    assert (splits - offsets, counts - splits) == (8 * 3 * 5, 8 * 3 * 6)
    work, zeros = _launch._merge_scratch[(0, 7)]
    assert work.numel() * 4 >= counts - offsets + 4 * 3 * 5 and zeros.tolist() == [0, 0, 0]
    assert done == zeros.data_ptr() and offsets == work.data_ptr()
    assert _launch.merge_scratch(cpu, 2, 4)[3] == done  # smaller: the same scratch
    _launch.merge_scratch(cpu, 4, 40)
    work, zeros = _launch._merge_scratch[(0, 7)]
    assert work.numel() == 2 * 160 + 2 * 164 + 160 and zeros.tolist() == [0] * 4
    monkeypatch.setattr(_launch, "stream", lambda dev: 8)
    _launch.merge_scratch(cpu, 1, 1)
    assert len(_launch._merge_scratch) == 2  # one per stream
