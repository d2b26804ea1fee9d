"""The port's ``sort_dedup`` wrappers against the JAX reference, on the CPU,
and the fold bracketing that the CUDA kernel implements.

On CPU tensors ``from_triples`` and ``combine_sorted`` run their plain
versions; the CUDA kernel is held to those bit for bit on the card by
``chip_smoke.py``.  Here:

* against the oracle, JAX ``assoc.from_triples`` (and ``_combine_sorted``):
  bit for bit, values included;
* against the TPU kernel, JAX ``sort_ops.from_triples`` (Pallas in interpret
  mode, as ``tests/kernels/test_kernels.py`` runs it): equal keys and nnz,
  values at ``rtol=1e-5``, the JAX tests' own tolerance.  The TPU kernel
  folds each run in the order of a bitonic sort plus a Hillis-Steele scan,
  not in the oracle's associative-scan order, so float sums differ in the
  last bits;
* :func:`run_value`, a numpy model of the kernel's per-run fold (the same
  loops as ``csrc/sort_dedup.cu`` ``node_fold``/``run_value``), against the
  port's ``_scan`` on random runs, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assoc as jas
from repro.core import semiring as js
from repro.kernels.sort_dedup import ops as sort_ops
from repro_torch import kernels
from repro_torch.core import assoc as tas
from repro_torch.core import semiring as ts
from repro_torch.kernels.sort_dedup import ops as tops

from _torch_parity import assert_assoc_same, special_values, stream

torch.set_num_threads(1)

SEMIRINGS = ["plus.times", "max.plus", "min.plus", "union.first"]

_jax_from_triples = jax.jit(jas.from_triples, static_argnames=("cap", "sr"))
_jax_combine = jax.jit(jas._combine_sorted, static_argnames=("cap", "sr"))


# ---------------------------------------------------------------------------
# the kernel's fold, modelled in numpy
# ---------------------------------------------------------------------------

def node_fold(x, L, i, s, add):
    """node(L, i): the pair-tree fold of x over [i 2^L, (i+1) 2^L - 1] cut
    to the part at or after s, by a binary counter with a stack."""
    stack = []
    j = max(i << L, s)
    while True:
        cur, h, at = x[j], 0, j
        while h < L and at & 1:
            if (at << h) - 1 >= s:  # the left sibling reaches into the run
                cur = add(stack.pop(), cur)
            at >>= 1
            h += 1
        if h == L:
            assert j == ((i + 1) << L) - 1
            return cur
        stack.append(cur)
        j += 1


def run_value(x, s, e, add):
    """The scan's value at the end e of the run [s, e], before "+ 0.0"."""
    nodes, L, i = [], 0, e
    while i != 0:
        if i & 1:
            i = (i - 1) >> 1
        elif (i << L) > s:
            nodes.append((L, i))
            i = (i >> 1) - 1
        else:
            break
        L += 1
    acc = node_fold(x, L, i, s, add)
    for level, k in reversed(nodes):
        acc = add(acc, node_fold(x, level, k, s, add))
    return acc


_NP_ADD = {
    "plus.times": lambda a, b: np.float32(a) + np.float32(b),
    "max.plus": lambda a, b: a if (a != a or a > b) else b,
    "min.plus": lambda a, b: a if (a != a or a < b) else b,
    "union.first": lambda a, b: a,
}


@pytest.mark.parametrize("srn", SEMIRINGS)
def test_run_bracketing_model_matches_scan(srn):
    """Lengths 1-400, runs up to the whole array, -0.0 and NaN mixed in."""
    rng = np.random.default_rng(len(srn))
    add = _NP_ADD[srn]
    for trial in range(60):
        n = int(rng.integers(1, 401))
        keys = np.sort(rng.integers(0, max(1, n // int(rng.integers(1, 40))), n))
        if trial % 6 == 0:
            keys[:] = 7  # one run over everything
        x = special_values(rng, (n,)) if trial % 2 else rng.normal(size=n).astype(np.float32)
        _, acc = tas._scan(torch.tensor(keys), torch.tensor(x), ts.get(srn))
        acc = acc.numpy()
        for e in np.nonzero(np.append(keys[1:] != keys[:-1], True))[0]:
            s = e
            while s > 0 and keys[s - 1] == keys[e]:
                s -= 1
            with np.errstate(invalid="ignore"):
                v = np.float32(run_value(x, s, e, add))
                if n >= 2:
                    v = v + np.float32(0.0)
            assert v.view(np.int32) == acc[e].view(np.int32), (trial, n, s, e)


# ---------------------------------------------------------------------------
# the wrappers against the reference
# ---------------------------------------------------------------------------

def _both(r, c, v, cap, srn, valid=None):
    j = _jax_from_triples(
        jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), cap=cap, sr=js.get(srn),
        valid=None if valid is None else jnp.asarray(valid),
    )
    t = tops.from_triples(
        torch.tensor(r), torch.tensor(c), torch.tensor(v), cap, ts.get(srn),
        None if valid is None else torch.tensor(valid),
    )
    return j, t


@pytest.mark.parametrize("srn", SEMIRINGS)
@pytest.mark.parametrize("n", [1, 2, 100, 333])
def test_from_triples_matches_oracle(n, srn):
    """Long runs (keys from a 6x3 space), NaN and -0.0, a valid mask, and a
    cap below the distinct count."""
    r, c, v = stream(n, (n,), 6)
    c = c % 3
    v = special_values(np.random.default_rng(n), (n,))
    valid = np.random.default_rng(n + 1).random(n) < 0.8
    for cap, mask in ((n, None), (max(1, n // 8), valid)):
        j, t = _both(r, c, v, cap, srn, mask)
        assert_assoc_same(t, j, f"cap={cap}")


def test_from_triples_batch_axes():
    """[2, 3] batch of 64 triples: each group equals the reference's
    unbatched from_triples."""
    r, c, v = stream(5, (2, 3, 64), 5)
    got = tops.from_triples(torch.tensor(r), torch.tensor(c), torch.tensor(v), 40)
    for i in range(2):
        for k in range(3):
            want = _jax_from_triples(jnp.asarray(r[i, k]), jnp.asarray(c[i, k]), jnp.asarray(v[i, k]), cap=40)
            one = tas.Assoc(got.rows[i, k], got.cols[i, k], got.vals[i, k], got.nnz[i, k], got.overflow[i, k])
            assert_assoc_same(one, want, (i, k))


def test_from_triples_one_run_and_bfloat16():
    """All keys equal (one run of 256), float32 and integer-valued
    bfloat16."""
    n = 256
    r = np.zeros(n, np.int32)
    v = np.random.default_rng(3).normal(size=n).astype(np.float32)
    j, t = _both(r, r, v, 4, "plus.times")
    assert_assoc_same(t, j)
    assert int(t.nnz) == 1
    vi = np.random.default_rng(4).integers(-3, 4, n).astype(np.float32)
    j = _jax_from_triples(jnp.asarray(r), jnp.asarray(r), jnp.asarray(vi, jnp.bfloat16), cap=4)
    t = tops.from_triples(torch.tensor(r), torch.tensor(r), torch.tensor(vi).to(torch.bfloat16), 4)
    assert t.vals.dtype == torch.bfloat16
    assert_assoc_same(
        tas.Assoc(t.rows, t.cols, t.vals.float(), t.nnz, t.overflow),
        jas.Assoc(j.rows, j.cols, j.vals.astype(jnp.float32), j.nnz, j.overflow),
    )


@pytest.mark.parametrize("srn", ["plus.times", "max.plus"])
def test_combine_sorted_matches_oracle(srn):
    """The fold stage alone: sorted triples with runs, degree keys (row, 0),
    and sorted unique keys with PAD holes (what elem_mul and extract_row
    give)."""
    rng = np.random.default_rng(9)
    n = 200
    keys = np.sort(rng.integers(0, 60, n))
    r, c = (keys // 6).astype(np.int32), (keys % 6).astype(np.int32)
    v = special_values(rng, (n,))
    holes = rng.random(n) < 0.3
    uniq = np.unique(keys)
    ur = np.full(n, tas.PAD, np.int32)
    uc = np.full(n, tas.PAD, np.int32)
    ur[: uniq.size], uc[: uniq.size] = uniq // 6, uniq % 6
    cases = {
        "sorted": (r, c),
        "degrees": (r, np.zeros_like(c)),
        "holes": (np.where(holes, tas.PAD, ur).astype(np.int32), np.where(holes, tas.PAD, uc).astype(np.int32)),
    }
    for name, (rr, cc) in cases.items():
        for cap in (n, 16):
            want = _jax_combine(jnp.asarray(rr), jnp.asarray(cc), jnp.asarray(v), cap=cap, sr=js.get(srn))
            got = tops.combine_sorted(torch.tensor(rr), torch.tensor(cc), torch.tensor(v), cap, ts.get(srn))
            assert_assoc_same(got, want, f"{name} cap={cap}")


@pytest.mark.parametrize("srn", ["plus.times", "max.plus"])
def test_from_triples_against_tpu_kernel(srn):
    """The Pallas kernel in interpret mode: the same keys and nnz, values at
    rtol=1e-5 (another fold order; see the module docstring)."""
    n = 256
    rng = np.random.default_rng(11)
    r = rng.integers(0, 4, n).astype(np.int32)
    c = rng.integers(0, 4, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    want = sort_ops.from_triples(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), cap=n, sr=js.get(srn))
    got = tops.from_triples(torch.tensor(r), torch.tensor(c), torch.tensor(v), n, ts.get(srn))
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals), rtol=1e-5)
    assert int(got.nnz) == int(want.nnz)


def test_dispatch_and_plain_versions_switch(monkeypatch):
    """``assoc.from_triples`` and ``assoc._combine_sorted`` reach the
    wrapper unless ``plain_versions()`` is active."""
    r, c, v = (torch.tensor(x) for x in stream(12, (50,), 5))
    calls = []
    monkeypatch.setattr(tops, "from_triples", lambda *a: calls.append("ft") or tas.from_triples_plain(*a))
    monkeypatch.setattr(tops, "combine_sorted", lambda *a: calls.append("cs") or tas.combine_sorted_plain(*a))
    a = tas.from_triples(r, c, v, 50)
    tas.reduce_rows(a)
    assert calls == ["ft", "cs"]
    with kernels.plain_versions():
        tas.from_triples(r, c, v, 50)
        tas.reduce_rows(a)
    assert calls == ["ft", "cs"]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sort_dedup kernel runs on the card only")
    for srn in SEMIRINGS:
        sr = ts.get(srn)
        r, c, v = (torch.tensor(x, device="cuda") for x in stream(13, (2, 5000), 30))
        got = tops.from_triples(r, c, v, 3000, sr)
        want = tas.from_triples_plain(r, c, v, 3000, sr)
        for f in ("rows", "cols", "vals", "nnz", "overflow"):
            g, w = getattr(got, f).cpu(), getattr(want, f).cpu()
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w), (srn, f)
