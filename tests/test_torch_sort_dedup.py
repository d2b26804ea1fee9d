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
* :func:`run_value`, a numpy model of the per-run fold of the first CUDA
  kernel (``node_fold``/``run_value``), against the port's ``_scan`` on
  random runs, bit for bit;
* numpy models of the kernel's passes at tiles of 8 and 16 entries
  (:func:`fold_model`, :func:`sort_model`; see their section): the fold
  against ``_scan`` and ``run_value``, the sort against numpy's stable
  lexsort, both together against ``from_triples_plain``.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import assoc as jas
from repro.core import semiring as js
from repro.kernels.sort_dedup import ops as sort_ops
from repro_torch import kernels
from repro_torch.core import assoc as tas
from repro_torch.core import semiring as ts
from repro_torch.kernels import _launch
from repro_torch.kernels.sort_dedup import ops as tops

from _torch_parity import PAD, assert_assoc_same, np_of, special_values, stream, to_torch

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
# the kernel's passes (csrc/sort_dedup.cu), modelled in numpy at small tiles
# ---------------------------------------------------------------------------
#
# The fold: a run's value is the left fold, in position order, of the
# aligned blocks of the pair tree that tile the run greedily from its start
# (``pieces``), each block a plain pair-tree fold ("node").  Pass A builds
# each tile's tree, counts its live run ends, records its last run start,
# the fold of its last run's part in the tile (R) and its root; the roots
# build the tree over tiles; the group's last tile scans the counts into
# offsets and the run starts into each tile's carry (s_prev).  Pass C folds
# each run end from its tile's tree, from R and the tiles' tree for a run
# that began in an earlier tile.
#
# The sort: each tile sorts its live keys on the bits that vary among them
# (dead keys last, then dropped), then merge rounds merge the live prefixes
# of run pairs by merge-path tiles split on diagonals, left run first on
# equal keys.

MASK32 = 0xFFFFFFFF


def piece_level(p, e):
    """The level of the largest aligned block that starts at p and ends at
    or before e (``sort_dedup.cu`` piece_level)."""
    align = (p & -p).bit_length() - 1 if p else 62
    return min(align, (e - p + 1).bit_length() - 1)


def fold_pieces(acc, nodes, s, e, add):
    """Left fold onto ``acc`` (None: nothing yet) of the blocks that tile
    [s, e] greedily from s; ``nodes[L][i]`` is block (L, i)."""
    p = s
    while p <= e:
        L = piece_level(p, e)
        v = nodes[L][p >> L]
        acc = v if acc is None else add(acc, v)
        p += 1 << L
    return acc


def fold_model(keys, rows, x, length, tile, add, zero):
    """The fold passes over one group: keys (int64 packed), rows (for the
    PAD test) and values x, positions [0, length) present.  Returns the
    value before "+ 0.0" of every live run end, in order, and the tiles'
    output offsets."""
    n = len(keys)
    lg = tile.bit_length() - 1
    tpf = max(1, -(-n // tile))

    def is_start(j):
        return j < length and (j == 0 or keys[j - 1] != keys[j])

    def is_end(j):
        return j < length and (j + 1 == length or keys[j + 1] != keys[j]) and rows[j] != PAD

    trees, counts, last, R = [], [], [], []
    for t in range(tpf):  # pass A
        lo = t * tile
        tree = [[x[j] if j < length else zero for j in range(lo, lo + tile)]]
        for _ in range(lg):
            p = tree[-1]
            tree.append([add(p[2 * i], p[2 * i + 1]) for i in range(len(p) // 2)])
        trees.append(tree)
        starts = [j for j in range(lo, lo + tile) if is_start(j)]
        counts.append(sum(is_end(j) for j in range(lo, lo + tile)))
        last.append(max(starts) if starts else -1)
        R.append(fold_pieces(None, tree, last[-1] - lo if starts else 0, tile - 1, add))
    tt = [[tree[lg][0] for tree in trees]]  # the tiles' tree, complete nodes
    while len(tt[-1]) >= 2:
        p = tt[-1]
        tt.append([add(p[2 * i], p[2 * i + 1]) for i in range(len(p) // 2)])
    offsets = [sum(counts[:t]) for t in range(tpf)]  # the last tile's scans
    s_prev = [max([-1] + last[:t]) for t in range(tpf)]

    def through(s, b):
        """The fold of [s, the end of tile b], for s in an earlier tile."""
        ts = s // tile
        acc, a = (R[ts], ts + 1) if s % tile else (None, ts)
        return fold_pieces(acc, tt, a, b, add)

    ends, vals = [], []
    for t in range(tpf):  # pass C
        lo = t * tile
        carry = s_prev[t]
        for j in range(lo, lo + tile):
            if is_start(j):
                carry = j
            if not is_end(j):
                continue
            if carry >= lo:
                v = fold_pieces(None, trees[t], carry - lo, j - lo, add)
            elif j == lo + tile - 1:
                v = through(carry, t)  # END: the whole tile continues a run
            else:
                v = fold_pieces(through(carry, t - 1), trees[t], 0, j - lo, add)  # IN
            assert offsets[t] + sum(is_end(q) for q in range(lo, j)) == len(ends)
            ends.append(j)
            vals.append(v)
    return ends, vals


def _scan_ends(keys, x, srn, dtype=torch.float32):
    """The plain version's scan and its live run ends."""
    _, acc = tas._scan(torch.tensor(keys), to_torch(x, dtype), ts.get(srn))
    return np_of(acc)


_BF16_ADD = lambda a, b: ml_dtypes.bfloat16(np.float32(a) + np.float32(b))  # noqa: E731


def fold_keys(rng, n, tile, kind):
    """Sorted int64 keys (packed (row, col)) with runs that cross 0, 1 and
    many tile edges, a run over everything, runs starting at every offset
    in a tile, or PAD holes between unique keys; and their rows."""
    if kind == "whole":
        r = np.full(n, 3, np.int64)
    elif kind == "long":  # long runs at random offsets, a few short ones
        cuts = np.sort(rng.choice(np.arange(1, n), size=min(n - 1, 6), replace=False))
        r = np.searchsorted(cuts, np.arange(n), side="right").astype(np.int64)
    elif kind == "offsets":  # a run of 1, 2 or ~25 tiles from every offset
        lens = [o for o in range(1, tile + 1)] + [tile + 1, 2 * tile + 3, 25 * tile + 5]
        r = np.concatenate([np.repeat(np.arange(len(lens)), lens), len(lens) + np.arange(n)])[:n].astype(np.int64)
    elif kind == "holes":
        r = np.arange(n, dtype=np.int64)
        r[rng.random(n) < 0.3] = PAD
    else:  # "random": short and long runs mixed
        r = np.sort(rng.integers(0, max(1, n // int(rng.integers(1, 40))), n)).astype(np.int64)
    c = np.where(r == PAD, PAD, 0)
    return r * 2**32 + (c + 2**31), r


FOLD_KINDS = ["random", "long", "offsets", "whole", "holes"]


@pytest.mark.parametrize("srn", SEMIRINGS)
@pytest.mark.parametrize("tile", [8, 16])
def test_fold_model_matches_scan(tile, srn):
    """The fold passes, bit for bit against the plain version's scan at
    every live run end: runs across 0, 1 and many tile edges, from every
    offset in a tile, over the whole input, PAD holes, n not a power of
    two, NaN and -0.0, and a present prefix shorter than the input (the
    sort's dead suffix: garbage keys after it)."""
    rng = np.random.default_rng(tile * 7 + len(srn))
    add = _NP_ADD[srn]
    for trial in range(25):
        kind = FOLD_KINDS[trial % len(FOLD_KINDS)]
        n = int(rng.integers(1, 401)) if trial % 4 else 27 * tile + 9 + trial
        keys, rows = fold_keys(rng, n, tile, kind)
        x = special_values(rng, (n,)) if trial % 2 else rng.normal(size=n).astype(np.float32)
        length = n if trial % 3 else int(rng.integers(0, n + 1))
        plain = keys.copy()
        plain[length:] = PAD * 2**32 + (PAD + 2**31)
        prow = np.where(np.arange(n) < length, rows, PAD)
        junk = keys.copy()
        junk[length:] = rng.integers(0, 2**40, n - length)  # never read
        with np.errstate(invalid="ignore"):
            ends, vals = fold_model(junk, prow, x, length, tile, add, np.float32(0))
            acc = _scan_ends(plain, x, srn)
        want = np.nonzero(np.append(plain[1:] != plain[:-1], True) & (prow != PAD))[0]
        assert ends == want.tolist(), (trial, kind)
        with np.errstate(invalid="ignore"):
            got = np.array([np.float32(v) + np.float32(0) if n >= 2 else v for v in vals], np.float32)
        np.testing.assert_array_equal(got.view(np.int32), acc[want].view(np.int32), err_msg=f"{trial} {kind}")


def test_fold_model_bfloat16():
    """The same passes in bfloat16 (each fold rounds to bfloat16), -0.0
    included, against the plain version's bfloat16 scan."""
    rng = np.random.default_rng(5)
    for trial, kind in enumerate(FOLD_KINDS * 2):
        n = int(rng.integers(2, 400))
        keys, rows = fold_keys(rng, n, 8, kind)
        x = rng.normal(size=n).astype(np.float32)
        x[rng.random(n) < 0.2] = -0.0
        xb = x.astype(ml_dtypes.bfloat16)
        ends, vals = fold_model(keys, rows, xb, n, 8, _BF16_ADD, ml_dtypes.bfloat16(0))
        acc = _scan_ends(keys, xb, "plus.times", torch.bfloat16)
        got = np.array([_BF16_ADD(v, 0) for v in vals], ml_dtypes.bfloat16)
        np.testing.assert_array_equal(got.view(np.int16), acc[ends].view(np.int16), err_msg=kind)


def test_pieces_fold_is_run_value():
    """The greedy blocks' left fold is the scan's bracketing of
    ``run_value`` (the kernel before this design), on every run [s, e]."""
    rng = np.random.default_rng(8)
    for srn in SEMIRINGS:
        add = _NP_ADD[srn]
        x = special_values(rng, (130,))
        tree = [list(x)]
        while len(tree[-1]) >= 2:
            p = tree[-1]
            tree.append([add(p[2 * i], p[2 * i + 1]) for i in range(len(p) // 2)])
        for s in range(0, 128):
            for e in range(s, 128):
                with np.errstate(invalid="ignore"):
                    a, b = np.float32(fold_pieces(None, tree, s, e, add)), np.float32(run_value(x, s, e, add))
                assert a.view(np.int32) == b.view(np.int32), (srn, s, e)


def sort_bits(hi, lo, live):
    """The tile sort's key on the bits that vary among the tile's live keys
    (row and col words apart, row above), dead keys after every live one
    (one bit more where the tile has a dead slot); returns the keys, the
    bits the radix sort looks at and the inverse."""
    lh, ll = [h for h, v in zip(hi, live) if v], [l for l, v in zip(lo, live) if v]
    and_h, and_l = functools.reduce(lambda a, b: a & b, lh), functools.reduce(lambda a, b: a & b, ll)
    or_h, or_l = functools.reduce(lambda a, b: a | b, lh), functools.reduce(lambda a, b: a | b, ll)
    br, bc = (and_h ^ or_h).bit_length(), (and_l ^ or_l).bit_length()
    mr, mc = (1 << br) - 1, (1 << bc) - 1
    end = br + bc
    dead = 1 << end if end < 64 else 2**64 - 1
    comp = [((h & mr) << bc) | (l & mc) if v else dead for h, l, v in zip(hi, lo, live)]

    def full(k):
        return ((and_h & ~mr & MASK32) | ((k >> bc) & mr)) << 32 | (and_l & ~mc & MASK32) | (k & mc)

    return comp, end + 1 if not all(live) and end < 64 else end, full


def stable_split(a, b, d, lanes):
    """``stable_warp_split``: the split of diagonal d of the left-first
    merged order, ``lanes`` probes a round, no pair rule."""
    lo, hi = max(0, d - len(b)), min(d, len(a))

    def probe(x):
        return x < hi and a[x] <= b[d - 1 - x]

    while hi - lo > lanes:
        step = -(-(hi - lo) // lanes)
        c = sum(probe(lo + lane * step) for lane in range(lanes))
        if c == 0:
            hi = lo
        else:
            top = lo + c * step
            lo += (c - 1) * step + 1
            hi = min(top, hi)
    i = lo + sum(probe(lo + lane) for lane in range(lanes))
    return i, d - i


def local_stable_split(a, b, d):
    """The in-tile split of ``stable_merge_tile`` (a binary search)."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo, d - lo


def sort_model(rows, cols, valid, tile, threads=2, items=2, lanes=4):
    """The sort of one group: the tile sort, then merge rounds of merge
    tiles of ``threads * items`` diagonals.  Returns the sorted live keys
    (the sort's uint64 key), the input index of each (the kernel carries
    that entry's value bits instead), and their count."""
    n = len(rows)
    hi = [(int(r) ^ 0x80000000) & MASK32 for r in rows]
    lo = [(int(c) ^ 0x80000000) & MASK32 for c in cols]
    live = [bool(v) and int(r) != PAD for r, v in zip(rows, valid)]
    keys, idx = [None] * n, [None] * n
    cnt = []
    for t0 in range(0, n, tile):  # the tile sort
        sl = range(t0, min(t0 + tile, n))
        m = sum(live[j] for j in sl)
        cnt.append(m)
        if m == 0:
            continue  # the block exits after its reduction
        comp, bits, full = sort_bits([hi[j] for j in sl], [lo[j] for j in sl],
                                     [live[j] for j in sl] + [False] * (t0 + tile - n))
        assert max(comp) < 2**bits
        order = sorted(range(len(comp)), key=lambda q: comp[q])  # stable, as the block radix sort
        for rank, q in enumerate(order[:m]):
            keys[t0 + rank], idx[t0 + rank] = full(comp[q]), t0 + q
    mtile = threads * items
    w = tile
    while w < n:  # merge rounds
        ok, oi, oc = [None] * n, [None] * n, [0] * len(cnt)
        for d0 in range(0, n, mtile):
            p, base = d0 // (2 * w), d0 // (2 * w) * 2 * w
            dd = d0 - base
            la = cnt[2 * p]
            lb = cnt[2 * p + 1] if (2 * p + 1) * w < n else 0
            if dd == 0:
                oc[p] = la + lb
            if dd >= la + lb:
                continue
            A, B = keys[base:base + la], keys[base + w:base + w + lb]
            (i0, j0), (i1, j1) = stable_split(A, B, dd, lanes), stable_split(A, B, min(dd + mtile, la + lb), lanes)
            a, b = A[i0:i1], B[j0:j1]
            ai, bi = idx[base + i0:base + i1], idx[base + w + j0:base + w + j1]
            splits = [local_stable_split(a, b, min(t * items, len(a) + len(b))) for t in range(threads)]
            splits.append((len(a), len(b)))
            for t in range(threads):
                (x, y), (ex, ey) = splits[t], splits[t + 1]
                for q in range(items):
                    if x < ex or y < ey:
                        take_a = x < ex and (y >= ey or a[x] <= b[y])
                        at = base + dd + t * items + q
                        ok[at], oi[at] = (a[x], ai[x]) if take_a else (b[y], bi[y])
                        x, y = x + take_a, y + (not take_a)
                assert (x, y) == (ex, ey)
        keys, idx, cnt = ok, oi, oc
        w *= 2
    m = cnt[0] if cnt else 0
    return keys[:m], idx[:m], m


def sort_case(rng, n, kind, space=6):
    """rows, cols, valid of one group; ``kind`` picks the live pattern."""
    r = rng.integers(0, space, n).astype(np.int32)
    c = rng.integers(-space, space, n).astype(np.int32)
    live = {"all": np.ones(n, bool), "none": np.zeros(n, bool), "prefix": np.arange(n) < n // 8,
            "scattered": rng.random(n) < 0.3, "one": np.arange(n) == rng.integers(0, max(n, 1))}[kind]
    if kind == "scattered":
        r[rng.random(n) < 0.1] = PAD  # live slots with a PAD row drop too
    return r, c, live


@pytest.mark.parametrize("kind", ["all", "none", "prefix", "scattered", "one"])
@pytest.mark.parametrize("tile", [8, 16])
def test_sort_model_matches_lexsort(tile, kind):
    """The live-prefix merge sort against numpy's stable lexsort of the live
    triples: groups with no, one and every entry live, a live prefix,
    scattered live slots; n not a multiple of the tile; extreme keys."""
    rng = np.random.default_rng(tile + len(kind))
    for n in (1, tile - 1, tile, tile + 1, 3 * tile + 2, 8 * tile, 100, 333):
        r, c, live = sort_case(rng, n, kind)
        if n > 4:
            r[:3] = [-(2**31), 2**31 - 2, -1]
            c[:3] = [2**31 - 1, -(2**31), 0]
        keys, idx, m = sort_model(r, c, live, tile)
        ok = live & (r != PAD)
        order = np.lexsort((c, r))
        want = order[ok[order]]
        assert m == ok.sum() and idx == want.tolist(), (n, kind)
        assert keys == [((int(r[j]) ^ 0x80000000) << 32 | ((int(c[j]) ^ 0x80000000) & MASK32)) & (2**64 - 1)
                        for j in want]


@pytest.mark.parametrize("srn", ["plus.times", "max.plus"])
def test_sort_then_fold_model_is_from_triples_plain(srn):
    """The two models in turn give what ``from_triples_plain`` gives: keys,
    values bit for bit, nnz and overflow, with a cap below the count."""
    rng = np.random.default_rng(21)
    for n, kind, cap in ((200, "all", 200), (333, "scattered", 40), (100, "prefix", 100), (64, "none", 8)):
        r, c, live = sort_case(rng, n, kind, space=4)
        v = special_values(rng, (n,))
        keys, idx, m = sort_model(r, c, live, 16)
        srows = [int(np.int32(np.uint32((k >> 32) ^ 0x80000000))) for k in keys]
        packed = np.array([k ^ 2**63 for k in keys], np.uint64).view(np.int64)
        packed = np.concatenate([packed, np.zeros(n - m, np.int64)])
        with np.errstate(invalid="ignore"):
            ends, vals = fold_model(packed, srows + [0] * (n - m), v[idx + [0] * (n - m)], m, 8,
                                    _NP_ADD[srn], np.float32(0))
            vals = [np.float32(x) + np.float32(0) if n >= 2 else x for x in vals]
        want = tas.from_triples_plain(torch.tensor(r), torch.tensor(c), torch.tensor(v), cap, ts.get(srn),
                                      torch.tensor(live))
        k = min(len(ends), cap)
        assert int(want.nnz) == k and bool(want.overflow) == (len(ends) > cap)
        np.testing.assert_array_equal(want.rows.numpy()[:k], [srows[e] for e in ends[:k]])
        np.testing.assert_array_equal(want.vals.numpy()[:k].view(np.int32),
                                      np.array(vals[:k], np.float32).view(np.int32))


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


def test_workspace_is_kept_and_grown(monkeypatch):
    """The kernel's workspaces: one pair per device and stream, kept between
    calls (a call allocates only its outputs), each grown when a call needs
    more; the counters' buffer is zero when made (every call leaves it
    zero, so it is never cleared again)."""
    monkeypatch.setattr(tops, "_scratch", {})
    monkeypatch.setattr(_launch, "index", lambda dev: 0)
    cpu = torch.device("cpu")
    w, z = tops.workspace(cpu, 7, 100, 40)
    work, zeroed = tops._scratch[(0, 7)]
    assert (work.numel(), zeroed.numel()) == (100, 40)
    assert not zeroed.any()
    assert (w, z) == (work.data_ptr(), zeroed.data_ptr())
    assert tops.workspace(cpu, 7, 50, 8) == (w, z)  # smaller: the same buffers
    assert tops.workspace(cpu, 7, 200, 8)[1] == z  # work grows alone
    assert tops._scratch[(0, 7)][0].numel() == 200
    w2 = tops._scratch[(0, 7)][0].data_ptr()
    assert tops.workspace(cpu, 7, 10, 64)[0] == w2  # zeroed grows alone
    grown = tops._scratch[(0, 7)][1]
    assert grown.numel() == 64 and not grown.any()
    tops.workspace(cpu, 8, 1, 1)
    assert len(tops._scratch) == 2  # one per stream


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
