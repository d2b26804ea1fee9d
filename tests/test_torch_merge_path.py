"""A numpy model of the merge-path merge that ``hier_cascade`` and
``merge_add`` run on the card (``src/repro_torch/csrc/merge.cuh``), held to
``assoc.add_plain`` on the CPU.

The CUDA kernels cannot run here, so this pins their index arithmetic, loop
for loop, at tiny tiles (a tile of ``THREADS * ITEMS`` merged entries):

* ``warp_split``: the split of a diagonal in the dst-first merged order by
  a ``LANES``-way search, shifted past an equal-key pair it would cut;
* ``tile_survivors``: a tile's per-thread splits (the same pair rule inside
  the tile), each thread's sequential merge of at most ``ITEMS`` survivors
  (the count pass takes a tile holding entries of one list only at its
  size, unread; the write pass merges it like any other);
* the scan of the tiles' survivor counts into output offsets, and the
  truncation at ``cap`` with the untruncated count for the overflow flag;
* ``block_copy_async``/``block_store`` (the split ``vector_head`` makes)
  and the slices' places in shared memory (``lead``, ``lead_after``), at
  the card's own tile size: each slice lands at its global address's
  offset within 16 bytes, so its middle moves in 16-byte vectors aligned
  on both sides, and every slot fits the tile's arrays.

The card's own check, kernel against plain version bit for bit, is
``chip_smoke.py`` (``phase_parity``, ``phase_parity_ops``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import assoc as tas
from repro_torch.core import semiring as ts

from _torch_parity import assert_assoc_same, special_values

SEMIRINGS = ["plus.times", "max.plus", "min.plus", "union.first"]


def fold_value(fold, dst, src):
    """``d4m::fold_add`` on float32 (max/min carry NaN, dst first)."""
    if fold == 0:
        return np.float32(dst + src)
    if fold == 1:
        return dst if (dst != dst or dst > src) else src
    if fold == 2:
        return dst if (dst != dst or dst < src) else src
    return dst


def warp_split(a, b, d, lanes):
    """``d4m::warp_split``: ``lanes`` probes a round along diagonal ``d``."""
    na, nb = len(a), len(b)
    lo, hi = max(0, d - nb), min(d, na)

    def probe(x):
        return x < hi and a[x] <= b[d - 1 - x]

    rounds = 0
    while hi - lo > lanes:
        step = -(-(hi - lo) // lanes)
        c = sum(probe(lo + lane * step) for lane in range(lanes))
        if c == 0:
            hi = lo
        else:
            top = lo + c * step
            lo += (c - 1) * step + 1
            hi = min(top, hi)
        rounds += 1
    i = lo + sum(probe(lo + lane) for lane in range(lanes))
    j = d - i
    if i > 0 and j < nb and a[i - 1] == b[j]:
        j += 1
    return i, j, rounds


def local_split(a, b, d):
    """The in-tile split of ``thread_merge`` (binary search, pair rule)."""
    na, nb = len(a), len(b)
    lo, hi = max(0, d - nb), min(d, na)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    j = d - lo
    if lo > 0 and j < nb and a[lo - 1] == b[j]:
        j += 1
    return lo, j


def tile_survivors(ak, av, bk, bv, fold, threads, items):
    """One tile in shared memory: per-thread splits, then each thread's
    unrolled loop of ``items`` steps; returns the survivors in order."""
    na, nb = len(ak), len(bk)
    n = na + nb
    splits = [local_split(ak, bk, min(t * items, n)) for t in range(threads)] + [(na, nb)]
    keys, vals = [], []
    for t in range(threads):
        (ai, bi), (ae, be) = splits[t], splits[t + 1]
        cnt = 0
        for _ in range(items):
            has_a, has_b = ai < ae, bi < be
            if not (has_a or has_b):
                continue
            take_a = has_a and (not has_b or ak[ai] <= bk[bi])
            pair = take_a and has_b and ak[ai] == bk[bi]
            keys.append(ak[ai] if take_a else bk[bi])
            v = av[ai] if take_a else bv[bi]
            vals.append(fold_value(fold, v, bv[bi]) if pair else v)
            ai += take_a
            bi += (not take_a) or pair
            cnt += 1
        # the unrolled loop must have consumed the thread's whole range
        assert (ai, bi) == (ae, be), (t, ai, ae, bi, be)
        assert cnt <= items
    return keys, vals


def merge_path(ak, av, bk, bv, cap, fold, normalize, threads=4, items=2, lanes=4):
    """``merge_count`` + ``merge_write`` for one group.  Returns the output
    keys and values (truncated at ``cap``), the untruncated survivor count
    and how many tile edges moved past an equal-key pair."""
    tile = threads * items
    n = len(ak) + len(bk)
    n_tiles = max(1, -(-n // tile))
    splits = [warp_split(ak, bk, min(t * tile, n), lanes)[:2] for t in range(n_tiles + 1)]
    shifted = sum(i + j != min(t * tile, n) for t, (i, j) in enumerate(splits))
    tiles, counts = [], []
    for t in range(n_tiles):
        (i0, j0), (i1, j1) = splits[t], splits[t + 1]
        assert i0 <= i1 and j0 <= j1
        assert (i1 - i0) + (j1 - j0) <= tile + 1
        tiles.append(tile_survivors(ak[i0:i1], av[i0:i1], bk[j0:j1], bv[j0:j1], fold, threads, items))
        if i0 == i1 or j0 == j1:  # one list alone: counted at its size, unread
            counts.append((i1 - i0) + (j1 - j0))
            assert counts[-1] == len(tiles[-1][0])
        else:
            counts.append(len(tiles[-1][0]))
    counts = np.array(counts, np.int64)
    assert (counts <= tile).all()
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_keep = int(counts.sum())
    keys = np.full(cap, -1, np.int64)
    vals = np.zeros(cap, np.float32)
    for base, (tk, tv) in zip(offsets, tiles):
        for x, (k, v) in enumerate(zip(tk, tv)):
            if base + x < cap:
                keys[base + x] = k
                vals[base + x] = np.float32(v + np.float32(0.0)) if normalize else v
    return keys, vals, n_keep, shifted


def _unique_sorted(rng, n, space):
    return np.sort(rng.choice(space, size=n, replace=False)).astype(np.int64)


def _to_assoc(keys, vals, width, sr):
    """A CPU Assoc of width ``width`` holding sorted unique ``keys`` (key
    index -> (index // 64, index % 64))."""
    n = len(keys)
    rows = np.full(width, tas.PAD, np.int32)
    cols = np.full(width, tas.PAD, np.int32)
    v = np.full(width, sr.zero, np.float32)
    rows[:n], cols[:n], v[:n] = keys // 64, keys % 64, vals
    return tas.Assoc(torch.tensor(rows), torch.tensor(cols), torch.tensor(v),
                     torch.tensor(n, dtype=torch.int32), torch.tensor(False))


def _check(ak, av, bk, bv, m, n, cap, srn, **kw):
    """The model against ``add_plain`` on the same inputs: keys, positions,
    values (bits), nnz and overflow."""
    sr = ts.get(srn)
    a, b = _to_assoc(ak, av, m, sr), _to_assoc(bk, bv, n, sr)
    want = tas.add_plain(a, b, cap, sr)
    pk = tas.pack_keys(a.rows, a.cols).numpy()[: len(ak)]
    qk = tas.pack_keys(b.rows, b.cols).numpy()[: len(bk)]
    keys, vals, n_keep, shifted = merge_path(pk, av, qk, bv, cap, sr.fold, m + n >= 2, **kw)
    live = min(n_keep, cap)
    rows = np.where(np.arange(cap) < live, keys >> 32, tas.PAD).astype(np.int32)
    cols = np.where(np.arange(cap) < live, (keys & 0xFFFFFFFF) - 2**31, tas.PAD).astype(np.int32)
    v = np.where(np.arange(cap) < live, vals, np.float32(sr.zero)).astype(np.float32)
    got = tas.Assoc(torch.tensor(rows), torch.tensor(cols), torch.tensor(v),
                    torch.tensor(live, dtype=torch.int32), torch.tensor(n_keep > cap))
    assert_assoc_same(got, want, srn)
    return n_keep, shifted


def test_warp_split_matches_the_merged_order():
    """Every diagonal's split, at 4 and 32 lanes, is the prefix of the
    dst-first merged order, moved one past an equal-key pair it would cut."""
    rng = np.random.default_rng(0)
    a, b = _unique_sorted(rng, 300, 500), _unique_sorted(rng, 200, 500)
    order = sorted([(k, 0, i) for i, k in enumerate(a)] + [(k, 1, j) for j, k in enumerate(b)])
    for lanes in (4, 32):
        for d in range(len(order) + 1):
            i, j, rounds = warp_split(a, b, d, lanes)
            first = order[:d]
            want_i = sum(s == 0 for _, s, _ in first)
            want_j = d - want_i
            if 0 < want_i and want_j < len(b) and a[want_i - 1] == b[want_j]:
                want_j += 1
            assert (i, j) == (want_i, want_j), (lanes, d)
            assert rounds <= (3 if lanes == 32 else 5)


@pytest.mark.parametrize("srn", SEMIRINGS)
@pytest.mark.parametrize("seed", [1, 2])
def test_random_lists_with_many_shared_keys(srn, seed):
    """Sorted unique lists drawn from a small key space (about half the keys
    shared), NaN, -0.0 and +0.0 among the values."""
    rng = np.random.default_rng(seed)
    ak, bk = _unique_sorted(rng, 90, 160), _unique_sorted(rng, 70, 160)
    av, bv = special_values(rng, 90), special_values(rng, 70)
    n_keep, shifted = _check(ak, av, bk, bv, 100, 80, 180, srn)
    assert n_keep < 160 and shifted > 0


@pytest.mark.parametrize("threads,items", [(4, 2), (8, 4), (3, 4)])
def test_pair_on_every_partition_boundary(threads, items):
    """dst {1} + S, src S: every entry paired, the pairs at odd/even merged
    positions, so every edge of an even tile (the card's is 2048) and every
    thread's split of an even item count falls inside a pair and is moved
    past it."""
    rng = np.random.default_rng(threads)
    s = np.arange(2, 202, dtype=np.int64)
    ak = np.concatenate([[1], s])
    av, bv = rng.normal(size=ak.size).astype(np.float32), rng.normal(size=s.size).astype(np.float32)
    n_keep, shifted = _check(ak, av, s, bv, 220, 210, 430, "plus.times", threads=threads, items=items)
    assert n_keep == ak.size
    assert shifted == -(-(ak.size + s.size) // (threads * items)) - 1


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 37), (41, 0)])
def test_one_side_empty(na, nb):
    rng = np.random.default_rng(na + 2 * nb)
    ak, bk = _unique_sorted(rng, na, 100), _unique_sorted(rng, nb, 100)
    av, bv = special_values(rng, na), special_values(rng, nb)
    n_keep, _ = _check(ak, av, bk, bv, max(na, 1), max(nb, 1), 64, "max.plus")
    assert n_keep == na + nb


def test_tiles_of_one_list_alone():
    """Long stretches of one list (disjoint key ranges, then an interleave):
    tiles holding one list alone are copies, their neighbours merge."""
    rng = np.random.default_rng(9)
    ak = np.concatenate([np.arange(0, 60), np.arange(200, 260, 2)]).astype(np.int64)
    bk = np.concatenate([np.arange(100, 150), np.arange(201, 262, 3)]).astype(np.int64)
    av, bv = special_values(rng, ak.size), special_values(rng, bk.size)
    n_keep, _ = _check(ak, av, bk, bv, 100, 80, 180, "min.plus")
    assert n_keep == np.union1d(ak, bk).size


@pytest.mark.parametrize("cap", [0, 1, 7, 33])
def test_cap_below_the_union(cap):
    """Truncation at ``cap``: the first ``cap`` survivors, nnz = cap and the
    overflow flag from the untruncated count (tiles past the cap write
    nothing)."""
    rng = np.random.default_rng(cap)
    ak, bk = _unique_sorted(rng, 50, 120), _unique_sorted(rng, 40, 120)
    av, bv = special_values(rng, 50), special_values(rng, 40)
    n_keep, _ = _check(ak, av, bk, bv, 50, 40, cap, "plus.times")
    assert n_keep > cap


# -- the tile's loads and stores (merge.cuh load_tile, merge_write) ---------

CARD_TILE = 256 * 8  # kMergeThreads * kMergeItems
CARD_SLOTS = CARD_TILE + 24  # kMergeSlots


def lead(addr, size):
    """``lead``: the offset of ``addr`` within its 16 bytes, in elements."""
    return (addr & 15) // size


def lead_after(end, addr, size):
    """``lead_after``: the next 16-byte boundary after slot ``end``, plus
    ``addr``'s own offset."""
    vec = 16 // size
    return -(-end // vec) * vec + lead(addr, size)


def block_copy_moves(dst, src, size, n, threads=256):
    """``block_copy_async`` and ``block_store``: the ``(thread, first
    element, elements)`` of every move, vectors of 16 bytes where ``dst``
    and ``src`` share their offset within 16 bytes, single elements
    elsewhere."""
    vec = 16 // size
    head = n
    if ((src ^ dst) & 15) == 0:
        head = min(((16 - (src & 15)) & 15) // size, n)
    n_vec = (n - head) // vec
    moves = [(q % threads, head + q * vec, vec) for q in range(n_vec)]
    moves += [(x % threads, x, 1) for x in range(head)]
    tail = head + n_vec * vec
    moves += [((x - tail) % threads, x, 1) for x in range(tail, n)]
    return moves


def _check_copy(dst, src, size, n):
    moved = np.zeros(n, np.int64)
    vectors = 0
    for _, first, count in block_copy_moves(dst, src, size, n):
        moved[first:first + count] += 1
        if count > 1:
            assert count * size == 16
            assert (src + first * size) % 16 == 0 and (dst + first * size) % 16 == 0
            vectors += 1
    assert (moved == 1).all()
    return vectors


@pytest.mark.parametrize("size", [4, 2])
def test_block_copy_moves_each_element_once(size):
    """Every element moves once; a vector is whole and aligned on both
    sides; slices of a few elements and misaligned pairs go one by one."""
    rng = np.random.default_rng(size)
    smem = 0x1000  # a 16-byte aligned shared array
    for n in [0, 1, 3, 7, 8, 9, 15, 16, 17, 255, 2049] + list(rng.integers(0, 2100, 20)):
        n = int(n)
        for off in range(16 // size):
            src = 0x7F0000 + off * size
            vectors = _check_copy(smem + lead(src, size) * size, src, size, n)
            assert vectors >= (n - 2 * (16 // size - 1)) // (16 // size)
        # dst not placed by lead(): correct, one element at a time
        src = 0x7F0000 + size
        assert _check_copy(smem, src, size, n) == 0


@pytest.mark.parametrize("size", [4, 2])
def test_slices_fit_their_shared_slots(size):
    """``load_tile`` places a's slice at ``lead`` and b's after it at
    ``lead_after``; ``merge_write`` stages the survivors at the output's
    ``lead``.  Neither overlaps, each matches its global address within
    16 bytes, and all fit ``kMergeSlots`` for every tile the card makes
    (at most ``kMergeTile + 1`` entries, ``kMergeTile`` survivors)."""
    rng = np.random.default_rng(10 + size)
    smem = 0x2000
    for _ in range(2000):
        n = int(rng.integers(CARD_TILE - 1, CARD_TILE + 2))
        na = int(rng.integers(0, n + 1))
        nb = n - na
        a_addr, b_addr, o_addr = (0x10000 + int(x) * size for x in rng.integers(0, 1 << 20, 3))
        ra = lead(a_addr, size)
        rb = lead_after(ra + na, b_addr, size)
        assert ra + na <= rb and rb + nb <= CARD_SLOTS
        assert (smem + ra * size - a_addr) % 16 == 0 and (smem + rb * size - b_addr) % 16 == 0
        ro = lead(o_addr, size)
        assert ro + CARD_TILE <= CARD_SLOTS and (smem + ro * size - o_addr) % 16 == 0
