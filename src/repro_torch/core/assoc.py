"""Static-shape hypersparse associative arrays (port of ``repro.core.assoc``).

An :class:`Assoc` holds sorted-COO triples: ``rows``/``cols`` int32 keys
sorted lexicographically by ``(row, col)``, dead slots padded with
``PAD = INT32_MAX``; ``vals`` with the semiring zero in dead slots; ``nnz``
the live count and ``overflow`` the sticky capacity flag.  Every function
here also accepts leading batch axes (``[..., cap]`` leaves with ``[...]``
``nnz``/``overflow``), which is how the port writes JAX's ``vmap``.

Bit-exactness with the reference rests on three choices:

* one stable ``torch.sort`` on the int64 key ``(row << 32) + (col + 2**31)``
  replaces ``jnp.lexsort`` (that key orders exactly like ``(row, col)``);
* :func:`_scan` replays the odd/even recursion of ``lax.associative_scan``
  (``_scan`` in ``jax/_src/lax/control_flow/loops.py``), so runs of more than
  two float duplicates fold in the reference's order, and its interleave
  adds ``0`` like JAX's pad-and-add (``-0.0`` becomes ``+0.0``);
* ties in :meth:`Assoc.topk` keep the lower index first, like ``lax.top_k``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..device import resolve_device
from .semiring import PLUS_TIMES, Semiring

PAD = 2**31 - 1  # sentinel key for dead slots (sorts last)
_COL_OFFSET = 2**31
_ROW_SCALE = 2**32


def pack_keys(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 key that orders like the ``(row, col)`` int32 pair."""
    return rows.to(torch.int64) * _ROW_SCALE + (cols.to(torch.int64) + _COL_OFFSET)


@dataclasses.dataclass
class Assoc:
    """Sorted-COO hypersparse associative array with static capacity."""

    rows: torch.Tensor  # int32[..., cap]
    cols: torch.Tensor  # int32[..., cap]
    vals: torch.Tensor  # float[..., cap]
    nnz: torch.Tensor  # int32[...]
    overflow: torch.Tensor  # bool[...]

    @property
    def capacity(self) -> int:
        return self.rows.shape[-1]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Assoc(cap={self.capacity})"

    def topk(self, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ``k`` largest values: ``(row_ids [k], values [k])``; dead
        slots rank ``-inf``, ties keep the lower index first."""
        ranked = torch.where(
            self.rows != PAD, self.vals, torch.full_like(self.vals, -torch.inf)
        )
        top_vals, idx = torch.sort(ranked, dim=-1, descending=True, stable=True)
        idx = idx[..., :k]
        return torch.gather(self.rows, -1, idx), top_vals[..., :k]


def _full(shape, fill, dtype, device) -> torch.Tensor:
    return torch.full(shape, fill, dtype=dtype, device=device)


def empty(
    cap: int,
    sr: Semiring = PLUS_TIMES,
    dtype=torch.float32,
    device=None,
    batch: Tuple[int, ...] = (),
) -> Assoc:
    """An all-zero associative array with room for ``cap`` nonzeros
    (``batch`` prepends instance axes), on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    shape = tuple(batch) + (int(cap),)
    return Assoc(
        rows=_full(shape, PAD, torch.int32, device),
        cols=_full(shape, PAD, torch.int32, device),
        vals=_full(shape, sr.zero, dtype, device),
        nnz=torch.zeros(tuple(batch), dtype=torch.int32, device=device),
        overflow=torch.zeros(tuple(batch), dtype=torch.bool, device=device),
    )


def from_triples(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    cap: int,
    sr: Semiring = PLUS_TIMES,
    valid: torch.Tensor | None = None,
) -> Assoc:
    """Build an Assoc from (possibly duplicated, unsorted) triples; equal
    keys fold with ``sr.add``.  ``valid`` masks input slots."""
    rows = rows.to(torch.int32)
    cols = cols.to(torch.int32)
    if valid is not None:
        rows = torch.where(valid, rows, PAD)
        cols = torch.where(valid, cols, PAD)
        vals = torch.where(valid, vals, torch.full_like(vals, sr.zero))
    order = torch.sort(pack_keys(rows, cols), dim=-1, stable=True).indices
    return _combine_sorted(
        torch.gather(rows, -1, order),
        torch.gather(cols, -1, order),
        torch.gather(vals, -1, order),
        cap,
        sr,
    )


# ---------------------------------------------------------------------------
# internal: lax.associative_scan's fold tree, then compaction
# ---------------------------------------------------------------------------

def _comb(lk, lv, rk, rv, sr: Semiring):
    return rk, torch.where(lk == rk, sr.add(lv, rv), rv)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """JAX's ``_interleave``: ``a`` on even slots, ``b`` on odd ones, each
    added to a zero pad (which turns float ``-0.0`` into ``+0.0``)."""
    shape = a.shape[:-1] + (a.shape[-1] + b.shape[-1],)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if a.is_floating_point():
        a, b = a + 0.0, b + 0.0
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def _scan(keys: torch.Tensor, vals: torch.Tensor, sr: Semiring):
    """Inclusive segmented ``sr.add`` scan over runs of equal ``keys``, in
    exactly ``lax.associative_scan``'s order of operations."""
    n = keys.shape[-1]
    if n < 2:
        return keys, vals
    rk, rv = _comb(
        keys[..., 0:-1:2], vals[..., 0:-1:2], keys[..., 1::2], vals[..., 1::2], sr
    )
    ok, ov = _scan(rk, rv, sr)
    if n % 2 == 0:
        ek, ev = _comb(ok[..., :-1], ov[..., :-1], keys[..., 2::2], vals[..., 2::2], sr)
    else:
        ek, ev = _comb(ok, ov, keys[..., 2::2], vals[..., 2::2], sr)
    ek = torch.cat([keys[..., :1], ek], dim=-1)
    ev = torch.cat([vals[..., :1], ev], dim=-1)
    return _interleave(ek, ok), _interleave(ev, ov)


def _combine_sorted(rows, cols, vals, cap: int, sr: Semiring) -> Assoc:
    """Fold duplicate keys of sorted triples with ``sr.add`` and compact the
    survivors into a fresh Assoc of capacity ``cap``; PAD slots drop."""
    _, acc = _scan(pack_keys(rows, cols), vals, sr)
    tail = torch.full_like(rows[..., :1], -1)
    nxt_r = torch.cat([rows[..., 1:], tail], dim=-1)
    nxt_c = torch.cat([cols[..., 1:], tail], dim=-1)
    is_end = (rows != nxt_r) | (cols != nxt_c)  # last element of each key-run
    keep = is_end & (rows != PAD)
    return _compact(rows, cols, acc, keep, cap, sr)


def _compact(rows, cols, vals, keep, cap: int, sr: Semiring) -> Assoc:
    cap = int(cap)
    n_keep = keep.sum(dim=-1, dtype=torch.int32)
    pos = torch.cumsum(keep, dim=-1) - 1
    pos = torch.where(keep & (pos < cap), pos, cap)  # slot `cap` is discarded
    batch = rows.shape[:-1]
    out = empty(cap + 1, sr, vals.dtype, rows.device, batch)

    def place(dst, src):
        return dst.scatter_(-1, pos, src)[..., :cap].contiguous()

    return Assoc(
        rows=place(out.rows, rows),
        cols=place(out.cols, cols),
        vals=place(out.vals, vals),
        nnz=torch.clamp(n_keep, max=cap),
        overflow=n_keep > cap,
    )


# ---------------------------------------------------------------------------
# lexicographic binary search over (row, col) key pairs
# ---------------------------------------------------------------------------

def lex_searchsorted(kr, kc, qr, qc, side: str = "left") -> torch.Tensor:
    """``searchsorted`` over lexicographic ``(row, col)`` pairs; ``kr``/``kc``
    must be sorted.  Returns int64 positions."""
    qr = torch.as_tensor(qr, dtype=torch.int32, device=kr.device)
    qc = torch.as_tensor(qc, dtype=torch.int32, device=kr.device)
    return torch.searchsorted(
        pack_keys(kr, kc).contiguous(),
        pack_keys(qr, qc).contiguous(),
        right=(side == "right"),
    )


# ---------------------------------------------------------------------------
# element-wise addition (database union)
# ---------------------------------------------------------------------------

def add(a: Assoc, b: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES) -> Assoc:
    """``C = A (+) B``: merge by rank, then fold equal keys as
    ``sr.add(a, b)`` (``a`` on the left)."""
    if cap is None:
        cap = a.capacity + b.capacity
    m, n = a.capacity, b.capacity
    dev = a.rows.device
    ka, kb = pack_keys(a.rows, a.cols), pack_keys(b.rows, b.cols)
    pos_a = torch.arange(m, device=dev) + torch.searchsorted(kb, ka)
    pos_b = torch.arange(n, device=dev) + torch.searchsorted(ka, kb, right=True)
    batch = a.rows.shape[:-1]
    out = empty(m + n, sr, a.vals.dtype, dev, batch)

    def merge(dst, xa, xb):
        return dst.scatter_(-1, pos_a, xa).scatter_(-1, pos_b, xb)

    res = _combine_sorted(
        merge(out.rows, a.rows, b.rows),
        merge(out.cols, a.cols, b.cols),
        merge(out.vals, a.vals, b.vals),
        cap,
        sr,
    )
    res.overflow = res.overflow | a.overflow | b.overflow
    return res


# ---------------------------------------------------------------------------
# transpose, reductions, queries
# ---------------------------------------------------------------------------

def transpose(a: Assoc, sr: Semiring = PLUS_TIMES) -> Assoc:
    """``A^T``: swap row/col keys and re-sort (keys unique, nothing folds)."""
    order = torch.sort(pack_keys(a.cols, a.rows), dim=-1, stable=True).indices
    return Assoc(
        rows=torch.gather(a.cols, -1, order),
        cols=torch.gather(a.rows, -1, order),
        vals=torch.gather(a.vals, -1, order),
        nnz=a.nnz,
        overflow=a.overflow,
    )


def reduce_rows(a: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Fold each row with ``sr.add``; keys become ``(row, 0)``."""
    if cap is None:
        cap = a.capacity
    cols = torch.where(a.rows != PAD, 0, PAD).to(torch.int32)
    return _combine_sorted(a.rows, cols, a.vals, cap, sr)


def reduce_cols(a: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Fold each column with ``sr.add``; keys become ``(col, 0)``."""
    if cap is None:
        cap = a.capacity
    return reduce_rows(transpose(a, sr), cap, sr)


def get(a: Assoc, r, c, sr: Semiring = PLUS_TIMES) -> torch.Tensor:
    """Point query ``A(r, c)``: the semiring zero when absent."""
    dev = a.rows.device
    r = torch.as_tensor(r, dtype=torch.int32, device=dev)
    c = torch.as_tensor(c, dtype=torch.int32, device=dev)
    scalar = r.ndim == 0
    rq, cq = torch.atleast_1d(r), torch.atleast_1d(c)
    idx = torch.clamp(lex_searchsorted(a.rows, a.cols, rq, cq), max=a.capacity - 1)
    hit = (a.rows[idx] == rq) & (a.cols[idx] == cq)
    out = torch.where(hit, a.vals[idx], torch.full_like(a.vals[idx], sr.zero))
    return out[0] if scalar else out


def extract_row(a: Assoc, r, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Row slice ``A(r, :)``."""
    keep = a.rows == int(r)
    rows = torch.where(keep, a.rows, PAD)
    cols = torch.where(keep, a.cols, PAD)
    vals = torch.where(keep, a.vals, torch.full_like(a.vals, sr.zero))
    return _combine_sorted(rows, cols, vals, cap, sr)


def is_sorted_unique(a: Assoc) -> torch.Tensor:
    """Invariant check: live keys strictly increasing, live entries a
    prefix, PADs consistent, ``nnz`` matches."""
    r, c = a.rows, a.cols
    ok_pairs = (r[..., :-1] < r[..., 1:]) | ((r[..., :-1] == r[..., 1:]) & (c[..., :-1] < c[..., 1:]))
    live = (r[..., :-1] != PAD) & (r[..., 1:] != PAD)
    within = torch.all(torch.where(live, ok_pairs, True), dim=-1)
    idx = torch.arange(r.shape[-1], device=r.device)
    count_ok = (r != PAD).sum(dim=-1) == a.nnz
    prefix_ok = torch.all((r != PAD) == (idx < a.nnz.unsqueeze(-1)), dim=-1)
    pad_ok = torch.all((r == PAD) == (c == PAD), dim=-1)
    return within & count_ok & prefix_ok & pad_ok
