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

Three functions dispatch to hand-written kernels on the card, as the
reference's Pallas kernels stand in for them: :func:`add` goes to
``merge_add``, :func:`from_triples` and :func:`_combine_sorted` go to
``sort_dedup``.  Their plain PyTorch bodies are :func:`add_plain`,
:func:`from_triples_plain` and :func:`combine_sorted_plain`; a CPU tensor
takes them, a CUDA tensor launches the kernel or raises, and inside
:func:`repro_torch.kernels.plain_versions` every tensor takes them.

The operator algebra (``A + B``, ``A & B``, ``A @ B``, ``A.T``, ``A[r, :]``,
``A[:, c]``, ``A[r, c]``) reads its output capacities and semiring from the
active :func:`cap_policy`, as in the reference.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Tuple

import torch

from .. import kernels
from ..device import resolve_device
from .semiring import PLUS_TIMES, Semiring

PAD = 2**31 - 1  # sentinel key for dead slots (sorts last)
_COL_OFFSET = 2**31
_ROW_SCALE = 2**32


def pack_keys(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 key that orders like the ``(row, col)`` int32 pair."""
    return rows.to(torch.int64) * _ROW_SCALE + (cols.to(torch.int64) + _COL_OFFSET)


@dataclasses.dataclass(frozen=True)
class OpPolicy:
    """Cap policy for the operator algebra (``A + B``, ``A @ B`` ...).
    ``None`` caps derive from the operands: ``add_cap = a.cap + b.cap``,
    ``mul_cap = min(a.cap, b.cap)``, ``matmul_cap = a.cap + b.cap``,
    ``row_cap = a.cap``."""

    sr: Semiring = PLUS_TIMES
    add_cap: int | None = None
    mul_cap: int | None = None
    matmul_cap: int | None = None
    max_fanout: int = 32
    row_cap: int | None = None


_DEFAULT_POLICY = OpPolicy()
# a ContextVar, so each thread / async task scopes its own policy
_policy_var: contextvars.ContextVar[OpPolicy] = contextvars.ContextVar(
    "assoc_op_policy", default=_DEFAULT_POLICY
)


def current_policy() -> OpPolicy:
    """The innermost active :func:`cap_policy`, or the defaults."""
    return _policy_var.get()


@contextlib.contextmanager
def cap_policy(**overrides):
    """Scope an :class:`OpPolicy` for the operator algebra; nested blocks
    start from the enclosing policy."""
    token = _policy_var.set(dataclasses.replace(current_policy(), **overrides))
    try:
        yield _policy_var.get()
    finally:
        _policy_var.reset(token)


@dataclasses.dataclass
class Assoc:
    """Sorted-COO hypersparse associative array with static capacity, with
    the reference's operator algebra (see the module docstring)."""

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

    def __add__(self, other: "Assoc") -> "Assoc":
        p = current_policy()
        cap = p.add_cap if p.add_cap is not None else self.capacity + other.capacity
        return add(self, other, cap=cap, sr=p.sr)

    def __and__(self, other: "Assoc") -> "Assoc":
        p = current_policy()
        cap = p.mul_cap if p.mul_cap is not None else min(self.capacity, other.capacity)
        return elem_mul(self, other, cap=cap, sr=p.sr)

    def __matmul__(self, other: "Assoc") -> "Assoc":
        p = current_policy()
        cap = p.matmul_cap if p.matmul_cap is not None else self.capacity + other.capacity
        return matmul(self, other, cap=cap, max_fanout=p.max_fanout, sr=p.sr)

    @property
    def T(self) -> "Assoc":
        return transpose(self, sr=current_policy().sr)

    def __getitem__(self, key):
        if not (isinstance(key, tuple) and len(key) == 2):
            raise TypeError("Assoc indexing is 2-D: A[r, :], A[:, c], or A[r, c]")
        p = current_policy()
        r, c = key
        for s in (r, c):
            if isinstance(s, slice) and s != slice(None):
                raise TypeError(
                    "Assoc slicing supports only the full ':' slice "
                    "(bounded/stepped slices would silently drop keys); use "
                    "extract_row / elem_mul masks for bounded selections"
                )
        r_all, c_all = isinstance(r, slice), isinstance(c, slice)
        if r_all and c_all:
            return self
        row_cap = p.row_cap if p.row_cap is not None else self.capacity
        if r_all:  # column slice via the transpose; keys stay (row, col)
            got = extract_row(transpose(self, sr=p.sr), c, cap=row_cap, sr=p.sr)
            return transpose(got, sr=p.sr)
        if c_all:
            return extract_row(self, r, cap=row_cap, sr=p.sr)
        return get(self, r, c, sr=p.sr)

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
        vals=_full(shape, sr.zero_as(dtype), dtype, device),
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
    keys fold with ``sr.add``.  ``valid`` masks input slots.  On the card
    this is the ``sort_dedup`` kernel."""
    if kernels.plain_active():
        return from_triples_plain(rows, cols, vals, cap, sr, valid)
    from ..kernels.sort_dedup import ops

    return ops.from_triples(rows, cols, vals, cap, sr, valid)


def from_triples_plain(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    cap: int,
    sr: Semiring = PLUS_TIMES,
    valid: torch.Tensor | None = None,
) -> Assoc:
    """The plain PyTorch :func:`from_triples`: one stable sort, then
    :func:`combine_sorted_plain`."""
    rows = rows.to(torch.int32)
    cols = cols.to(torch.int32)
    if valid is not None:
        rows = torch.where(valid, rows, PAD)
        cols = torch.where(valid, cols, PAD)
        vals = torch.where(valid, vals, torch.full_like(vals, sr.zero_as(vals.dtype)))
    order = torch.sort(pack_keys(rows, cols), dim=-1, stable=True).indices
    return combine_sorted_plain(
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
    same = lk == rk
    same = same.reshape(same.shape + (1,) * (lv.ndim - lk.ndim))  # over payload axes
    return rk, torch.where(same, sr.add(lv, rv), rv)


def _along(dim: int, s: slice):
    """Index of ``s`` on axis ``dim``."""
    return (slice(None),) * dim + (s,)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """JAX's ``_interleave`` on axis ``dim``: ``a`` on even slots, ``b`` on
    odd ones, each added to a zero pad (which turns float ``-0.0`` into
    ``+0.0``)."""
    shape = list(a.shape)
    shape[dim] += b.shape[dim]
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if a.is_floating_point():
        a, b = a + 0.0, b + 0.0
    out[_along(dim, slice(0, None, 2))] = a
    out[_along(dim, slice(1, None, 2))] = b
    return out


def _scan(keys: torch.Tensor, vals: torch.Tensor, sr: Semiring):
    """Inclusive segmented ``sr.add`` scan over runs of equal ``keys``, in
    exactly ``lax.associative_scan``'s order of operations.  The scan runs
    along the last axis of ``keys``; ``vals`` may carry trailing payload
    axes after it (the row accumulator's ``[n, d]`` rows)."""
    dim = keys.ndim - 1
    n = keys.shape[dim]
    if n < 2:
        return keys, vals

    def at(x, start, stop=None, step=None):
        return x[_along(dim, slice(start, stop, step))]

    rk, rv = _comb(at(keys, 0, -1, 2), at(vals, 0, -1, 2), at(keys, 1, None, 2), at(vals, 1, None, 2), sr)
    ok, ov = _scan(rk, rv, sr)
    if n % 2 == 0:
        ek, ev = _comb(at(ok, 0, -1), at(ov, 0, -1), at(keys, 2, None, 2), at(vals, 2, None, 2), sr)
    else:
        ek, ev = _comb(ok, ov, at(keys, 2, None, 2), at(vals, 2, None, 2), sr)
    ek = torch.cat([at(keys, 0, 1), ek], dim=dim)
    ev = torch.cat([at(vals, 0, 1), ev], dim=dim)
    return _interleave(ek, ok, dim), _interleave(ev, ov, dim)


def _combine_sorted(rows, cols, vals, cap: int, sr: Semiring) -> Assoc:
    """Fold each run of equal adjacent keys with ``sr.add`` and compact the
    survivors into a fresh Assoc of capacity ``cap``; PAD slots drop.  On
    the card this is the fold stage of the ``sort_dedup`` kernel."""
    if kernels.plain_active():
        return combine_sorted_plain(rows, cols, vals, cap, sr)
    from ..kernels.sort_dedup import ops

    return ops.combine_sorted(rows, cols, vals, cap, sr)


def combine_sorted_plain(rows, cols, vals, cap: int, sr: Semiring) -> Assoc:
    """The plain PyTorch :func:`_combine_sorted`: :func:`_scan`, then
    :func:`_compact` of the run ends."""
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
    """``C = A (+) B``: the union, equal keys folded as ``sr.add(a, b)``
    (``a`` on the left).  On the card this is the ``merge_add`` kernel."""
    if kernels.plain_active():
        return add_plain(a, b, cap, sr)
    from ..kernels.merge_add import ops

    return ops.merge_add(a, b, cap, sr)


def add_plain(a: Assoc, b: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES) -> Assoc:
    """The plain PyTorch :func:`add`: merge by rank, then
    :func:`combine_sorted_plain`."""
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

    res = combine_sorted_plain(
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
    out = torch.where(hit, a.vals[idx], torch.full_like(a.vals[idx], sr.zero_as(a.vals.dtype)))
    return out[0] if scalar else out


def extract_row(a: Assoc, r, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Row slice ``A(r, :)``."""
    keep = a.rows == int(r)
    rows = torch.where(keep, a.rows, PAD)
    cols = torch.where(keep, a.cols, PAD)
    vals = torch.where(keep, a.vals, torch.full_like(a.vals, sr.zero_as(a.vals.dtype)))
    return _combine_sorted(rows, cols, vals, cap, sr)


def nnz(a: Assoc) -> torch.Tensor:
    return a.nnz


# ---------------------------------------------------------------------------
# element-wise multiplication (database intersection)
# ---------------------------------------------------------------------------

def elem_mul(a: Assoc, b: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES) -> Assoc:
    """``C = A (x) B``: element-wise semiring multiplication (intersection)."""
    if cap is None:
        cap = min(a.capacity, b.capacity)
    idx = torch.clamp(lex_searchsorted(b.rows, b.cols, a.rows, a.cols), max=b.capacity - 1)
    b_rows = torch.gather(b.rows, -1, idx)
    b_cols = torch.gather(b.cols, -1, idx)
    b_vals = torch.gather(b.vals, -1, idx)
    hit = (b_rows == a.rows) & (b_cols == a.cols) & (a.rows != PAD)
    vals = torch.where(hit, sr.mul(a.vals, b_vals), torch.full_like(a.vals, sr.zero_as(a.vals.dtype)))
    rows = torch.where(hit, a.rows, PAD)
    cols = torch.where(hit, a.cols, PAD)
    # a subset of A's order with PAD holes: runs of one, combine/compact
    out = _combine_sorted(rows, cols, vals, cap, sr)
    out.overflow = out.overflow | a.overflow | b.overflow
    return out


# ---------------------------------------------------------------------------
# array multiplication C = A (+).(x) B (table transformation)
# ---------------------------------------------------------------------------

def matmul(a: Assoc, b: Assoc, cap: int, max_fanout: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Semiring spGEMM by sort-merge join on the inner key.  Each A-entry
    joins at most ``max_fanout`` B-entries sharing its inner key; a larger
    true fanout sets ``overflow`` (the entries beyond the bound drop).
    ``cap`` bounds the output nonzeros.  The ``m * max_fanout`` products go
    through :func:`from_triples`."""
    at = transpose(a, sr=sr)  # sorted by (inner key = A's col, A's row)
    b_rows = b.rows.contiguous()
    lo = torch.searchsorted(b_rows, at.rows.contiguous())
    hi = torch.searchsorted(b_rows, at.rows.contiguous(), right=True)
    live = at.rows != PAD
    clipped = torch.any(((hi - lo) > max_fanout) & live, dim=-1)
    m, f = at.capacity, int(max_fanout)
    batch = at.rows.shape[:-1]
    idx = lo.unsqueeze(-1) + torch.arange(f, device=lo.device)  # [..., m, f]
    ok = (idx < hi.unsqueeze(-1)) & live.unsqueeze(-1)
    flat = torch.clamp(idx, max=b.capacity - 1).reshape(batch + (m * f,))

    def take(x):
        return torch.gather(x, -1, flat).reshape(batch + (m, f))

    prod_rows = torch.where(ok, at.cols.unsqueeze(-1), PAD)  # AT.col is A's row key
    prod_cols = torch.where(ok, take(b.cols), PAD)
    prod_vals = sr.mul(at.vals.unsqueeze(-1), take(b.vals))
    prod_vals = torch.where(ok, prod_vals, torch.full_like(prod_vals, sr.zero_as(prod_vals.dtype)))
    out = from_triples(
        prod_rows.reshape(batch + (m * f,)),
        prod_cols.reshape(batch + (m * f,)),
        prod_vals.reshape(batch + (m * f,)),
        cap,
        sr,
    )
    out.overflow = out.overflow | clipped | a.overflow | b.overflow
    return out


def to_dense(a: Assoc, nrows: int, ncols: int, sr: Semiring = PLUS_TIMES) -> torch.Tensor:
    """Materialize as dense (small arrays and tests only); keys outside the
    ``nrows x ncols`` box (PAD slots among them) drop."""
    dense = torch.full((nrows, ncols), sr.zero_as(a.vals.dtype), dtype=a.vals.dtype, device=a.vals.device)
    ok = (a.rows >= 0) & (a.rows < nrows) & (a.cols >= 0) & (a.cols < ncols)
    dense[a.rows[ok].long(), a.cols[ok].long()] = a.vals[ok]
    return dense


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
