"""Sorted sparse *row* accumulators (port of ``repro.sparse.row_accum``).

An associative array whose values are float rows: sorted unique int32 ids
(dead slots ``PAD``) with ``[cap, d]`` payload rows.  An embedding-gradient
microbatch is a hypersparse stream ``token_id -> grad_row``; this is the
structure of :mod:`repro_torch.core.assoc` with ``(row=token_id, col=0)``
keys and vector payloads, and the same layered cascade.

Bit-exactness with the reference rests on the choices of
:mod:`repro_torch.core.assoc`: :func:`from_pairs` sorts stably (as
``jnp.argsort``), and :func:`_combine_sorted` folds duplicate ids with
``assoc._scan``, the replay of ``lax.associative_scan``'s bracketing, over
the ``[n, d]`` rows (so a singleton ``-0.0`` comes out ``+0.0``, C6).

:func:`to_dense` is where the ``scatter_add`` kernel sits on the card, as
the reference's ``zeros.at[ids].add(rows, mode="drop")`` is what the
kernel computes on a zero table.  Inside
:func:`repro_torch.kernels.plain_versions` it takes the plain version.

:func:`hier_update` is the cond form: each cut's predicate is read back to
the host (one synchronisation with the card per cut per microbatch).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from .. import kernels
from ..core import assoc
from ..core.assoc import PAD
from ..core.hierarchical import telescoped_caps
from ..core.semiring import PLUS_TIMES
from ..device import resolve_device
from ..kernels.scatter_add import ops as scatter_ops


@dataclasses.dataclass
class RowAccum:
    """Sorted unique int32 ids with ``[d]`` payload rows; pad id ``PAD``."""

    ids: torch.Tensor  # int32[cap]
    rows: torch.Tensor  # float[cap, d]
    nnz: torch.Tensor  # int32[]
    overflow: torch.Tensor  # bool[]

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]

    @property
    def dim(self) -> int:
        return self.rows.shape[1]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"RowAccum(cap={self.capacity}, d={self.dim})"


def empty(cap: int, d: int, dtype=torch.float32, device=None) -> RowAccum:
    """An empty accumulator, on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    return RowAccum(
        ids=torch.full((int(cap),), PAD, dtype=torch.int32, device=device),
        rows=torch.zeros((int(cap), int(d)), dtype=dtype, device=device),
        nnz=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def _combine_sorted(ids: torch.Tensor, rows: torch.Tensor, cap: int) -> RowAccum:
    """Fold duplicate ids (sorted input) and compact into capacity ``cap``;
    PAD slots drop."""
    cap = int(cap)
    _, acc = assoc._scan(ids, rows, PLUS_TIMES)
    nxt = torch.cat([ids[1:], ids.new_full((1,), -1)])
    keep = (ids != nxt) & (ids != PAD)
    n_keep = keep.sum(dtype=torch.int32)
    pos = torch.cumsum(keep, 0) - 1
    pos = torch.where(keep & (pos < cap), pos, cap)  # slot `cap` is discarded
    out = empty(cap + 1, rows.shape[1], rows.dtype, rows.device)
    return RowAccum(
        ids=out.ids.index_copy_(0, pos, ids)[:cap],
        rows=out.rows.index_copy_(0, pos, acc)[:cap],
        nnz=torch.clamp(n_keep, max=cap),
        overflow=n_keep > cap,
    )


def from_pairs(ids: torch.Tensor, rows: torch.Tensor, cap: int) -> RowAccum:
    """Build from (possibly duplicated, unsorted) id/row pairs; duplicates
    fold in input order (a stable sort)."""
    ids = ids.to(torch.int32)
    order = torch.sort(ids, stable=True).indices
    return _combine_sorted(ids[order], rows[order], cap)


def merge(a: RowAccum, b: RowAccum, cap: int | None = None) -> RowAccum:
    """``A (+) B`` by rank placement (both inputs sorted), then the fold;
    equal ids fold ``a + b``."""
    if cap is None:
        cap = a.capacity + b.capacity
    m, n = a.capacity, b.capacity
    dev = a.ids.device
    pos_a = torch.arange(m, device=dev) + torch.searchsorted(b.ids, a.ids)
    pos_b = torch.arange(n, device=dev) + torch.searchsorted(a.ids, b.ids, right=True)
    # every slot of [0, m + n) is written once (the PAD tails never collide)
    ids = torch.empty(m + n, dtype=torch.int32, device=dev)
    ids.index_copy_(0, pos_a, a.ids).index_copy_(0, pos_b, b.ids)
    rows = torch.empty((m + n, a.dim), dtype=a.rows.dtype, device=dev)
    rows.index_copy_(0, pos_a, a.rows).index_copy_(0, pos_b, b.rows)
    out = _combine_sorted(ids, rows, cap)
    out.overflow = out.overflow | a.overflow | b.overflow
    return out


def to_dense(a: RowAccum, v: int) -> torch.Tensor:
    """The ``[v, d]`` dense table of ``a`` (ids outside ``[-v, v)`` and PAD
    slots drop).  On the card this is the ``scatter_add`` kernel."""
    dense = torch.zeros((int(v), a.dim), dtype=a.rows.dtype, device=a.rows.device)
    if kernels.plain_active():
        return scatter_ops.scatter_add_plain(a.ids, a.rows, dense)
    return scatter_ops.scatter_add(a.ids, a.rows, dense)


# ---------------------------------------------------------------------------
# hierarchical cascade (paper Section III, row-valued)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HierRowAccum:
    layers: Tuple[RowAccum, ...]
    cascades: torch.Tensor  # int32[N]: cascades that reached each layer

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"HierRowAccum(caps={[l.capacity for l in self.layers]})"


def hier_init(
    cuts: Sequence[int], top_capacity: int, batch: int, d: int, device=None
) -> HierRowAccum:
    """Empty layers with telescoped capacities (``cap_1 = c_1 + batch``,
    ``cap_i = c_i + cap_{i-1}``, ``cap_N = top + cap_{N-1}``), on the card
    unless ``device="cpu"``."""
    device = resolve_device(device)
    caps = telescoped_caps(cuts, top_capacity, batch)
    return HierRowAccum(
        layers=tuple(empty(c, d, device=device) for c in caps),
        cascades=torch.zeros((len(caps),), dtype=torch.int32, device=device),
    )


def hier_update(
    h: HierRowAccum, ids: torch.Tensor, rows: torch.Tensor, cuts: Sequence[int]
) -> HierRowAccum:
    """Ingest one microbatch of ``(id, grad_row)`` pairs; cascade a layer
    into the next when its nnz passes its cut (the paper's HierAdd with row
    payloads).  Each cut's test is a host sync (see the module docstring)."""
    layers = list(h.layers)
    cascades = h.cascades.clone()
    batch = from_pairs(ids, rows, cap=ids.shape[0])
    layers[0] = merge(layers[0], batch, cap=layers[0].capacity)
    for i, cut in enumerate(int(c) for c in cuts):
        src, dst = layers[i], layers[i + 1]
        if bool(src.nnz > cut):  # host sync
            layers[i + 1] = merge(dst, src, cap=dst.capacity)
            layers[i] = empty(src.capacity, src.dim, src.rows.dtype, src.rows.device)
            cascades[i + 1] += 1
    return HierRowAccum(layers=tuple(layers), cascades=cascades)


def hier_flush(h: HierRowAccum) -> RowAccum:
    """Collapse all layers into one sorted accumulator of the top layer's
    capacity (the optimizer hand-off)."""
    out = h.layers[-1]
    for layer in reversed(h.layers[:-1]):
        out = merge(out, layer, cap=h.layers[-1].capacity)
    return out


def hier_reset(h: HierRowAccum) -> HierRowAccum:
    return HierRowAccum(
        layers=tuple(empty(l.capacity, l.dim, l.rows.dtype, l.rows.device) for l in h.layers),
        cascades=torch.zeros_like(h.cascades),
    )


def hier_overflowed(h: HierRowAccum) -> torch.Tensor:
    out = h.layers[0].overflow
    for l in h.layers[1:]:
        out = out | l.overflow
    return out
