"""Instance-packed multi-stream state and hash routing (port of
``repro.core.multistream``, without ``MultiStreamEngine``).

K independent hierarchies live in one :class:`HierAssoc` whose every leaf
has a leading ``[K]`` axis.  The reference ``vmap``s the branchless cascade
over that axis; here the branchless cascade takes the axis directly.
:func:`route_to_instances` fans a global triple stream out to the K
instances by a key hash, so each key always lands on the same instance.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import assoc, hierarchical
from .assoc import PAD, Assoc
from .hierarchical import HierAssoc
from .semiring import PLUS_TIMES, Semiring


def init_packed(
    n_instances: int,
    cuts: Sequence[int],
    top_capacity: int,
    batch_size: int,
    sr: Semiring = PLUS_TIMES,
    dtype=torch.float32,
    pad_pow2: bool = False,
    device=None,
) -> HierAssoc:
    """``n_instances`` independent empty hierarchies, stacked per leaf, on
    the card unless ``device="cpu"``; ``pad_pow2`` gives the power-of-two
    widths of the reference's Pallas engine (the port's engines need none)."""
    return hierarchical.init(
        cuts, top_capacity, batch_size, sr, dtype, device,
        batch=(int(n_instances),), pad_pow2=pad_pow2,
    )


def flat_layer_state(h: HierAssoc):
    """The packed buffers in the kernel's layout: per-layer
    ``(rows, cols, vals)`` (each ``[K, Q_i]``) plus ``[K, L]`` planes of nnz,
    cascade counters and overflow flags."""
    bufs = tuple((l.rows, l.cols, l.vals) for l in h.layers)
    nnz = torch.stack([l.nnz for l in h.layers], dim=1)
    overflow = torch.stack([l.overflow for l in h.layers], dim=1)
    return bufs, nnz, h.cascades, overflow


def from_flat_layer_state(bufs, nnz, cascades, overflow) -> HierAssoc:
    """Inverse of :func:`flat_layer_state`."""
    layers = tuple(
        Assoc(rows=r, cols=c, vals=v, nnz=nnz[:, i].contiguous(), overflow=overflow[:, i].contiguous())
        for i, (r, c, v) in enumerate(bufs)
    )
    return HierAssoc(layers=layers, cascades=cascades)


def instance(h: HierAssoc, k: int) -> HierAssoc:
    """Instance ``k`` of a packed hierarchy (views, no copies)."""
    return HierAssoc(
        layers=tuple(
            Assoc(l.rows[k], l.cols[k], l.vals[k], l.nnz[k], l.overflow[k])
            for l in h.layers
        ),
        cascades=h.cascades[k],
    )


def packed_update(
    h: HierAssoc,
    rows: torch.Tensor,  # [K, B] int32
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Sequence[int],
    sr: Semiring = PLUS_TIMES,
    branchless: bool | None = None,
) -> HierAssoc:
    """One streaming update on every packed instance at once: the
    branchless cascade over the ``[K]`` axis.  ``K = 1`` keeps the cond
    form unless ``branchless=True``, as in the reference."""
    cuts = tuple(int(c) for c in cuts)
    if rows.shape[0] == 1 and branchless is not True:
        h1 = hierarchical.update_triples(
            instance(h, 0), rows[0], cols[0], vals[0], cuts, sr
        )
        return HierAssoc(
            layers=tuple(
                Assoc(l.rows[None], l.cols[None], l.vals[None], l.nnz[None], l.overflow[None])
                for l in h1.layers
            ),
            cascades=h1.cascades[None],
        )
    return hierarchical.update_triples(h, rows, cols, vals, cuts, sr, branchless=True)


# ---------------------------------------------------------------------------
# packed telemetry / snapshots
# ---------------------------------------------------------------------------

def nnz_per_instance(h: HierAssoc) -> torch.Tensor:
    """Per-instance upper bound on distinct keys; ``[K]`` int32."""
    return hierarchical.nnz_total(h)


def nnz_total(h: HierAssoc) -> torch.Tensor:
    return nnz_per_instance(h).sum(dtype=torch.int32)


def cascades_per_instance(h: HierAssoc) -> torch.Tensor:
    """Per-instance cascade counters; ``[K, n_layers]`` int32."""
    return h.cascades


def overflowed_per_instance(h: HierAssoc) -> torch.Tensor:
    """Sticky per-instance overflow flags; ``[K]`` bool."""
    return hierarchical.overflowed(h)


def snapshot_packed(h: HierAssoc, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Per-instance ``A = sum_i A_i``, stacked on a leading ``[K]`` axis.
    One instance at a time, so the merge temporaries stay one instance
    wide at full-size capacities."""
    snaps = [
        hierarchical.snapshot(instance(h, k), cap=cap, sr=sr)
        for k in range(h.cascades.shape[0])
    ]
    return Assoc(
        rows=torch.stack([s.rows for s in snaps]),
        cols=torch.stack([s.cols for s in snaps]),
        vals=torch.stack([s.vals for s in snaps]),
        nnz=torch.stack([s.nnz for s in snaps]),
        overflow=torch.stack([s.overflow for s in snaps]),
    )


def merge_snapshots(snap: Assoc, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Fold a ``[K]``-leading snapshot into one global Assoc by the
    reference's pairwise halving (pad K to a power of two with empties)."""
    k = snap.rows.shape[0]
    p = 1 << max(0, (k - 1)).bit_length()
    if p != k:
        fill = assoc.empty(
            snap.rows.shape[1], sr, snap.vals.dtype, snap.rows.device, (p - k,)
        )
        snap = Assoc(
            *(torch.cat([a, b], dim=0) for a, b in zip(
                (snap.rows, snap.cols, snap.vals, snap.nnz, snap.overflow),
                (fill.rows, fill.cols, fill.vals, fill.nnz, fill.overflow),
            ))
        )
    while p > 1:
        half = p // 2
        a = Assoc(snap.rows[:half], snap.cols[:half], snap.vals[:half], snap.nnz[:half], snap.overflow[:half])
        b = Assoc(snap.rows[half:], snap.cols[half:], snap.vals[half:], snap.nnz[half:], snap.overflow[half:])
        snap = assoc.add(a, b, cap=cap, sr=sr)
        p = half
    return Assoc(snap.rows[0], snap.cols[0], snap.vals[0], snap.nnz[0], snap.overflow[0])


# ---------------------------------------------------------------------------
# hash routing: one global triple stream -> K instance sub-streams
# ---------------------------------------------------------------------------

_H1 = 0x9E3779B1  # golden-ratio multiplicative constants
_H2 = 0x85EBCA77
_M1 = 0x7FEB352D  # murmur-style finalizer multipliers
_M2 = 0x846CA68B
_MASK = 0xFFFFFFFF

#: Width of the routing hash (see the reference's ``KEY_HASH_BITS``).
KEY_HASH_BITS = 32


def _mul32(x: torch.Tensor, h: int) -> torch.Tensor:
    """``(x * h) mod 2**32`` for ``0 <= x < 2**32`` in int64, split into
    16-bit halves of ``h`` so no int64 product overflows."""
    hi = ((x * (h >> 16)) & 0xFFFF) << 16
    return (hi + x * (h & 0xFFFF)) & _MASK


def key_hash32(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The finalized 32-bit key hash every routing tier reads, with uint32
    wraparound computed in int64.  Returns int64 values in ``[0, 2**32)``."""
    r = rows.to(torch.int64) & _MASK
    c = cols.to(torch.int64) & _MASK
    x = (_mul32(r, _H1) + _mul32(c, _H2)) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def instance_of(rows: torch.Tensor, cols: torch.Tensor, n_instances: int) -> torch.Tensor:
    """Which of ``n_instances`` owns key ``(row, col)``: the hash modulo K."""
    return (key_hash32(rows, cols) % int(n_instances)).to(torch.int32)


def scatter_to_slots(
    owner: torch.Tensor,
    live: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_slots: int,
    slot_cap: int,
    sr: Semiring = PLUS_TIMES,
):
    """Stable sort-scatter of a triple batch into ``[n_slots, slot_cap]``;
    triples beyond ``slot_cap`` in one slot are counted in ``dropped``."""
    owner = torch.where(live, owner, n_slots)  # park dead entries
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order].contiguous()
    idx = torch.arange(rows.shape[0], device=rows.device)
    rank = idx - torch.searchsorted(owner_s, owner_s)
    live_s = live[order]
    dropped = ((rank >= slot_cap) & live_s).sum(dtype=torch.int32)
    total = n_slots * slot_cap
    slot = torch.where((rank < slot_cap) & live_s, owner_s.to(torch.int64) * slot_cap + rank, total)

    def place(src, fill, dtype):
        out = torch.full((total + 1,), fill, dtype=dtype, device=rows.device)
        return out.scatter_(0, slot, src[order])[:total].reshape(n_slots, slot_cap)

    return (
        place(rows.to(torch.int32), PAD, torch.int32),
        place(cols.to(torch.int32), PAD, torch.int32),
        place(vals, sr.zero_as(vals.dtype), vals.dtype),
        dropped,
    )


def route_to_instances(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_instances: int,
    slot_cap: int,
    sr: Semiring = PLUS_TIMES,
):
    """Split one global triple batch into per-instance sub-batches:
    ``(rows, cols, vals, dropped)`` with ``[n_instances, slot_cap]`` shapes."""
    owner = instance_of(rows, cols, n_instances)
    live = rows != PAD
    return scatter_to_slots(owner, live, rows, cols, vals, n_instances, slot_cap, sr)
