"""Hierarchical associative arrays (port of ``repro.core.hierarchical``).

An N-layer cascade ``A_1 ... A_N`` with cuts ``c_1 < ... < c_{N-1}``: a
batch is added to ``A_1``; whenever ``nnz(A_i) > c_i`` the layer is
semiring-added into ``A_{i+1}`` and cleared.  Capacities telescope
(``cap_1 = c_1 + batch``, ``cap_i = c_i + cap_{i-1}``,
``cap_N = top + cap_{N-1}``) exactly as in the reference.

Two forms of :func:`update`, as in the reference:

* the cond form tests each cut with a Python ``if``.  On the card that
  reads ``nnz`` back to the host and so synchronises with the device on
  every cut of every step.  That is accepted for the ``single`` engine and
  for the kernel's plain version; the ``cuda`` engine keeps the predicate
  on the device, inside its kernel;
* the branchless form computes every cascade merge and selects with
  ``torch.where``; it takes leading instance axes, which is how the
  ``packed`` engine writes the reference's ``vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from ..device import resolve_device
from . import assoc
from .assoc import Assoc
from .semiring import PLUS_TIMES, Semiring


@dataclasses.dataclass
class HierAssoc:
    """N-layer hierarchical associative array (leaves may carry a leading
    ``[K]`` instance axis)."""

    layers: Tuple[Assoc, ...]
    cascades: torch.Tensor  # int32[..., N]: cascades that reached each layer

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"HierAssoc(caps={[l.capacity for l in self.layers]})"


def geometric_cuts(c1: int, ratio: int, n_layers: int) -> Tuple[int, ...]:
    """The paper's cut schedule: ``c_i = c1 * ratio^(i-1)``."""
    return tuple(int(c1 * ratio**i) for i in range(n_layers - 1))


def telescoped_caps(
    cuts: Sequence[int], top_capacity: int, batch_size: int
) -> Tuple[int, ...]:
    """Per-layer capacities: the single source of truth for :func:`init`,
    the capacity planner and the kernel's shape contract."""
    caps = []
    below = int(batch_size)
    for c in cuts:
        caps.append(int(c) + below)
        below = caps[-1]
    caps.append(int(top_capacity) + below)
    return tuple(caps)


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def pad_tail(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    """``x`` grown along its last axis to ``width`` with ``fill``."""
    pad = width - x.shape[-1]
    if pad == 0:
        return x
    tail = torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=-1)


def pad_layers_pow2(h: HierAssoc, sr: Semiring = PLUS_TIMES) -> HierAssoc:
    """Grow every layer buffer to the next power of two (PAD keys and
    semiring-zero values in the tail): the layout the kernel engine keeps.
    The live prefix, ``nnz`` and ``overflow`` are unchanged."""
    layers = []
    for l in h.layers:
        q = _next_pow2(l.capacity)
        layers.append(
            Assoc(
                rows=pad_tail(l.rows, q, assoc.PAD),
                cols=pad_tail(l.cols, q, assoc.PAD),
                vals=pad_tail(l.vals, q, sr.zero_as(l.vals.dtype)),
                nnz=l.nnz,
                overflow=l.overflow,
            )
        )
    return HierAssoc(layers=tuple(layers), cascades=h.cascades)


def init(
    cuts: Sequence[int],
    top_capacity: int,
    batch_size: int,
    sr: Semiring = PLUS_TIMES,
    dtype=torch.float32,
    device=None,
    batch: Tuple[int, ...] = (),
    pad_pow2: bool = False,
) -> HierAssoc:
    """An empty N-layer hierarchy, on the card unless ``device="cpu"``
    (``batch`` prepends instance axes; ``pad_pow2`` allocates the reference
    kernel's power-of-two widths directly)."""
    device = resolve_device(device)
    cuts = tuple(int(c) for c in cuts)
    if any(b <= a for a, b in zip(cuts, cuts[1:])):
        raise ValueError(f"cuts must be strictly increasing, got {cuts}")
    caps = telescoped_caps(cuts, top_capacity, batch_size)
    widths = [_next_pow2(c) if pad_pow2 else c for c in caps]
    layers = tuple(assoc.empty(w, sr, dtype, device, batch) for w in widths)
    cascades = torch.zeros(tuple(batch) + (len(caps),), dtype=torch.int32, device=device)
    return HierAssoc(layers=layers, cascades=cascades)


def _select_assoc(pred: torch.Tensor, a: Assoc, b: Assoc) -> Assoc:
    """Per-leaf ``where(pred, a, b)`` for whole arrays; ``pred`` has the
    batch shape."""
    p = pred.unsqueeze(-1)
    return Assoc(
        rows=torch.where(p, a.rows, b.rows),
        cols=torch.where(p, a.cols, b.cols),
        vals=torch.where(p, a.vals, b.vals),
        nnz=torch.where(pred, a.nnz, b.nnz),
        overflow=torch.where(pred, a.overflow, b.overflow),
    )


def update(
    h: HierAssoc,
    batch: Assoc,
    cuts: Sequence[int],
    sr: Semiring = PLUS_TIMES,
    *,
    branchless: bool = False,
) -> HierAssoc:
    """One streaming update: ``A_1 += batch`` then cascade (paper's HierAdd)."""
    cuts = tuple(int(c) for c in cuts)
    layers = list(h.layers)
    cascades = h.cascades.clone()
    layers[0] = assoc.add(layers[0], batch, cap=layers[0].capacity, sr=sr)
    for i, cut in enumerate(cuts):
        src, dst = layers[i], layers[i + 1]
        pred = src.nnz > cut
        if branchless:
            merged = assoc.add(dst, src, cap=dst.capacity, sr=sr)
            cleared = assoc.empty(src.capacity, sr, src.vals.dtype, src.rows.device, src.nnz.shape)
            layers[i + 1] = _select_assoc(pred, merged, dst)
            layers[i] = _select_assoc(pred, cleared, src)
            cascades[..., i + 1] += pred.to(torch.int32)
        elif bool(pred):  # host sync: see the module docstring
            layers[i + 1] = assoc.add(dst, src, cap=dst.capacity, sr=sr)
            layers[i] = assoc.empty(src.capacity, sr, src.vals.dtype, src.rows.device)
            cascades[i + 1] += 1
    return HierAssoc(layers=tuple(layers), cascades=cascades)


def update_triples(
    h: HierAssoc,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Sequence[int],
    sr: Semiring = PLUS_TIMES,
    valid: torch.Tensor | None = None,
    *,
    branchless: bool = False,
) -> HierAssoc:
    """Ingest a raw triple batch (canonicalize it, then :func:`update`)."""
    batch = assoc.from_triples(rows, cols, vals, cap=rows.shape[-1], sr=sr, valid=valid)
    return update(h, batch, cuts, sr, branchless=branchless)


def snapshot(h: HierAssoc, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """``A = sum_i A_i``: the full array for analysis."""
    out = h.layers[-1]
    for layer in reversed(h.layers[:-1]):
        out = assoc.add(out, layer, cap=cap, sr=sr)
    return out


def nnz_total(h: HierAssoc) -> torch.Tensor:
    """Sum of per-layer nnz (keys may repeat across layers)."""
    return sum(l.nnz for l in h.layers)


def overflowed(h: HierAssoc) -> torch.Tensor:
    out = h.layers[0].overflow
    for l in h.layers[1:]:
        out = out | l.overflow
    return out


def memory_bytes(h: HierAssoc) -> int:
    """Static memory footprint of the layer buffers."""
    return sum(
        l.rows.numel() * 4 + l.cols.numel() * 4 + l.vals.numel() * l.vals.element_size()
        for l in h.layers
    )
