"""Network analytics on associative arrays (port of ``repro.core.analytics``).

The paper's statistics, written as associative-array algebra:

* degrees and top-k heavy hitters: row/col reductions;
* triangle counts: tr(A^3)/6 by a masked semiring matmul;
* common neighbours and Jaccard similarity of vertex pairs;
* k-step reachability: repeated (+).(x) under the boolean-like max.min.

Every output carries an explicit capacity, as in the reference.  On the
card the folds run in the ``merge_add`` and ``sort_dedup`` kernels, through
:mod:`repro_torch.core.assoc`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import assoc
from .assoc import PAD, Assoc
from .semiring import MAX_MIN, PLUS_TIMES, Semiring

# analytics that are counts: defined only over a counting semiring whose
# add/mul are arithmetic +/x with identities 0/1
_COUNTING_SEMIRINGS = ("plus.times", "count")


def _require_counting(sr: Semiring, what: str) -> None:
    if sr.name not in _COUNTING_SEMIRINGS:
        raise ValueError(
            f"{what} computes a count and is only defined over the counting "
            f"semirings {_COUNTING_SEMIRINGS}; got {sr.name!r}.  Rebuild the "
            f"array over the boolean support first (e.g. "
            f"undirected_view(a, sr=PLUS_TIMES)) and call with a counting "
            f"semiring."
        )


def degrees(
    a: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES
) -> Tuple[Assoc, Assoc]:
    """(out_degree, in_degree) keyed ``(vertex, 0)``, each folded with
    ``sr.add``."""
    return assoc.reduce_rows(a, cap, sr), assoc.reduce_cols(a, cap, sr)


def top_k_vertices(deg: Assoc, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heaviest-k vertices from a degree array: (ids [k], counts [k])."""
    return deg.topk(k)


def host_degree_fold(sr: Semiring):
    """The numpy ufunc matching ``sr.add`` for host-side degree folding, or
    ``None`` when the semiring's add has no associative-commutative numpy
    counterpart (``first``)."""
    family = sr.name.split(".", 1)[0]
    if family in ("plus", "count"):
        return np.add
    if family == "max":
        return np.maximum
    if family == "min":
        return np.minimum
    return None


def degrees_from_vectors(
    out_ids, out_vals, in_ids, in_vals, cap: int, sr: Semiring, dtype=torch.float32,
    device=None,
) -> Tuple[Assoc, Assoc]:
    """Lift host-maintained degree vectors (unique ids) into the ``(vertex,
    0)`` arrays :func:`degrees` produces, on the card unless
    ``device="cpu"``.  The vectors are PAD-padded to a power-of-two bucket
    (at least 256) before the lift, as in the reference."""
    device = resolve_device(device)

    def lift(ids, vals):
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float64)
        n = int(ids.shape[0])
        bucket = max(256, 1 << max(0, n - 1).bit_length())
        if bucket > n:
            ids = np.concatenate([ids, np.full(bucket - n, PAD, np.int32)])
            vals = np.concatenate([vals, np.full(bucket - n, sr.zero_as(dtype), np.float64)])
        ids = torch.tensor(ids, device=device)
        vals = torch.tensor(vals, device=device).to(dtype)
        return assoc.from_triples(ids, torch.zeros_like(ids), vals, cap, sr=sr)

    return lift(out_ids, out_vals), lift(in_ids, in_vals)


def undirected_view(a: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES) -> Assoc:
    """``A (+) A^T`` with weights collapsed to ``sr.one``: the symmetric
    support; dead slots hold ``sr.zero``."""
    cap = cap or 2 * a.capacity
    sym = assoc.add(a, assoc.transpose(a, sr=sr), cap=cap, sr=sr)
    ones = torch.where(
        sym.rows != PAD,
        torch.full_like(sym.vals, sr.one_as(sym.vals.dtype)),
        torch.full_like(sym.vals, sr.zero_as(sym.vals.dtype)),
    )
    return Assoc(sym.rows, sym.cols, ones, sym.nnz, sym.overflow)


def triangle_count(
    a: Assoc, cap_sq: int, max_fanout: int, sr: Semiring = PLUS_TIMES
) -> torch.Tensor:
    """Triangles of the undirected simple graph supported by ``a``:
    ``sum(A^2 (x) A) / 6``.  ``cap_sq`` bounds nnz(A^2), ``max_fanout`` the
    join width; ``sr`` must be a counting semiring."""
    _require_counting(sr, "triangle_count")
    sq = assoc.matmul(a, a, cap=cap_sq, max_fanout=max_fanout, sr=sr)
    masked = assoc.elem_mul(sq, a, cap=cap_sq, sr=sr)
    live = masked.rows != PAD
    return torch.where(live, masked.vals, torch.zeros_like(masked.vals)).sum() / 6.0


def _neighbor_set(a: Assoc, u: int, cap: int) -> Assoc:
    """N(u) as a unit-weight row vector keyed ``(0, neighbour)``."""
    r = assoc.extract_row(a, u, cap)
    live = r.rows != PAD
    return assoc.from_triples(
        torch.zeros_like(r.rows), r.cols, torch.ones_like(r.vals), cap, valid=live
    )


def common_neighbors(a: Assoc, u: int, v: int, cap: int, sr: Semiring = PLUS_TIMES) -> torch.Tensor:
    """``|N(u) ∩ N(v)|`` by row extraction and intersection (a count:
    ``sr`` must be a counting semiring)."""
    _require_counting(sr, "common_neighbors")
    inter = assoc.elem_mul(_neighbor_set(a, u, cap), _neighbor_set(a, v, cap), cap=cap, sr=sr)
    return inter.nnz.to(torch.float32)


def jaccard(a: Assoc, u: int, v: int, cap: int, sr: Semiring = PLUS_TIMES) -> torch.Tensor:
    """Jaccard similarity of the neighbourhoods of ``u`` and ``v`` (a ratio
    of counts: ``sr`` must be a counting semiring)."""
    _require_counting(sr, "jaccard")
    ru = assoc.extract_row(a, u, cap)
    rv = assoc.extract_row(a, v, cap)
    inter = common_neighbors(a, u, v, cap, sr=sr)
    union = ru.nnz + rv.nnz - inter
    return inter / torch.clamp(union, min=1.0)


def reachable_within(
    a: Assoc, steps: int, cap: int, max_fanout: int, sr: Semiring = MAX_MIN
) -> Assoc:
    """k-step reachability closure ``R_k = R_{k-1} (+) R_{k-1} A`` over
    ``{sr.zero, sr.one}``: reachable pairs hold ``sr.one``."""
    dt = a.vals.dtype
    ones = torch.where(
        a.rows != PAD, torch.full_like(a.vals, sr.one_as(dt)), torch.full_like(a.vals, sr.zero_as(dt))
    )
    r = Assoc(a.rows, a.cols, ones, a.nnz, a.overflow)
    base = r
    for _ in range(steps - 1):
        nxt = assoc.matmul(r, base, cap=cap, max_fanout=max_fanout, sr=sr)
        r = assoc.add(r, nxt, cap=cap, sr=sr)
    return r
