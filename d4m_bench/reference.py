"""The plain reference: what a D4M session has to hold and answer, worked
out again from the generated stream alone.

Plain PyTorch, on whatever device the stream lies on; it imports nothing
of the program.  Keys are packed as ``row * 2**32 + col`` in int64 and every
sum is taken in float64, in which counts of weight 1.0 are exact.
"""
from __future__ import annotations

from typing import Dict

import torch


def pack(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys ``row * 2**32 + col`` (non-negative int32 ids sort as
    ``(row, col)`` pairs)."""
    return (rows.to(torch.int64) << 32) | (cols.to(torch.int64) & 0xFFFFFFFF)


def fold(keys: torch.Tensor, vals: torch.Tensor):
    """``(unique keys sorted, float64 sum of the values of each)``."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.float64, device=keys.device)
    return uniq, sums.index_add_(0, inv, vals.to(torch.float64))


def key_sums(src: torch.Tensor, dst: torch.Tensor, vals: torch.Tensor):
    """The associative array of the stream's edges: each distinct
    ``(src, dst)`` key with the sum of its weights (plus.times)."""
    return fold(pack(src.reshape(-1), dst.reshape(-1)), vals.reshape(-1))


def compare_sums(got_keys, got_sums, want_keys, want_sums) -> Dict[str, float]:
    """Keys present on one side only, and the widest gap of a value over the
    keys both hold."""
    if want_keys.numel() == 0 or got_keys.numel() == 0:
        return {"keys_wrong": float(got_keys.numel() + want_keys.numel()), "value_err": 0.0}
    idx = torch.searchsorted(got_keys, want_keys).clamp(max=got_keys.numel() - 1)
    hit = got_keys[idx] == want_keys
    missing = int((~hit).sum())
    extra = int(got_keys.numel()) - int(hit.sum())
    gap = (got_sums[idx[hit]] - want_sums[hit]).abs()
    return {"keys_wrong": float(missing + extra),
            "value_err": float(gap.max()) if gap.numel() else 0.0}


def out_degrees(src: torch.Tensor, vals: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """float64 ``[n_vertices]``: each vertex's summed out-edge weight."""
    return torch.bincount(src.reshape(-1).to(torch.int64), weights=vals.reshape(-1).to(torch.float64),
                          minlength=int(n_vertices))


def top_k_wrong(deg: torch.Tensor, ids, counts, k: int) -> bool:
    """Whether an answer ``(ids [k], counts [k])`` is not a heaviest-k list of
    ``deg``: its counts must be the k largest degrees in order, and each id
    a distinct vertex of that degree (any of those tied at the k-th place)."""
    ids = torch.as_tensor(ids, dtype=torch.int64).to(deg.device)
    counts = torch.as_tensor(counts).to(deg.device, torch.float64)
    want = torch.topk(deg, int(k)).values
    if ids.shape != (k,) or counts.shape != (k,):
        return True
    if not bool(torch.equal(counts, want)):
        return True
    if bool(((ids < 0) | (ids >= deg.numel())).any()):
        return True
    if torch.unique(ids).numel() != k:
        return True
    return not bool(torch.equal(deg[ids], counts))
