"""Gradient compression hooks for the data-parallel all-reduce (port of
``repro.optim.compression``).

Top-k sparsification with error feedback: only the largest-magnitude k
fraction of each gradient tensor would cross the interconnect; the
residual is fed back into the next step's gradient (Stich et al.,
memory-compensated SGD).  A top-k-sparsified gradient is a hypersparse
update stream, and the residual plays the role of the hierarchy's fast
layer.

The threshold is the k-th largest ``|g|`` as a value, so the order of ties
does not matter: every entry at the threshold is kept.  ``sparse +
residual == g + old_residual`` holds exactly (each entry is kept whole or
left whole in the residual).
"""
from __future__ import annotations

import dataclasses

import torch

from .adamw import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    top_k_frac: float = 0.01  # fraction of entries communicated
    min_size: int = 16_384  # don't compress small tensors


def init_error_feedback(params):
    """Zero float32 residuals beside each parameter."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    thresh = torch.topk(x.reshape(-1).abs(), k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def compress(grads, residual, cfg: CompressionConfig):
    """Returns ``(sparse_grads, new_residual)``; ``sparse + residual ==
    grads + old residual`` (lossless bookkeeping; only ``sparse`` would
    cross the wire)."""
    if not cfg.enabled:
        return grads, residual

    def one(g, r):
        g = g.to(torch.float32) + r
        if g.numel() < cfg.min_size:
            return g, torch.zeros_like(g)
        k = max(1, int(g.numel() * cfg.top_k_frac))
        sparse = g * _topk_mask(g, k)
        return sparse, g - sparse

    res = [one(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    return tree_unflatten(grads, [t[0] for t in res]), tree_unflatten(grads, [t[1] for t in res])


def comm_bytes_saved(params, cfg: CompressionConfig) -> int:
    """Napkin accounting of the float32 bytes compression keeps off the
    wire."""
    if not cfg.enabled:
        return 0
    return sum(
        int(p.numel() * 4 * (1 - cfg.top_k_frac)) for p in tree_leaves(params) if p.numel() >= cfg.min_size
    )
