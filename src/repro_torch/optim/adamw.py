"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

Parameters, gradients and optimizer moments are nested dicts (lists and
tuples too) of tensors.  Leaves are taken in JAX's order, dict keys
sorted, because the global norm sums the leaves in that order.  Every
function returns new tensors; nothing is updated in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted; ``None``
    is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in ``tree``'s structure."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)
    in place of its own."""
    return _build(tree, iter(leaves))


def _build(t, it):
    # a module-level function: a recursive closure would be a reference
    # cycle holding ``leaves`` until the cyclic collector ran
    if t is None:
        return None
    if isinstance(t, dict):
        got = {k: _build(t[k], it) for k in sorted(t)}
        return {k: got[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def init(params) -> Dict[str, Any]:
    """Zero float32 moments beside each parameter, and step 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac * lr`` (float32)."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def leaf_update(p, g, m, v, lr, b1c, b2c, cfg: AdamWConfig):
    """One leaf's AdamW step (``g`` clipped, float32): the new parameter
    and moments.  A block of a sharded leaf takes the same step.

        m2 = b1 m + (1 - b1) g;  v2 = b2 v + (1 - b2) g g
        p2 = p - lr (m2 / b1c / (sqrt(v2 / b2c) + eps) + wd p)

    each operation as written, its temporaries updated in place (a few
    leaves of memory at once, not a dozen)."""
    m2 = cfg.b1 * m
    m2 += (1 - cfg.b1) * g
    v2 = cfg.b2 * v
    v2 += (1 - cfg.b2) * g * g
    p32 = p.to(torch.float32)
    den = v2 / b2c
    den.sqrt_()
    den += cfg.eps
    delta = m2 / b1c
    delta /= den
    del den
    delta += cfg.weight_decay * p32
    delta *= lr
    return (p32 - delta).to(p.dtype), m2, v2


def update(grads, opt_state, params, cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns ``(new_params, new_opt_state, metrics)``;
    each leaf's gradient is clipped (``clip_by_global_norm``'s scale) as
    it is stepped, so no clipped copy of the whole tree is held."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    # flatten/unflatten, as the reference does
    leaves_p = tree_leaves(params)
    res = [
        leaf_update(p, g.to(torch.float32) * scale, m, v, lr, b1c, b2c, cfg)
        for p, g, m, v in zip(
            leaves_p, tree_leaves(grads), tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])
        )
    ]
    new_params = tree_unflatten(params, [r[0] for r in res])
    new_m = tree_unflatten(params, [r[1] for r in res])
    new_v = tree_unflatten(params, [r[2] for r in res])
    return new_params, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}
