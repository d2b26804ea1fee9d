"""Train / prefill / serve step factories (port of
``repro.launch.steps``).

``make_train_step`` runs microbatched gradient accumulation (a loop over
microbatches, float32 accumulators) around the model's rematerialised
forward and backward, then the AdamW update.  Gradient compression (top-k
with error feedback) optionally wraps the accumulated gradients.

The steps are functions of the reference's state tree (``{"params",
"opt"[, "residual"]}``, the param tree's shape and leaf names), never of
``nn.Parameter``s: gradients come from ``torch.autograd.grad`` over the
param tree's leaves, so the tree, AdamW, checkpoints and
``models.convert`` carry it leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import serving as SV
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compression
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


def init_train_state(gen: torch.Generator, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Params from ``gen`` (see ``transformer.init_params``) and AdamW's
    zero moments, on ``device`` (``cuda`` unless given)."""
    params = TF.init_params(gen, cfg, device)
    return {"params": params, "opt": adamw.init(params)}


def value_and_grad(cfg: ModelConfig, ep_axis: Optional[str] = "model"):
    """``fn(params, tokens, labels, frontend) -> (loss, metrics, grads)``:
    ``train_loss`` and its gradient with respect to every leaf of the
    param tree (a leaf the loss does not reach, such as an aux-free
    router's bias, gets zeros, as ``jax.grad`` gives), in the tree's
    shape.  The loss and metrics come back detached."""

    def fn(params, tokens, labels, fe):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = TF.train_loss(
            tree_unflatten(params, leaves), cfg, tokens, labels, frontend_embeds=fe, ep_axis=ep_axis
        )
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(params, grads)

    return fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    n_micro: int = 1,
    ep_axis: Optional[str] = "model",
    comp_cfg: compression.CompressionConfig = compression.CompressionConfig(),
    dp_spec=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: tokens [GB, S], labels [GB, S], optional frontend [GB, P, d];
    ``GB`` a multiple of ``n_micro``.  ``dp_spec`` pins the microbatch
    reshape's sharding over a data-parallel mesh in the reference; the
    port has no such mesh yet."""
    if dp_spec is not None:
        raise NotImplementedError(
            "dp_spec (the data-parallel sharding of the microbatch reshape) belongs to the sharding "
            "slice of the port (models/sharding.py, launch/mesh.py), which is not ported yet"
        )
    grad_fn = value_and_grad(cfg, ep_axis)

    def train_step(state, batch):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        fe = batch.get("frontend")
        if n_micro == 1:
            loss, metrics, grads = grad_fn(params, tokens, labels, fe)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
        else:
            mb = tokens.shape[0] // n_micro
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            losses, nlls = [], []
            for i in range(n_micro):
                sl = slice(i * mb, (i + 1) * mb)
                loss_m, metrics_m, g = grad_fn(params, tokens[sl], labels[sl], None if fe is None else fe[sl])
                grads = tree_unflatten(
                    grads, [a + gg.to(torch.float32) for a, gg in zip(tree_leaves(grads), tree_leaves(g))]
                )
                losses.append(loss_m)
                nlls.append(metrics_m["nll"])
                del g
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = torch.stack(losses).mean()
            metrics = {"nll": torch.stack(nlls).mean()}
        if comp_cfg.enabled:
            grads, residual = compression.compress(grads, state["residual"], comp_cfg)
        new_params, new_opt, opt_metrics = adamw.update(grads, state["opt"], params, opt_cfg)
        new_state = {"params": new_params, "opt": new_opt}
        if comp_cfg.enabled:
            new_state["residual"] = residual
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, ep_axis: Optional[str] = "model"):
    """Full-sequence forward emitting last-position logits only (serving
    samples from the last position)."""

    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _, _ = TF.forward(
                params, cfg, batch["tokens"], batch.get("frontend"), ep_axis=ep_axis, remat=False, last_only=True
            )
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, ep_axis: Optional[str] = "model"):
    """One-token decode against the static cache (updated in place)."""

    def serve_step(params, cache, token):
        with torch.no_grad():
            return SV.decode_step(params, cfg, cache, token, ep_axis=ep_axis)

    return serve_step
