"""Mixture-of-Experts layer with sort-based token dispatch (port of the
local path of ``repro.models.moe``).

Router logits -> top-k experts a token; the ``T*k`` assignments are ranked
within their expert by a stable argsort, those under capacity are written
into an ``[E, C, d]`` buffer, the expert FFNs run as grouped einsums, and
each token gathers its k outputs weighted by its router gates.  Dropped
tokens (over capacity) contribute zero and are counted in the aux
telemetry.  Router load statistics come out as associative-array triples
(:func:`router_stats_triples`).

The expert-parallel ``shard_map`` path (``apply_moe_shardmap``,
``apply_moe_ep_local``) belongs to the sharding slice of the port: with
``EP_CONTEXT`` set, :func:`apply_moe` raises rather than running the local
path in its place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import _dense_init

Params = Dict[str, Any]

EP_CONTEXT = {"mesh": None, "dp": None}  # set by a launcher (the sharding slice)


def init_moe(gen, cfg: ModelConfig, device) -> Params:
    m = cfg.moe
    d, f = cfg.d_model, m.d_expert
    p = {
        "router": _dense_init(gen, (d, m.n_experts), device),
        "wg": _dense_init(gen, (m.n_experts, d, f), device),
        "wu": _dense_init(gen, (m.n_experts, d, f), device),
        "wd": _dense_init(gen, (m.n_experts, f, d), device),
    }
    if m.n_shared:
        p["shared"] = {
            "wg": _dense_init(gen, (d, m.n_shared * f), device),
            "wu": _dense_init(gen, (d, m.n_shared * f), device),
            "wd": _dense_init(gen, (m.n_shared * f, d), device),
        }
    if m.router_aux_free:
        p["router_bias"] = torch.zeros((m.n_experts,), device=device)
    return p


def _capacity(m: MoEConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, ((c + 7) // 8) * 8)  # pad to vector-lane multiple


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: ties keep the lower index first
    (a stable descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, S, d]
    ep_axis: Optional[str] = "model",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (out [B, S, d], aux telemetry dict)."""
    if ep_axis is not None and EP_CONTEXT["mesh"] is not None:
        raise NotImplementedError(
            "expert-parallel MoE (apply_moe_shardmap over EP_CONTEXT's mesh) belongs to the "
            "sharding slice of the port (models/sharding.py), which is not ported yet"
        )
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    xt = x.reshape(T, d)
    logits = torch.einsum("td,de->te", xt, p["router"].to(x.dtype))
    logits = logits.float() * m.router_scale
    gates = torch.softmax(logits, dim=-1)
    select_scores = logits + p["router_bias"] if m.router_aux_free else logits
    _, top_idx = top_k(select_scores, k)  # [T, k]
    top_gates = torch.gather(gates, 1, top_idx)  # [T, k]
    top_gates = top_gates / (top_gates.sum(-1, keepdim=True) + 1e-9)

    # ---- dispatch: rank within expert, drop over capacity
    C = _capacity(m, T)
    flat_expert = top_idx.reshape(T * k)  # [A]
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    arange_a = torch.arange(T * k, dtype=torch.int64, device=x.device)
    run_start = torch.searchsorted(sorted_expert, sorted_expert, side="left")
    rank = torch.empty_like(arange_a).index_copy_(0, order, arange_a - run_start)
    rank = rank.reshape(T, k)
    keep = rank < C  # [T, k]
    slot = torch.where(keep, top_idx * C + rank, E * C)  # a drop -> out of range

    # The reference's .at[slot].set(xt, mode="drop") drops out-of-range
    # slots; here they land in one extra row that is cut off (an index out
    # of range is an error in torch, and masking by a boolean index would
    # wait on the host)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    for kk in range(k):  # each token is written to up to k expert slots
        buf.index_copy_(0, slot[:, kk], xt)
    buf = buf[: E * C].reshape(E, C, d)

    # ---- expert FFN (grouped einsum)
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"].to(x.dtype)))
    u = torch.einsum("ecd,edf->ecf", buf, p["wu"].to(x.dtype))
    eo = torch.einsum("ecf,efd->ecd", g * u, p["wd"].to(x.dtype)).reshape(E * C, d)

    # ---- combine
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        safe = torch.clamp(slot[:, kk], max=E * C - 1)
        contrib = eo[safe] * top_gates[:, kk : kk + 1].to(x.dtype)
        out = out + torch.where(keep[:, kk : kk + 1], contrib, 0)

    # ---- shared experts (always-on dense path)
    if "shared" in p:
        s = p["shared"]
        sg = F.silu(torch.einsum("td,df->tf", xt, s["wg"].to(x.dtype)))
        su = torch.einsum("td,df->tf", xt, s["wu"].to(x.dtype))
        out = out + torch.einsum("tf,fd->td", sg * su, s["wd"].to(x.dtype))

    # ---- telemetry: streaming load stats as associative-array triples
    load = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ones = torch.ones((T,), dtype=torch.float32, device=x.device)
    for kk in range(k):  # expert ids are always in range: nothing to drop
        load.index_add_(0, top_idx[:, kk], ones)
    importance = gates.sum(0)
    # Switch-style aux loss (used when not aux-free)
    aux_loss = E * torch.mean((load / (T * k)) * (importance / torch.clamp(importance.sum(), min=1e-9)))
    dropped = (T * k) - keep.sum()
    aux = {
        "expert_load": load,
        "moe_aux_loss": aux_loss,
        "moe_dropped": dropped.to(torch.int32),
    }
    return out.reshape(B, S, d), aux


def router_stats_triples(load: torch.Tensor, layer_idx: int):
    """Per-step expert load as (row=layer, col=expert, val=count) triples
    for the hierarchical associative-array telemetry stream."""
    e = load.shape[0]
    rows = torch.full((e,), layer_idx, dtype=torch.int32, device=load.device)
    cols = torch.arange(e, dtype=torch.int32, device=load.device)
    return rows, cols, load


def update_aux_free_bias(bias: torch.Tensor, load: torch.Tensor, lr: float = 1e-3) -> torch.Tensor:
    """DeepSeek-v3 aux-free balancing: nudge under-loaded experts up,
    over-loaded down (sign update on the violation)."""
    mean = load.mean()
    return bias + lr * torch.sign(mean - load)
