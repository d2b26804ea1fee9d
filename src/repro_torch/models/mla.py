"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of
``repro.models.mla``).

Queries and keys/values come through low-rank latents; the decode cache
holds ``(c_kv [B, S, r], k_rope [B, S, dr])`` only, and the latent is
up-projected to per-head K (nope) and V at attention time
(:func:`apply_mla`), or W_uk and W_uv are folded into the query and the
output projection so all S-proportional work stays in the r-dim latent
space (:func:`apply_mla_absorbed`).  The two are algebraically identical.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import BIG_NEG, _dense_init, apply_norm, apply_rope, flash_attention, init_norm

Params = Dict[str, Any]


def init_mla(gen, cfg: ModelConfig, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wdq": _dense_init(gen, (d, m.q_lora_rank), device),
        "q_norm": init_norm(cfg, m.q_lora_rank, device),
        "wuq": _dense_init(gen, (m.q_lora_rank, h * qk), device),
        "wdkv": _dense_init(gen, (d, m.kv_lora_rank), device),
        "wk_rope": _dense_init(gen, (d, m.qk_rope_dim), device),
        "kv_norm": init_norm(cfg, m.kv_lora_rank, device),
        "wukv": _dense_init(gen, (m.kv_lora_rank, h * (m.qk_nope_dim + m.v_head_dim)), device),
        "wo": _dense_init(gen, (h * m.v_head_dim, d), device),
    }


def _queries(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """``(q_nope, q_rope)`` [B, Sq, H, nope] and [B, Sq, H, dr], rope'd."""
    m = cfg.mla
    B, Sq, _ = x.shape
    q_lat = apply_norm(p["q_norm"], torch.einsum("bsd,dr->bsr", x, p["wdq"].to(x.dtype)))
    q = torch.einsum("bsr,rh->bsh", q_lat, p["wuq"].to(x.dtype))
    q = q.reshape(B, Sq, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def absorbed_scores(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                    latents: Tuple[torch.Tensor, torch.Tensor]):
    """The absorbed decode's scaled scores [B, H, Sq, Sk] (W_uk folded into
    the query) and W_uv [r, H, v] for :func:`absorbed_out`."""
    m = cfg.mla
    h = cfg.n_heads
    c_kv, k_rope = latents
    q_nope, q_rope = _queries(p, cfg, x, positions)
    wukv = p["wukv"].to(x.dtype).reshape(m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim)
    wuk, wuv = wukv[..., : m.qk_nope_dim], wukv[..., m.qk_nope_dim :]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, wuk)  # absorb W_uk into q
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    scores = (
        torch.einsum("bshr,btr->bhst", q_abs, c_kv) + torch.einsum("bshe,bte->bhst", q_rope, k_rope)
    ) * scale
    return scores, wuv


def absorbed_out(p: Params, cfg: ModelConfig, ctx_lat: torch.Tensor, wuv: torch.Tensor) -> torch.Tensor:
    """The latent context [B, Sq, H, r] through W_uv and ``wo``."""
    B, Sq, h, _ = ctx_lat.shape
    ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, wuv).reshape(B, Sq, h * cfg.mla.v_head_dim)
    return torch.einsum("bsh,hd->bsd", ctx, p["wo"].to(ctx.dtype))


def apply_mla_absorbed(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, 1, d] (decode)
    positions: torch.Tensor,  # [B, 1]
    mask: torch.Tensor,  # [B, 1, Sk] bool
    latents: Tuple[torch.Tensor, torch.Tensor],  # cached (c_kv [B,S,r], k_rope [B,S,dr])
) -> torch.Tensor:
    """Absorbed-matmul MLA decode:

        scores = (q_nope W_uk^T) . c_kv + q_rope . k_rope
        ctx    = (probs . c_kv) W_uv
    """
    scores, wuv = absorbed_scores(p, cfg, x, positions, latents)
    if mask is not None:
        scores = torch.where(mask[:, None, :, :], scores, BIG_NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, latents[0])  # stay in latent space
    return absorbed_out(p, cfg, ctx_lat, wuv)


def mla_latents(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """The cacheable latents of a token block: (c_kv, k_rope)."""
    c_kv = apply_norm(p["kv_norm"], torch.einsum("bsd,dr->bsr", x, p["wdkv"].to(x.dtype)))
    k_rope = torch.einsum("bsd,dr->bsr", x, p["wk_rope"].to(x.dtype))
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _up_project(p: Params, cfg: ModelConfig, c_kv: torch.Tensor, dtype):
    """The latents [B, Sk, r] up-projected through ``wukv`` (its columns
    for ``cfg.n_heads`` heads): ``(k_nope, v)`` [B, Sk, H, nope] and
    [B, Sk, H, v]."""
    m = cfg.mla
    kv = torch.einsum("btr,rh->bth", c_kv, p["wukv"].to(dtype))
    kv = kv.reshape(c_kv.shape[0], c_kv.shape[1], cfg.n_heads, m.qk_nope_dim + m.v_head_dim)
    return kv[..., : m.qk_nope_dim], kv[..., m.qk_nope_dim :]


def naive_scores(p: Params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                 latents: Tuple[torch.Tensor, torch.Tensor]):
    """The naive form's scaled scores [B, H, Sq, Sk] (the latents
    up-projected to per-head K) and its values V [B, Sk, H, v] for
    :func:`naive_out`."""
    m = cfg.mla
    c_kv, k_rope = latents
    q_nope, q_rope = _queries(p, cfg, x, positions)
    k_nope, v = _up_project(p, cfg, c_kv, x.dtype)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    scores = (
        torch.einsum("bsnh,btnh->bnst", q_nope, k_nope)
        + torch.einsum("bsnh,bth->bnst", q_rope, k_rope)  # rope key shared per head
    ) * scale
    return scores, v


def naive_context(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Probabilities [B, H, Sq, Sk] over the values [B, Sk, H, v]: the
    context [B, Sq, H, v]."""
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def naive_out(p: Params, ctx: torch.Tensor) -> torch.Tensor:
    """The context [B, Sq, H, v] through ``wo``."""
    B, Sq = ctx.shape[:2]
    return torch.einsum("bsh,hd->bsd", ctx.reshape(B, Sq, -1), p["wo"].to(ctx.dtype))


def apply_mla(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # [B, Sq, d]
    positions: torch.Tensor,  # [B, Sq]
    mask: Optional[torch.Tensor],  # [B, Sq, Sk] bool (None = no masking)
    latents: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cached (c_kv, k_rope)
    flash: Optional[dict] = None,  # {causal, window, prefix_len}
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    m = cfg.mla
    B, Sq, d = x.shape
    h = cfg.n_heads
    if latents is None:
        latents = mla_latents(p, cfg, x, positions)
    if flash is None:
        scores, v = naive_scores(p, cfg, x, positions, latents)
        if mask is not None:
            scores = torch.where(mask[:, None, :, :], scores, BIG_NEG)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        return naive_out(p, naive_context(probs, v)), latents
    c_kv, k_rope = latents  # [B, Sk, r], [B, Sk, dr]
    q_nope, q_rope = _queries(p, cfg, x, positions)
    k_nope, v = _up_project(p, cfg, c_kv, x.dtype)
    # fold the shared rope key into per-head keys: scores = qf . kf
    Sk = k_nope.shape[1]
    qf = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]  # g=1
    kf = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, Sk, h, m.qk_rope_dim)], dim=-1)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    ctx = flash_attention(qf, kf, v, positions, positions, scale=scale, **flash)
    return naive_out(p, ctx.reshape(B, Sq, h, m.v_head_dim)), latents
