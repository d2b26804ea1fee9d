"""Analytic FLOP / HBM-byte model per (arch x shape) cell.

Why analytic: XLA's ``cost_analysis()`` counts while-loop *bodies once* —
under scan-over-layers + scan-over-microbatches (and the flash inner scans)
it under-reports executed FLOPs by orders of magnitude.  The model below is
exact for the matmul terms (which dominate) and is cross-checked against
cost_analysis on an unrolled single-layer program in tests/test_roofline.py.

Conventions:
* ``fwd`` FLOPs are for one full forward over the step's tokens.
* training executes ~4x fwd: backward = 2x, full-layer rematerialization
  adds ~1x (the policy the train step actually uses).
* decode counts one token per sequence against the current cache.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig


def _avg_ctx(S: int, window) -> float:
    """Average causal context length per query position."""
    if window is None or window >= S:
        return (S + 1) / 2
    # positions < window see pos; others see window
    return (window * (window + 1) / 2 + (S - window) * window) / S


def _attn_fwd(cfg: ModelConfig, T: float, S: int, window) -> float:
    d, H, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ctx = _avg_ctx(S, window)
    proj = 2 * T * d * (H * hd + 2 * kvh * hd) + 2 * T * H * hd * d
    attn = 2 * T * ctx * H * hd * 2  # scores + context
    return proj + attn


def _mla_fwd(cfg: ModelConfig, T: float, S: int) -> float:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    ctx = _avg_ctx(S, None)
    f = 2 * T * d * m.q_lora_rank + 2 * T * m.q_lora_rank * H * qk
    f += 2 * T * d * (m.kv_lora_rank + m.qk_rope_dim)
    f += 2 * T * m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
    f += 2 * T * ctx * H * qk + 2 * T * ctx * H * m.v_head_dim
    f += 2 * T * H * m.v_head_dim * d
    return f


def _ffn_fwd(cfg: ModelConfig, T: float, f_hidden: int) -> float:
    mult = 3 if cfg.act == "silu" else 2
    return 2 * T * cfg.d_model * f_hidden * mult


def _moe_fwd(cfg: ModelConfig, T: float) -> float:
    m = cfg.moe
    f = 2 * T * cfg.d_model * m.n_experts  # router
    f += _ffn_fwd(cfg, T * m.top_k * m.capacity_factor, m.d_expert)  # routed
    f += _ffn_fwd(cfg, T, m.n_shared * m.d_expert) if m.n_shared else 0.0
    return f


def _ssm_fwd(cfg: ModelConfig, T: float) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    H = di // s.head_dim
    N = s.d_state
    g = s.n_groups * N
    proj = 2 * T * d * (2 * di + 2 * g + H) + 2 * T * di * d
    conv = 2 * T * s.d_conv * (di + 2 * g)
    Q = s.chunk
    intra = 2 * T * Q * H * (N + s.head_dim)  # block scores + apply
    inter = 4 * T * s.head_dim * H * N / max(Q, 1) * Q  # state build+apply per token
    inter = 4 * T * H * s.head_dim * N  # simplify: 2 einsums over [hd, N]
    return proj + conv + intra + inter


def _head_fwd(cfg: ModelConfig, T: float) -> float:
    return 2 * T * cfg.d_model * cfg.vocab_padded


def fwd_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """One forward pass over batch x seq tokens (text positions)."""
    T = float(batch) * seq
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "ssm":
            total += _ssm_fwd(cfg, T)
        elif cfg.mla is not None:
            total += _mla_fwd(cfg, T, seq)
        else:
            w = None if cfg.layer_is_global_attn(i) else cfg.sliding_window
            total += _attn_fwd(cfg, T, seq, w)
        if cfg.layer_has_moe(i):
            total += _moe_fwd(cfg, T)
        elif cfg.d_ff > 0:
            total += _ffn_fwd(cfg, T, cfg.d_ff)
    if cfg.encoder_layers:
        Te = float(batch) * cfg.encoder_tokens
        for _ in range(cfg.encoder_layers):
            total += _attn_fwd(cfg, Te, cfg.encoder_tokens, None) + _ffn_fwd(cfg, Te, cfg.d_ff)
        # cross attention: queries T over encoder keys
        total += cfg.n_layers * (
            2 * T * cfg.d_model * 2 * cfg.n_kv_heads * cfg.hd
            + 2 * T * cfg.encoder_tokens * cfg.n_heads * cfg.hd * 2
            + 2 * T * cfg.n_heads * cfg.hd * cfg.d_model
        )
    total += _head_fwd(cfg, T)
    if cfg.mtp_depth:
        total += cfg.mtp_depth * (
            _mla_fwd(cfg, T, seq) if cfg.mla else _attn_fwd(cfg, T, seq, None)
        ) + cfg.mtp_depth * _head_fwd(cfg, T)
    return total


def decode_flops(cfg: ModelConfig, batch: int, pos: int) -> float:
    """One decode step at cache position ``pos``."""
    T = float(batch)
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "ssm":
            total += _ssm_decode(cfg, T)
        elif cfg.mla is not None:
            from repro_torch.models.serving import MLA_ABSORBED

            m = cfg.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            d, H = cfg.d_model, cfg.n_heads
            r = m.kv_lora_rank
            f = 2 * T * d * m.q_lora_rank + 2 * T * m.q_lora_rank * H * qk
            f += 2 * T * d * (r + m.qk_rope_dim)
            if MLA_ABSORBED["enabled"]:
                # absorbed matmuls: all S-proportional work in latent space
                f += 2 * T * H * m.qk_nope_dim * r  # q absorb
                f += 2 * T * pos * H * r + 2 * T * pos * H * m.qk_rope_dim  # scores
                f += 2 * T * pos * H * r  # ctx in latent space
                f += 2 * T * H * r * m.v_head_dim  # W_uv apply
            else:
                # naive: up-project the whole latent cache every step
                f += 2 * T * pos * r * H * (m.qk_nope_dim + m.v_head_dim)
                f += 2 * T * pos * H * qk + 2 * T * pos * H * m.v_head_dim
            f += 2 * T * H * m.v_head_dim * d
            total += f
        else:
            d, H, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
            w = None if cfg.layer_is_global_attn(i) else cfg.sliding_window
            ctx = pos if w is None else min(pos, w)
            total += (
                2 * T * d * (H * hd + 2 * kvh * hd)
                + 2 * T * H * hd * d
                + 2 * T * ctx * H * hd * 2
            )
        if cfg.layer_has_moe(i):
            m = cfg.moe
            total += 2 * T * cfg.d_model * m.n_experts
            total += _ffn_fwd(cfg, T * m.top_k, m.d_expert)
            if m.n_shared:
                total += _ffn_fwd(cfg, T, m.n_shared * m.d_expert)
        elif cfg.d_ff > 0:
            total += _ffn_fwd(cfg, T, cfg.d_ff)
    total += _head_fwd(cfg, T)
    return total


def _ssm_decode(cfg: ModelConfig, T: float) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    H = di // s.head_dim
    N = s.d_state
    return (
        2 * T * d * (2 * di + 2 * s.n_groups * N + H)
        + 2 * T * di * d
        + 4 * T * H * s.head_dim * N
    )


# ---------------------------------------------------------------------------
# HBM byte model
# ---------------------------------------------------------------------------

def param_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> float:
    return cfg.param_count() * dtype_bytes


def kv_cache_bytes(cfg: ModelConfig, batch: int, s_cap: int, dtype_bytes: int = 2) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "ssm":
            s = cfg.ssm
            di = s.expand * cfg.d_model
            H = di // s.head_dim
            total += batch * (H * s.head_dim * s.d_state + (s.d_conv - 1) * (di + 2 * s.n_groups * s.d_state)) * dtype_bytes
        elif cfg.mla is not None:
            m = cfg.mla
            total += batch * s_cap * (m.kv_lora_rank + m.qk_rope_dim) * dtype_bytes
        else:
            L_c = s_cap
            if not cfg.layer_is_global_attn(i) and cfg.sliding_window:
                L_c = min(s_cap, cfg.sliding_window)
            total += 2 * batch * L_c * cfg.n_kv_heads * cfg.hd * dtype_bytes
    if cfg.encoder_layers:
        total += cfg.n_layers * 2 * batch * cfg.encoder_tokens * cfg.n_kv_heads * cfg.hd * dtype_bytes
    return total


def train_bytes(cfg: ModelConfig, batch: int, seq: int, n_micro: int) -> float:
    """HBM traffic for one optimizer step (global, all devices).

    Params are re-read per microbatch (fwd + bwd + remat ~ 3 reads), grads
    accumulate (read+write), AdamW touches (p, m, v) read+write once.
    Activations: ~2 x layers x T x d x 2 B (residual stream in/out, flash
    keeps attention internals in-cache).
    """
    p = cfg.param_count()
    T = float(batch) * seq
    traffic = n_micro * 3 * p * 4.0  # param reads per microbatch
    traffic += n_micro * 2 * p * 4.0  # grad accumulate read+write
    traffic += 3 * 2 * p * 4.0  # AdamW p/m/v read+write
    traffic += 4 * cfg.n_layers * T * cfg.d_model * 2.0  # activations save+read
    return traffic


def prefill_bytes(cfg: ModelConfig, batch: int, seq: int) -> float:
    p = cfg.param_count()
    T = float(batch) * seq
    return p * 2.0 + 2 * cfg.n_layers * T * cfg.d_model * 2.0 + kv_cache_bytes(cfg, batch, seq)


def decode_bytes(cfg: ModelConfig, batch: int, s_cap: int) -> float:
    """One decode step: every live parameter + the whole cache stream once."""
    active_frac = cfg.active_param_count() / cfg.param_count()
    p_read = cfg.param_count() * 2.0  # bf16 weights
    if cfg.moe is not None:
        # routed experts: only top-k experts' weights per token, but with
        # batch >= E*topk the whole table streams; scale by min(1, B*k/E)
        m = cfg.moe
        frac = min(1.0, batch * m.top_k / m.n_experts)
        routed = (cfg.param_count() - cfg.active_param_count()) * 2.0
        p_read = cfg.active_param_count() * 2.0 + routed * frac
    return p_read + kv_cache_bytes(cfg, batch, s_cap)
