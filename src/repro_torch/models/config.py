"""Model configuration schema covering all 10 assigned architectures (a
copy of ``repro.models.config``, which is pure data).

One frozen dataclass drives model construction, input specs and parameter
accounting.  Per-arch instances live in ``repro_torch/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # expert FFN hidden size
    n_shared: int = 0  # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    router_aux_free: bool = False  # deepseek-v3 bias-based balancing
    router_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""

    d_state: int
    d_conv: int
    expand: int
    head_dim: int
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- attention flavor ---
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # SWA width (tokens)
    global_every: Optional[int] = None  # 1 global layer per this many (gemma3: 6)
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None
    tied_embeddings: bool = False
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_every: int = 1  # MoE replaces dense FFN on every k-th layer
    first_dense: int = 0  # deepseek: first n layers keep dense FFN
    # --- MLA ---
    mla: Optional[MLAConfig] = None
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    attn_every: Optional[int] = None  # jamba: 1 attention layer per this many
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0  # >0 -> enc-dec; n_layers is then the decoder depth
    encoder_tokens: int = 0  # fixed encoder sequence (stub frames)
    # --- multimodal frontend stub ---
    frontend: Optional[str] = None  # 'audio' | 'vision' (stub embeddings)
    frontend_tokens: int = 0  # prefix tokens provided by the stub
    # --- capability flags ---
    subquadratic: bool = False  # may run long_500k
    mtp_depth: int = 0  # deepseek multi-token-prediction modules
    norm: str = "rmsnorm"
    act: str = "silu"
    dtype: str = "bfloat16"
    pad_vocab_to: int = 512  # Megatron-style: embeddings padded for TP

    # -------------------------------------------------- derived quantities
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows: vocab rounded up so the vocab dim shards
        evenly over any TP degree dividing ``pad_vocab_to``.  Loss and
        sampling mask the pad region (ids never reference it)."""
        p = self.pad_vocab_to
        return (self.vocab + p - 1) // p * p

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for the mixer of decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_every:  # hybrid: 1 attention per attn_every, rest ssm
            return "attn" if (i % self.attn_every) == (self.attn_every // 2) else "ssm"
        return "attn"

    def layer_is_global_attn(self, i: int) -> bool:
        """gemma3-style local:global pattern (one global per global_every)."""
        if self.sliding_window is None:
            return True
        if self.global_every is None:
            return False
        return (i % self.global_every) == (self.global_every - 1)

    def layer_has_moe(self, i: int) -> bool:
        if self.moe is None or i < self.first_dense:
            return False
        return ((i - self.first_dense) % self.moe_every) == 0

    # -------------------------------------------------- parameter counting
    def param_count(self) -> int:
        """Exact dense parameter count (embeddings included once if tied)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE counts top_k + shared experts)."""
        return _count_params(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_dim + m.qk_rope_dim
        p = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk_dim  # q down+up
        p += d * (m.kv_lora_rank + m.qk_rope_dim)  # kv down (+ decoupled rope k)
        p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)  # kv up
        p += cfg.n_heads * m.v_head_dim * d  # out proj
        p += m.q_lora_rank + m.kv_lora_rank  # norms on latents
        return p
    hd = cfg.hd
    p = d * cfg.n_heads * hd  # Q
    p += 2 * d * cfg.n_kv_heads * hd  # K, V
    p += cfg.n_heads * hd * d  # O
    if cfg.qkv_bias:
        p += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return p


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    n_heads = d_inner // s.head_dim
    p = d * (2 * d_inner + 2 * s.n_groups * s.d_state + n_heads)  # in_proj (z,x,B,C,dt)
    p += s.d_conv * (d_inner + 2 * s.n_groups * s.d_state)  # conv1d
    p += n_heads  # A_log
    p += n_heads  # D skip
    p += n_heads  # dt_bias
    p += d_inner * d  # out_proj
    p += d_inner  # norm before out
    return p


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    # SwiGLU: gate+up+down; GELU: up+down
    mult = 3 if cfg.act == "silu" else 2
    return mult * cfg.d_model * d_ff


def _moe_layer_params(cfg: ModelConfig, active_only: bool) -> int:
    m = cfg.moe
    n_routed = m.top_k if active_only else m.n_experts
    p = n_routed * _ffn_params(cfg, m.d_expert)
    p += m.n_shared * _ffn_params(cfg, m.d_expert)
    p += cfg.d_model * m.n_experts  # router
    if m.router_aux_free:
        p += m.n_experts  # balancing bias
    return p


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    total = cfg.vocab * d  # embedding
    if not cfg.tied_embeddings:
        total += cfg.vocab * d  # LM head
    total += d  # final norm

    def decoder_layer(i: int) -> int:
        p = 0
        kind = cfg.layer_kind(i)
        if kind == "ssm":
            p += _ssm_params(cfg) + d  # mixer + pre-norm
        else:
            p += _attn_params(cfg) + d
        if cfg.layer_has_moe(i):
            p += _moe_layer_params(cfg, active_only) + d
        elif cfg.d_ff > 0:
            p += _ffn_params(cfg, cfg.d_ff) + d
        return p

    for i in range(cfg.n_layers):
        total += decoder_layer(i)
    # encoder (whisper): self-attn + FFN per layer; decoder additionally has
    # cross-attention (counted below)
    if cfg.encoder_layers:
        for _ in range(cfg.encoder_layers):
            total += _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d
        total += cfg.n_layers * (_attn_params(cfg) + d)  # cross-attn blocks
        total += d  # encoder final norm
    if cfg.mtp_depth:
        # deepseek MTP: per depth, one extra transformer block + projection
        total += cfg.mtp_depth * (decoder_layer(cfg.first_dense) + 2 * d * d)
    return int(total)
