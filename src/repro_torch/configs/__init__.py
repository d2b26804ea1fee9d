"""Workload configurations of the port (port of ``repro.configs``).

``d4m_stream`` is the paper's streaming workload.  The architecture
registry: one module per assigned architecture, each exporting ``CONFIG``
(the exact published numbers, copied from the reference).
``reduced(cfg)`` shrinks any config to a CPU-smoke-testable size while
preserving its structural pattern (layer kinds, MoE cadence, local:global
cadence, frontend stubs)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig, SSMConfig

ARCH_IDS = [
    "h2o_danube3_4b",
    "gemma3_27b",
    "qwen2_0_5b",
    "granite_3_8b",
    "jamba_1_5_large",
    "phi3_5_moe",
    "deepseek_v3",
    "paligemma_3b",
    "mamba2_1_3b",
    "whisper_tiny",
]

# external ids (the assignment's naming) -> module ids
ALIASES = {
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "gemma3-27b": "gemma3_27b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-3-8b": "granite_3_8b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "deepseek-v3-671b": "deepseek_v3",
    "paligemma-3b": "paligemma_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "whisper-tiny": "whisper_tiny",
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Structure-preserving shrink for CPU smoke tests."""
    changes: dict = {}
    # keep enough layers to exercise the full kind pattern
    if cfg.attn_every:
        changes["n_layers"] = min(cfg.n_layers, cfg.attn_every)
    elif cfg.global_every:
        changes["n_layers"] = min(cfg.n_layers, cfg.global_every)
    else:
        changes["n_layers"] = min(cfg.n_layers, max(2, cfg.first_dense + 1))
    changes["d_model"] = 64
    changes["n_heads"] = 4
    changes["n_kv_heads"] = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1
    changes["head_dim"] = 16
    changes["d_ff"] = 0 if cfg.d_ff == 0 else 128
    changes["vocab"] = 512
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_expert=64, n_shared=min(cfg.moe.n_shared, 1)
        )
    changes["first_dense"] = min(cfg.first_dense, 1)
    if cfg.mla:
        changes["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16
        )
    if cfg.ssm:
        changes["ssm"] = SSMConfig(
            d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=8
        )
    if cfg.encoder_layers:
        changes["encoder_layers"] = 2
        changes["encoder_tokens"] = 16
        changes["n_layers"] = 2
    if cfg.frontend_tokens:
        changes["frontend_tokens"] = 8
    changes["mtp_depth"] = min(cfg.mtp_depth, 1)
    changes["dtype"] = "float32"  # numerics checks on CPU
    return dataclasses.replace(cfg, **changes)
