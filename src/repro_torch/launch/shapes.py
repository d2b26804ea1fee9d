"""Assigned input shapes and per-cell input stand-ins (port of
``repro.launch.shapes``): ``device="meta"`` tensors in place of the
reference's ``ShapeDtypeStruct``\\ s — the shapes and dtypes, no memory.

The 4 shapes x 10 archs = 40 dry-run cells.  ``decode_*``/``long_*`` are
one token against a seq_len cache; ``long_500k`` runs only for
sub-quadratic archs (cfg.subquadratic) — skips are documented, not silent.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models import serving as SV
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k requires a sub-quadratic path; "
            f"{cfg.name} is pure full-attention (documented skip, DESIGN.md 3.6)"
        )
    return True, ""


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, s = shape.batch, shape.seq
    s_text = s - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    out = {"tokens": _meta((b, s_text), torch.int32), "labels": _meta((b, s_text), torch.int32)}
    if cfg.frontend == "vision":
        out["frontend"] = _meta((b, cfg.frontend_tokens, cfg.d_model), _dtype(cfg))
    elif cfg.encoder_layers:
        out["frontend"] = _meta((b, cfg.encoder_tokens, cfg.d_model), _dtype(cfg))
    return out


def prefill_inputs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    out = train_inputs(cfg, shape)
    del out["labels"]
    return out


def decode_inputs(cfg: ModelConfig, shape: ShapeSpec):
    """(token, cache) on the meta device: zero allocation."""
    token = _meta((shape.batch, 1), torch.int32)
    return token, SV.init_cache(cfg, shape.batch, shape.seq, _dtype(cfg), device="meta")


def params_struct(cfg: ModelConfig):
    return TF.init_params(None, cfg, device="meta")


# Per-arch gradient-accumulation targets for train_4k.  Baseline policy:
# microbatch down to ONE sequence per data shard — the S^2 attention
# working set times the local batch is the dominant live tensor under
# remat.  whisper's S^2 is tiny (d=384), it can afford larger microbatches.
GRAD_ACCUM = {
    "whisper-tiny": 2,
}


def grad_accum_steps(cfg: ModelConfig, shape: ShapeSpec, dp_size: int) -> int:
    target = GRAD_ACCUM.get(cfg.name, shape.batch // max(1, dp_size))
    return max(1, min(target, shape.batch // max(1, dp_size)))
