"""Three-term roofline model of a port's step (port of
``repro.analysis.roofline``, on an H100 in place of a TPU v5e).

    compute term    = exec_FLOPs_per_chip   / peak_FLOP/s
    memory term     = HBM_bytes_per_chip    / HBM_bw
    collective term = wire_bytes_per_chip   / link_bw

Term sources:
* FLOPs / HBM bytes — the analytic model in :mod:`repro_torch.analysis.flops`.
* collective bytes — one chip's result bytes by kind, from the port's
  counters (``core.mesh.Mesh.collective_bytes`` over a real step) or its
  schedule (``launch.dryrun.step_collectives``, the same count as a formula
  at pod scale).  The port lowers nothing, so the reference's HLO parsers
  (``collective_bytes_from_hlo`` and its helpers) have nothing to read and
  are not ported.

Hardware constants: NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU
data sheet): 989 TFLOP/s dense bfloat16, 3.35 TB/s HBM3, NVLink 4 at
900 GB/s a GPU both ways (450 GB/s each way).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.analysis import flops as FM

PEAK_FLOPS = 989e12  # H100 SXM dense bfloat16 (no sparsity), NVIDIA data sheet
HBM_BW = 3.35e12  # bytes/s, H100 SXM HBM3, NVIDIA data sheet
LINK_BW = 450e9  # bytes/s each way, H100 SXM NVLink 4 (900 GB/s bidirectional), NVIDIA data sheet


def collective_wire_bytes(by_kind: Dict[str, float]) -> float:
    """Ring-algorithm per-chip wire traffic: all-reduce ~2x its payload,
    gather/scatter/a2a/permute ~1x."""
    factors = {
        "all-gather": 1.0,
        "all-reduce": 2.0,
        "reduce-scatter": 1.0,
        "all-to-all": 1.0,
        "collective-permute": 1.0,
    }
    return sum(v * factors.get(k, 1.0) for k, v in by_kind.items())


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    by_kind: Dict[str, float]
    n_chips: int
    model_flops: float  # 6*N_active*D (train) / 2*N_active*D (inference)
    exec_flops_global: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.exec_flops_global, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline bound — the score."""
        return self.model_flops / (max(self.step_time, 1e-12) * self.n_chips * PEAK_FLOPS)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "collectives_by_kind": self.by_kind,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "exec_flops_global": self.exec_flops_global,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lower_bound_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_mfu": self.mfu,
        }


def analyze(cfg, shape, n_chips: int, n_micro: int = 1, by_kind: Optional[Dict[str, float]] = None) -> Roofline:
    """The three terms of one step of ``shape`` over ``n_chips``:
    ``by_kind`` is one chip's collective bytes by kind (the port's
    counters or schedule; none: no collective term)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        fwd = FM.fwd_flops(cfg, shape.batch, shape.seq)
        exec_flops = 4.0 * fwd  # fwd + 2x bwd + ~1x remat recompute
        model_flops = 6.0 * n_active * shape.batch * shape.seq
        byts = FM.train_bytes(cfg, shape.batch, shape.seq, n_micro)
    elif shape.kind == "prefill":
        exec_flops = FM.fwd_flops(cfg, shape.batch, shape.seq)
        model_flops = 2.0 * n_active * shape.batch * shape.seq
        byts = FM.prefill_bytes(cfg, shape.batch, shape.seq)
    else:
        exec_flops = FM.decode_flops(cfg, shape.batch, shape.seq)
        model_flops = 2.0 * n_active * shape.batch
        byts = FM.decode_bytes(cfg, shape.batch, shape.seq)
    by_kind = {k: float(v) for k, v in (by_kind or {}).items()}
    return Roofline(
        flops_per_chip=exec_flops / n_chips,
        bytes_per_chip=byts / n_chips,
        wire_bytes_per_chip=collective_wire_bytes(by_kind),
        by_kind=by_kind,
        n_chips=n_chips,
        model_flops=model_flops,
        exec_flops_global=exec_flops,
    )
