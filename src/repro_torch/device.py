"""Device resolution for the port's entry points.

The port is written for the card: an entry point given no ``device=`` runs
on ``cuda``.  Where CUDA is absent it raises instead of carrying on quietly
on the CPU, so a measurement can never be a CPU number by accident.  Tests
and CPU parity runs pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU (as the tests do)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
