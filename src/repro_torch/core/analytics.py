"""Network analytics on associative arrays (port of the part of
``repro.core.analytics`` the streaming path reads: degrees and top-k)."""
from __future__ import annotations

from typing import Tuple

import torch

from . import assoc
from .assoc import Assoc
from .semiring import PLUS_TIMES, Semiring


def degrees(
    a: Assoc, cap: int | None = None, sr: Semiring = PLUS_TIMES
) -> Tuple[Assoc, Assoc]:
    """(out_degree, in_degree) keyed ``(vertex, 0)``, each folded with
    ``sr.add``."""
    return assoc.reduce_rows(a, cap, sr), assoc.reduce_cols(a, cap, sr)


def top_k_vertices(deg: Assoc, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heaviest-k vertices from a degree array: (ids [k], counts [k])."""
    return deg.topk(k)
