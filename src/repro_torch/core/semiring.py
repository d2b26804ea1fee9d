"""Semiring registry for associative arrays (port of ``repro.core.semiring``).

Same names, zeros, ones and registry keys as the reference, so a
``StreamConfig.to_dict()`` written by either package resolves unchanged.
Each semiring also carries ``fold``, the integer code the CUDA kernels
switch on for ``add``: plus (``plus.times``, ``count``), max (``max.*``),
min (``min.*``) and first (``union.first``).

``add``/``mul`` are elementwise torch functions.  ``torch.maximum`` and
``torch.minimum`` propagate NaN exactly like ``jnp.maximum``/``jnp.minimum``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

FOLD_PLUS, FOLD_MAX, FOLD_MIN, FOLD_FIRST = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True, eq=False)
class Semiring:
    """A value semiring ``(V, add, mul, zero, one)`` plus the kernel fold
    code of its ``add``.  ``zero`` is also the value of dead slots."""

    name: str
    add: Callable
    mul: Callable
    zero: float
    one: float
    fold: int

    def zero_as(self, dtype: torch.dtype):
        """``zero`` as a value of ``dtype`` (see :func:`as_value`)."""
        return as_value(self.zero, dtype)

    def one_as(self, dtype: torch.dtype):
        """``one`` as a value of ``dtype`` (see :func:`as_value`)."""
        return as_value(self.one, dtype)

    def add_identity(self, dtype: torch.dtype, device=None) -> torch.Tensor:
        """``zero`` as a 0-d tensor of ``dtype`` (the reference's
        ``jnp.asarray(zero, dtype)``; an integer type saturates as
        :meth:`zero_as` does), on ``device`` (the CPU unless given)."""
        return torch.tensor(self.zero_as(dtype), dtype=dtype, device=device)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Semiring({self.name})"


def as_value(x: float, dtype: torch.dtype):
    """``x`` as a value of ``dtype``, as the reference writes a semiring's
    zero or one into an array of that type: unchanged for a float type; for
    an integer type, XLA's float-to-integer conversion on the CPU, which
    saturates (``-inf`` is the least value, ``inf`` the greatest) and takes
    NaN to 0 (ROADMAP C15).  ``torch.full`` refuses the infinities and NaN
    for an integer type."""
    if dtype.is_floating_point:
        return x
    info = torch.iinfo(dtype)
    if math.isnan(x):
        return 0
    if x <= info.min:
        return info.min
    if x >= info.max:
        return info.max
    return int(x)


def _plus(x, y):
    return x + y


def _times(x, y):
    return x * y


def _first(x, y):  # union semantics: keep earliest value
    return x


def _second(x, y):  # overwrite semantics: keep latest value
    return y


PLUS_TIMES = Semiring("plus.times", _plus, _times, 0.0, 1.0, FOLD_PLUS)
MAX_PLUS = Semiring("max.plus", torch.maximum, _plus, -math.inf, 0.0, FOLD_MAX)
MIN_PLUS = Semiring("min.plus", torch.minimum, _plus, math.inf, 0.0, FOLD_MIN)
MAX_TIMES = Semiring("max.times", torch.maximum, _times, 0.0, 1.0, FOLD_MAX)
MIN_TIMES = Semiring("min.times", torch.minimum, _times, math.inf, 1.0, FOLD_MIN)
MAX_MIN = Semiring("max.min", torch.maximum, torch.minimum, 0.0, math.inf, FOLD_MAX)
MIN_MAX = Semiring("min.max", torch.minimum, torch.maximum, math.inf, 0.0, FOLD_MIN)
FIRST = Semiring("union.first", _first, _second, math.nan, math.nan, FOLD_FIRST)
COUNT = Semiring("count", _plus, _times, 0.0, 1.0, FOLD_PLUS)

REGISTRY = {
    s.name: s
    for s in [
        PLUS_TIMES,
        MAX_PLUS,
        MIN_PLUS,
        MAX_TIMES,
        MIN_TIMES,
        MAX_MIN,
        MIN_MAX,
        FIRST,
        COUNT,
    ]
}


def get(name: str) -> Semiring:
    """Look up a semiring by its ``name`` (e.g. ``"plus.times"``)."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown semiring {name!r}; known: {sorted(REGISTRY)}")
