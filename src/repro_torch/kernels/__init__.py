"""Hand-written Hopper kernels of the port.

Each kernel's CUDA source lives under ``repro_torch/csrc``; its package
here holds the wrapper (which launches the kernel for CUDA tensors and runs
the plain PyTorch version for CPU tensors) and a launch counter.

:func:`plain_versions` scopes a switch that the dispatchers read (the
three of :mod:`repro_torch.core.assoc`, ``add``, ``from_triples`` and
``_combine_sorted``, :func:`repro_torch.kernels.hier_cascade.ops.cascade_step`
and :func:`repro_torch.sparse.row_accum.to_dense`):
inside it they take their plain PyTorch versions for CUDA tensors too, so a
whole path can be held against its plain version on the card.  Only the chip smoke test and tests enter it; outside it a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import contextlib
import contextvars

_plain = contextvars.ContextVar("repro_torch_plain_versions", default=False)


def plain_active() -> bool:
    """True inside :func:`plain_versions`."""
    return _plain.get()


@contextlib.contextmanager
def plain_versions():
    """Route ``assoc.add``/``from_triples``/``_combine_sorted``,
    ``cascade_step`` and ``row_accum.to_dense`` to their plain PyTorch
    versions on every device while the block runs."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)
