"""``repro_torch`` — the D4M streaming system on PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``: the same subpackage
and module names (``core``, ``kernels``, ``d4m``, ``data``, ``configs``),
plain functions on tensors, an explicit leading ``[K]`` instance axis where
JAX used ``vmap``, and Python loops where JAX used ``lax.scan``.  The one
TPU kernel on the streaming path, ``hier_cascade``, is a hand-written CUDA
kernel for ``sm_90a`` (:mod:`repro_torch.kernels.hier_cascade`).

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).  This package never imports
``jax`` or ``repro``.
"""
from .device import resolve_device  # noqa: F401
