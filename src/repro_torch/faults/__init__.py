"""Deterministic fault injection + shared retry policy for serve/fleet.

See :mod:`repro_torch.faults.plan` for the injection-site catalogue and
activation paths, :mod:`repro_torch.faults.retry` for the backoff policy.
"""
from .plan import (  # noqa: F401
    ENV_VAR,
    GENERATION_ENV_VAR,
    SITES,
    WORKER_ENV_VAR,
    FaultPlan,
    FaultSpec,
    Trigger,
)
from .retry import RetryPolicy  # noqa: F401

__all__ = [
    "ENV_VAR",
    "GENERATION_ENV_VAR",
    "SITES",
    "WORKER_ENV_VAR",
    "FaultPlan",
    "FaultSpec",
    "Trigger",
    "RetryPolicy",
]
