"""Step factories of the port (port of ``repro.launch``): the train,
prefill and serve steps.  The reference's mesh, shapes and dry-run
lowering belong to the sharding slice."""
from . import steps  # noqa: F401
