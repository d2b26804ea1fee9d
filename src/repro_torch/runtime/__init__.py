"""``repro_torch.runtime`` — host-side liveness and straggler policy (port
of ``repro.runtime``): :mod:`.elastic` (``Heartbeat``, the mesh planner and
``ElasticController``) and :mod:`.straggler`."""
from . import elastic, straggler  # noqa: F401
