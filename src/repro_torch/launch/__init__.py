"""Launchers of the port (port of ``repro.launch``): the train, prefill
and serve steps (``steps``; the sharded train step over a mesh), the
production and local meshes (``mesh``), the assigned input shapes
(``shapes``), and the pod-scale dry runs (``dryrun``, ``dryrun_assoc``;
``python -m`` entry points, imported on demand)."""
from . import steps  # noqa: F401
