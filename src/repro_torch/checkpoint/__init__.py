from . import manager  # noqa: F401
from .manager import CheckpointDamaged, CheckpointManager  # noqa: F401
