"""Checkpoint substrate: atomic checksummed checkpoints (a JSON
manifest and raw buffers) and their lifecycle manager."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncWriter,
    CheckpointCorruption,
    load,
    save,
)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
