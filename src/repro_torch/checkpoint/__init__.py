"""``repro_torch.checkpoint`` -- atomic, checksummed npz checkpoints in the
reference's format (counterpart of ``repro.checkpoint``)."""
from .checkpoint import (  # noqa: F401
    CheckpointCorruptError, available_steps, latest_step, prune_checkpoints,
    restore_checkpoint, restore_latest_valid, save_checkpoint)
