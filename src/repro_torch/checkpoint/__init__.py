"""Atomic, async checkpoints in the reference's on-disk layout."""
from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager"]
