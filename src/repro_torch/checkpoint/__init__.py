"""Checkpoints of the training path (port of repro/checkpoint)."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "AsyncCheckpointer",
]
