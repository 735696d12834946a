"""Checkpoints of the port: the reference's atomic npz + CRC format
(``repro.checkpoint``), so either package restores the other's files."""

from .manager import CheckpointManager, restore_checkpoint, save_checkpoint  # noqa: F401
from .reshard import reshard_state  # noqa: F401

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint", "reshard_state"]
