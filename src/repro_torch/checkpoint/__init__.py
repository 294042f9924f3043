"""Checkpoints of the training state (the durable tier beside the slots)."""

from .manager import restore_checkpoint, restore_elastic, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_elastic"]
