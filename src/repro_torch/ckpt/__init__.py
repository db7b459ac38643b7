"""Checkpoints in the reference's format (port of ``repro/ckpt``)."""
from .checkpoint import latest_step, restore, save, save_async

__all__ = ["latest_step", "restore", "save", "save_async"]
