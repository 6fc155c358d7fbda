"""Checkpoints in the reference's on-disk format (``store``)."""
from .store import (latest_step, load_checkpoint, restore_sharded,
                    save_checkpoint)

__all__ = ["latest_step", "load_checkpoint", "restore_sharded",
           "save_checkpoint"]
