from .io import get_bytes, put_bytes, delete_path
from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint)
from .replicate import replicate_checkpoint

__all__ = ["get_bytes", "put_bytes", "delete_path", "CheckpointManager",
           "latest_step", "save_checkpoint", "restore_checkpoint",
           "replicate_checkpoint"]
