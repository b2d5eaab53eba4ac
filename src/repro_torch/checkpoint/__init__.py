"""Atomic, retention-bounded checkpoints of nested tensor / array trees."""
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          leaf_paths, read_manifest,
                                          restore_checkpoint,
                                          save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "leaf_paths",
           "read_manifest", "restore_checkpoint", "save_checkpoint"]
