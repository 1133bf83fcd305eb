"""Checkpoints of state trees (port of ``repro.checkpoint``), readable by
either package's store."""

from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    gc_old,
    latest_step,
    restore,
    save,
    step_dir,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
)

__all__ = [
    "AsyncCheckpointer", "gc_old", "latest_step", "restore", "save",
    "step_dir", "tree_flatten_with_path", "tree_leaves", "tree_map",
]
