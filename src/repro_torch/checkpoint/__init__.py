"""Fault-tolerant checkpointing (atomic commit, checksums, walk-back
restore) in the JAX store's on-disk format."""
from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
