"""Atomic checkpoints in the JAX package's on-disk format (store.py)."""
from .store import (CheckpointManager, latest_step, read_metadata,
                    restore_checkpoint, save_checkpoint)
