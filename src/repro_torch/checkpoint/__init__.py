"""Checkpoints of the port: the JAX package's ``repro/checkpoint`` on-disk
layout (npz keyed by tree path + ``meta.json``), atomic writes, and the
step-indexed, retention-limited, async ``CheckpointManager``. The elastic
restore onto a mesh (``elastic.py``) comes with the LM sharding slice
(ROADMAP A11c)."""
from .checkpointer import load_pytree, save_pytree
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
