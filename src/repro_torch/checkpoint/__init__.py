"""Checkpoints of the port: the JAX package's ``repro/checkpoint`` on-disk
layout (npz keyed by tree path + ``meta.json``), atomic writes, the
step-indexed, retention-limited, async ``CheckpointManager``, and the
elastic restore onto any ``DeviceMesh`` (``elastic.py``)."""
from .checkpointer import load_pytree, save_pytree
from .elastic import elastic_restore, train_state_shardings
from .manager import CheckpointManager

__all__ = ["CheckpointManager", "elastic_restore", "load_pytree", "save_pytree", "train_state_shardings"]
