"""Sharding of the port: batch-axis sharding of the bilateral-grid service
path over several devices (the port of ``repro/sharding/bg_shard.py``), and
the LM substrate's logical-axis partitioning as DTensors over a
``DeviceMesh`` (``compat``, ``partitioning``), ring attention
(``ring_attention``) and GPipe (``pipeline_parallel``), imported from their
modules as in the JAX package."""
from .bg_shard import (
    BATCH_AXIS,
    BatchMesh,
    batch_mesh,
    bg_denoise_sharded,
    bg_temporal_sharded,
    shard_batch_call,
)

__all__ = [
    "BATCH_AXIS",
    "BatchMesh",
    "batch_mesh",
    "shard_batch_call",
    "bg_denoise_sharded",
    "bg_temporal_sharded",
]
