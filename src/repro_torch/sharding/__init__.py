"""Batch-axis sharding of the bilateral-grid service path over several
devices: the port of ``repro/sharding/bg_shard.py`` (the LM substrate's
sharding modules are not ported)."""
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
