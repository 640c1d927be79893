"""Serving fronts of the port.

``frames.FrameDenoiseEngine`` micro-batches submitted frames synchronously
through one :class:`repro_torch.plan.BGPlan`, on one device or split
over the plan's batch mesh in mesh-divisible micro-batches.
``async_engine.AsyncFrameEngine`` does the same behind futures, with a
dispatch and a completion thread, and in video mode packs one frame per
stream through a :class:`repro_torch.video.MultiStreamPacker`. The JAX
package's LM engine is not ported yet.
"""
from .async_engine import AsyncFrameEngine, AsyncFrameRequest, EngineStats
from .frames import FrameDenoiseEngine, FrameRequest

__all__ = [
    "AsyncFrameEngine",
    "AsyncFrameRequest",
    "EngineStats",
    "FrameDenoiseEngine",
    "FrameRequest",
]
