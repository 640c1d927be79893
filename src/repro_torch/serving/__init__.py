"""Serving fronts of the port.

``frames.FrameDenoiseEngine`` micro-batches submitted frames synchronously
through one :class:`repro_torch.plan.BGPlan`, on one device or split
over the plan's batch mesh in mesh-divisible micro-batches.
``async_engine.AsyncFrameEngine`` does the same behind futures, with a
dispatch and a completion thread, and in video mode packs one frame per
stream through a :class:`repro_torch.video.MultiStreamPacker`.
``engine.ServeEngine`` is the LM engine: continuous batching over decode
slots, a batch-1 prefill per request spliced into its slot, with the
samplers of ``sampling``.
"""
from .async_engine import AsyncFrameEngine, AsyncFrameRequest, EngineStats
from .engine import Request, ServeEngine, make_prefill, make_serve_step
from .frames import FrameDenoiseEngine, FrameRequest
from .sampling import greedy, sample_temperature, sample_topk

__all__ = [
    "AsyncFrameEngine",
    "AsyncFrameRequest",
    "EngineStats",
    "FrameDenoiseEngine",
    "FrameRequest",
    "Request",
    "ServeEngine",
    "greedy",
    "make_prefill",
    "make_serve_step",
    "sample_temperature",
    "sample_topk",
]
