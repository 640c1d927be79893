"""Serving fronts of the port: the synchronous frame-denoise engine.

``frames.FrameDenoiseEngine`` micro-batches submitted frames through one
:class:`repro_torch.plan.BGPlan` on one device. The JAX package's
asynchronous engine and its LM engine are not ported yet.
"""
from .frames import FrameDenoiseEngine, FrameRequest

__all__ = ["FrameDenoiseEngine", "FrameRequest"]
