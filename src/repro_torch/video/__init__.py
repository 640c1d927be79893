"""Real-time video denoising on top of the fused bilateral-grid kernel.

  * :mod:`repro_torch.video.temporal`: the temporal bilateral grid, a
    recursive EMA of the blurred grid carried across the frames of one
    stream, run inside the CUDA kernel (B2) for every alpha; ``a == 0``
    reduces to the per-frame kernel bit for bit.
  * :mod:`repro_torch.video.session`: per-stream state (carry, frame
    counter) and the multi-stream packer that batches one frame from each
    live stream into one dispatch.

The async serving front for these is ``repro_torch.serving.async_engine``.
"""
from .session import MultiStreamPacker, StreamSession
from .temporal import blurred_grid_batch, carry_shape, temporal_denoise

__all__ = [
    "MultiStreamPacker",
    "StreamSession",
    "blurred_grid_batch",
    "carry_shape",
    "temporal_denoise",
]
