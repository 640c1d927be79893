"""Synthetic video: the port's own copy of the JAX package's
``repro/data/synthetic.py::synthetic_video``, built in numpy exactly as
there, so both packages see the same pixels."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.noise import synthetic_image_np

__all__ = ["synthetic_video", "synthetic_video_np"]


def synthetic_video_np(
    key: int, n_frames: int, h: int = 128, w: int = 192, motion: float = 2.0
) -> np.ndarray:
    """Deterministic clean video: a panning crop over one synthetic scene.

    Frame t is an ``(h, w)`` window into a larger
    :func:`repro_torch.core.synthetic_image_np` scene, translated diagonally
    by ``motion`` pixels per frame, so consecutive frames are the same
    content under camera motion. ``motion=0`` gives a static scene (every
    frame identical). Returns float32 ``(n_frames, h, w)`` in [0, 255].
    """
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    span = int(np.ceil(abs(motion) * (n_frames - 1)))
    scene = synthetic_image_np(h + span, w + span, seed=key)
    frames = np.empty((n_frames, h, w), np.float32)
    for t in range(n_frames):
        off = int(round(abs(motion) * t))
        frames[t] = scene[off : off + h, off : off + w]
    return frames


def synthetic_video(
    key: int,
    n_frames: int,
    h: int = 128,
    w: int = 192,
    motion: float = 2.0,
    device=None,
) -> torch.Tensor:
    """:func:`synthetic_video_np` as a float32 tensor on ``device`` (default:
    the CUDA card)."""
    frames = synthetic_video_np(key, n_frames, h, w, motion)
    return torch.from_numpy(frames).to(resolve_device(device))
