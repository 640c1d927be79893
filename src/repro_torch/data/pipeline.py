"""Data pipeline with the paper's BG denoiser as a stage.

``denoise_batch`` runs a :class:`repro_torch.plan.BGPlan` over a batch; the
plan picks the route (whole-image reference or the fused CUDA kernel) and
the device.
"""
from __future__ import annotations

import torch

__all__ = ["denoise_batch"]


def denoise_batch(images, *, plan) -> torch.Tensor:
    """(B, H, W) or color (B, H, W, C) noisy [0,255] -> denoised batch on the
    plan's device. Color frames are denoised per channel: the plan folds the
    channel axis into the batch axis, so each channel gets its own grid."""
    return plan(images)
