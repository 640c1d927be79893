"""Whole-image oracles for the bilateral-grid kernels.

Each oracle states the semantics a kernel must reproduce; they delegate to
``repro_torch.core`` so kernels are pinned to the validated whole-image
arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.core.bilateral_grid import (
    BGConfig,
    bilateral_grid_filter,
    grid_blur,
    grid_create,
    grid_normalize,
    grid_slice,
)

__all__ = ["ref_create", "ref_blur", "ref_slice", "ref_fused", "ref_normalize"]


def ref_create(image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """(h, w) image -> (gx, gy, gz, 2) grid of (count, sum)."""
    return grid_create(image.to(torch.float32), cfg)


def ref_blur(grid: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """3x3x3 separable Gaussian on the homogeneous grid (both channels)."""
    return grid_blur(grid.to(torch.float32), cfg)


def ref_slice(grid_f: torch.Tensor, image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """Trilinear slice of a scalar grid at fv(i). -> float32 (h, w)."""
    return grid_slice(grid_f.to(torch.float32), image.to(torch.float32), cfg)


def ref_fused(image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """Whole pipeline GC->GF->TI (paper normalization), unquantized output."""
    return bilateral_grid_filter(image.to(torch.float32), cfg, quantize_output=False)


def ref_normalize(blurred: torch.Tensor) -> torch.Tensor:
    return grid_normalize(blurred)
