"""Standalone grid filter (GF): the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/bg_blur.cu``, B5) replaces the JAX package's GF Pallas
kernel (``repro/kernels/bg_blur.py:57``): the separable 3x3x3 Gaussian on
both homogeneous channels of a ``(…, gx, gy, gz, 2)`` grid in HBM, zero
borders, taps along x, then z, then y (the fused kernel's order, the same
device function).

A CPU tensor runs :func:`bg_blur_plain`; a CUDA tensor runs the kernel or
the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _wrap
from .common import BGConfig, conv3_axis, taps_np

__all__ = ["bg_blur", "bg_blur_plain"]

KERNEL = "bg_blur"


def _grids(grid, kernel: str = KERNEL) -> torch.Tensor:
    """``grid`` as float32 ``(b, gx, gy, gz, 2)``."""
    if not isinstance(grid, torch.Tensor):
        raise TypeError(f"{kernel} takes a torch.Tensor, got {type(grid).__name__}")
    if grid.dtype != torch.float32:
        raise TypeError(f"{kernel} takes a float32 grid, got {grid.dtype}")
    g = grid[None] if grid.dim() == 4 else grid
    if g.dim() != 5 or g.shape[-1] != 2 or min(g.shape) < 1:
        raise ValueError(
            f"{kernel} takes a (gx, gy, gz, 2) or (b, gx, gy, gz, 2) grid, got "
            f"{tuple(grid.shape)}"
        )
    return g


def bg_blur_plain(grid: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """Plain PyTorch GF on any device, same shape in and out: x, then z,
    then y taps, ``t0*lo + t1*mid + t2*hi`` with zero borders."""
    g = _grids(grid)
    taps = tuple(float(t) for t in taps_np(cfg))
    for axis in (1, 3, 2):  # (b, gx, gy, gz, 2): x, z, y
        g = conv3_axis(g, taps, axis)
    return g[0] if grid.dim() == 4 else g


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bg_blur_launch.argtypes = [p, p] + [i] * 4 + [f] * 3 + [i, p]
    lib.bg_blur_launch.restype = i
    return lib


def bg_blur(grid: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """GF of a ``(gx, gy, gz, 2)`` or ``(b, gx, gy, gz, 2)`` float32 grid,
    into a fresh grid of the same shape. CPU tensors run
    :func:`bg_blur_plain`; CUDA tensors run one kernel launch over the batch
    on the current stream, counted in ``bg_blur.launches``."""
    g = _grids(grid)
    if not _wrap.on_card(g, KERNEL):
        return bg_blur_plain(grid, cfg)
    _wrap.contiguous(g, "grids", KERNEL)
    b, gx, gy, gz, _ = g.shape
    if b > 65535 or gx > 65535 or gy * gz * 2 >= 2**31:
        raise ValueError(f"bg_blur: {tuple(g.shape)} exceeds one launch")
    out = torch.empty_like(g)
    t0, t1, t2 = (float(t) for t in taps_np(cfg))
    err = _lib().bg_blur_launch(
        g.data_ptr(), out.data_ptr(), b, gx, gy, gz, t0, t1, t2,
        g.device.index, _wrap.stream(g.device),
    )
    _build.check(KERNEL, err)
    bg_blur.launches += 1
    return out[0] if grid.dim() == 4 else out


bg_blur.launches = 0
