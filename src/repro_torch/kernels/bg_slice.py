"""Standalone trilinear slice (TI): the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/bg_slice.cu``, B6) replaces the JAX package's TI Pallas
kernel (``repro/kernels/bg_slice.py:90``): a normalized grid ``(…, gx, gy,
gz)`` and the frames ``(…, h, w)`` whose intensities give the z coordinate,
to the filtered frames. Row i reads planes ``i // r`` and ``min(i // r + 1,
gx - 1)``, column j cells ``j // r`` and ``min(j // r + 1, gy - 1)``, with
the JAX kernels' lerp fractions and the fused kernel's lerp order (the same
device function); z corners outside ``[0, gz)`` count 0.

A CPU tensor runs :func:`bg_slice_plain`; a CUDA tensor runs the kernel or
the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, _wrap
from .common import BGConfig, grid_shape, ti_col_fracs

__all__ = ["bg_slice", "bg_slice_plain"]

KERNEL = "bg_slice"


def _operands(grid_f, image):
    """``(grids (b, gx, gy, gz), frames (b, h, w))``, checked against each
    other and against the grid the frames' shape gives."""
    x = _wrap.frames(image, KERNEL)
    if not isinstance(grid_f, torch.Tensor) or grid_f.dtype != torch.float32:
        raise TypeError(f"{KERNEL} takes a float32 torch.Tensor grid")
    g = grid_f[None] if grid_f.dim() == 3 else grid_f
    if g.dim() != 4 or g.shape[0] != x.shape[0] or grid_f.dim() != image.dim() + 1:
        raise ValueError(
            f"{KERNEL} takes a (gx, gy, gz) grid with an (h, w) frame or a "
            f"(b, gx, gy, gz) grid with (b, h, w) frames, got "
            f"{tuple(grid_f.shape)} and {tuple(image.shape)}"
        )
    if g.device != x.device:
        raise ValueError(f"{KERNEL}: the grid is on {g.device}, the frames on {x.device}")
    return g, x


def _check_grid(g: torch.Tensor, h: int, w: int, cfg: BGConfig) -> None:
    if tuple(g.shape[1:]) != grid_shape(h, w, cfg):
        raise ValueError(
            f"{KERNEL}: grid {tuple(g.shape[1:])} != {grid_shape(h, w, cfg)} "
            f"for {h}x{w} frames at r={cfg.r}"
        )


def bg_slice_plain(grid_f: torch.Tensor, image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """Plain PyTorch TI on any device, with the kernel's corners, fractions
    and lerp order: ``(gx, gy, gz)`` + ``(h, w)`` -> ``(h, w)``, or batched."""
    g, x = _operands(grid_f, image)
    b, h, w = x.shape
    _check_grid(g, h, w, cfg)
    gx, gy, gz = g.shape[1:]
    r = cfg.r
    dev = x.device
    fz = x * float(np.float32(1.0 / cfg.range_scale))
    zfl = torch.floor(fz)
    zf = fz - zfl
    z0 = zfl.long()
    rows = torch.arange(h, device=dev)
    x0 = (rows // r)[None, :, None]
    x1 = torch.clamp(x0 + 1, max=gx - 1)
    wx = torch.as_tensor((np.arange(r) / r).astype(np.float32), device=dev)[rows % r][
        None, :, None
    ]
    wy = torch.as_tensor(ti_col_fracs(w, r), device=dev)[None, None, :]
    cols = torch.arange(w, device=dev)
    y0 = (cols // r)[None, None, :]
    y1 = torch.clamp(y0 + 1, max=gy - 1)
    frame = torch.arange(b, device=dev)[:, None, None]
    flat = g.reshape(-1)

    def at(plane, z, y):
        return flat[((frame * gx + plane) * gy + y) * gz + z]

    def ti_bin(z):
        ok = ((z >= 0) & (z < gz)).to(torch.float32)
        zc = z.clamp(0, gz - 1)
        a0 = at(x0, zc, y0) * (1.0 - wy) + at(x0, zc, y1) * wy
        a1 = at(x1, zc, y0) * (1.0 - wy) + at(x1, zc, y1) * wy
        return (a0 * (1.0 - wx) + a1 * wx) * ok

    out = (1.0 - zf) * ti_bin(z0) + zf * ti_bin(z0 + 1)
    return out[0] if image.dim() == 2 else out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bg_slice_launch.argtypes = [p] * 5 + [i] * 7 + [f, i, p]
    lib.bg_slice_launch.restype = i
    return lib


def bg_slice(grid_f: torch.Tensor, image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """TI of a normalized grid at the frames' intensities: ``(gx, gy, gz)``
    + ``(h, w)`` -> ``(h, w)``, or ``(b, gx, gy, gz)`` + ``(b, h, w)`` ->
    ``(b, h, w)``, float32. CPU tensors run :func:`bg_slice_plain`; CUDA
    tensors run one kernel launch over the batch on the current stream,
    counted in ``bg_slice.launches``."""
    g, x = _operands(grid_f, image)
    if not _wrap.on_card(x, KERNEL):
        return bg_slice_plain(grid_f, image, cfg)
    _wrap.contiguous(x, "frames", KERNEL)
    _wrap.contiguous(g, "grids", KERNEL)
    b, h, w = x.shape
    _check_grid(g, h, w, cfg)
    gx, gy, gz = g.shape[1:]
    if b > 65535 or h * w >= 2**31:
        raise ValueError(f"bg_slice: {b} frames of {h}x{w} exceed one launch")
    yf, xf = _wrap.ti_fracs(w, cfg.r, x.device)
    out = torch.empty_like(x)
    err = _lib().bg_slice_launch(
        g.data_ptr(), x.data_ptr(), out.data_ptr(), yf.data_ptr(), xf.data_ptr(),
        b, h, w, cfg.r, gx, gy, gz, float(np.float32(1.0 / cfg.range_scale)),
        x.device.index, _wrap.stream(x.device),
    )
    _build.check(KERNEL, err)
    bg_slice.launches += 1
    return out[0] if image.dim() == 2 else out


bg_slice.launches = 0
