"""Standalone grid creation (GC): the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/bg_create.cu``, B4) replaces the JAX package's GC Pallas
kernel (``repro/kernels/bg_create.py:68``): frames in, the ``(count, sum)``
grid out in HBM, in the JAX layout ``(gx, gy, gz, 2)`` per frame. It bins as
the fused kernel does (the same device function): z bin ``floor(px *
fp32(1/rs) + 0.5)``, integer round-half-up row and column cells, pixels whose
bin falls outside ``[0, gz)`` dropped. Each cell adds its pixels in a fixed
order, so a frame's grid does not depend on the batch or the launch.

A CPU tensor runs :func:`bg_create_plain`; a CUDA tensor runs the kernel or
the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, _wrap
from .common import BGConfig, gc_cells, gc_row_split, grid_shape

__all__ = ["bg_create", "bg_create_plain", "create_threads"]

KERNEL = "bg_create"
_THREADS = 128  # y cells per block
_SMEM_STATIC = 48 * 1024  # the kernel asks for no more shared memory than this


def _inv_rs(cfg: BGConfig) -> float:
    return float(np.float32(1.0 / cfg.range_scale))


def bg_create_plain(image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """Plain PyTorch GC on any device: ``(h, w)`` -> ``(gx, gy, gz, 2)``,
    ``(b, h, w)`` -> ``(b, gx, gy, gz, 2)``, channel 0 the count and 1 the
    sum, with the kernel's bins. ``index_put_`` with accumulation adds each
    cell in a fixed order."""
    x = _wrap.frames(image, KERNEL)
    b, h, w = x.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    dev = x.device
    zbin = torch.floor(x * _inv_rs(cfg) + 0.5).long()
    inside = ((zbin >= 0) & (zbin < gz)).to(torch.float32)
    frame = torch.arange(b, device=dev)[:, None, None]
    xc = torch.as_tensor(gc_cells(h, cfg.r), device=dev)[None, :, None]
    yc = torch.as_tensor(gc_cells(w, cfg.r), device=dev)[None, None, :]
    cell = ((((frame * gx + xc) * gy + yc) * gz + zbin.clamp(0, gz - 1)) * 2).reshape(-1)
    grid = torch.zeros(b * gx * gy * gz * 2, dtype=torch.float32, device=dev)
    grid.index_put_((cell,), inside.reshape(-1), accumulate=True)
    grid.index_put_((cell + 1,), (x * inside).reshape(-1), accumulate=True)
    grid = grid.reshape(b, gx, gy, gz, 2)
    return grid[0] if image.dim() == 2 else grid


def create_threads(gz: int) -> int:
    """Threads (y cells) per block: ``_THREADS``, fewer when their ``2*gz``
    float bins each would pass 48 KB of shared memory. Raises ``ValueError``
    naming the bytes when not even one warp fits."""
    per_thread = 2 * gz * 4
    threads = min(_THREADS, _SMEM_STATIC // per_thread // 32 * 32)
    if threads < 32:
        raise ValueError(
            f"bg_create: gz={gz} needs {32 * per_thread} bytes of shared "
            f"memory for one warp of grid columns, above {_SMEM_STATIC}"
        )
    return threads


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bg_create_launch.argtypes = [p, p] + [i] * 8 + [f, i, i, p]
    lib.bg_create_launch.restype = i
    return lib


def bg_create(image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """GC, ``(h, w)`` -> ``(gx, gy, gz, 2)`` or ``(b, h, w)`` -> ``(b, gx,
    gy, gz, 2)``, float32. CPU tensors run :func:`bg_create_plain`; CUDA
    tensors run one kernel launch over the batch on the current stream,
    counted in ``bg_create.launches``."""
    x = _wrap.frames(image, KERNEL)
    if not _wrap.on_card(x, KERNEL):
        return bg_create_plain(image, cfg)
    _wrap.contiguous(x, "frames", KERNEL)
    b, h, w = x.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    if b > 65535 or gx > 65535 or h * w >= 2**31:
        raise ValueError(f"bg_create: {b} frames of {h}x{w} exceed one launch")
    threads = create_threads(gz)
    out = torch.empty((b, gx, gy, gz, 2), dtype=torch.float32, device=x.device)
    err = _lib().bg_create_launch(
        x.data_ptr(), out.data_ptr(), b, h, w, cfg.r, gx, gy, gz,
        gc_row_split(cfg.r), _inv_rs(cfg), threads, x.device.index,
        _wrap.stream(x.device),
    )
    _build.check(KERNEL, err)
    bg_create.launches += 1
    return out[0] if image.dim() == 2 else out


bg_create.launches = 0
