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
the wrapper raises. :func:`slice_geometry` cuts the frames into the
kernel's blocks.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.reliability.errors import KernelLaunchError

from . import _build, _wrap
from .common import BGConfig, grid_shape, ti_col_fracs

__all__ = ["bg_slice", "bg_slice_plain", "SliceGeometry", "slice_geometry", "slice_smem_bytes"]

KERNEL = "bg_slice"
# The split rule (slice_geometry), set from the sweep of bands and tiles at
# b = 1, 4 and 8 on an H100 (chip_smoke.py, phase "slice_sweep"; PERF.md has
# the numbers): one stripe per block, column tiles of THREADS // r cells
# (one column per thread). A block has THREADS threads (the kernel's
# kThreads).
THREADS = 256


class SliceGeometry(NamedTuple):
    """One B6 launch: ``band`` stripes x ``tile`` column cells per block,
    ``bands`` x ``tiles`` blocks per frame, ``smem`` bytes of dynamic shared
    memory per block."""

    band: int
    bands: int
    tile: int
    tiles: int
    smem: int


def slice_smem_bytes(gz: int) -> int:
    """Dynamic shared memory of one block: each thread's table of y-lerped
    corners, two planes at every z."""
    return 4 * 2 * gz * THREADS


def slice_geometry(
    h: int,
    w: int,
    cfg: BGConfig,
    smem_limit: int,
    band: Optional[int] = None,
    tile: Optional[int] = None,
) -> SliceGeometry:
    """The :class:`SliceGeometry` of a launch over ``h x w`` frames.

    Defaults: one stripe per block and column tiles of ``THREADS // r``
    cells (one column per thread), so one frame alone gives ``ceil(h / r) *
    tiles`` blocks (720 at full HD and r=12), enough for every SM; longer
    bands and other tiles were no faster at b = 1, 4 or 8. A grid whose
    table does not fit ``smem_limit`` raises ``ValueError`` naming the bytes.
    """
    _, _, gz = grid_shape(h, w, cfg)
    r = cfg.r
    n = -(-h // r)
    nc = -(-w // r)
    smem = slice_smem_bytes(gz)
    if smem > smem_limit:
        raise ValueError(
            f"{KERNEL}: a grid with gz={gz} needs {smem} bytes of shared memory "
            f"per block, above the card's {smem_limit}"
        )
    tile = max(1, min(max(1, THREADS // r) if tile is None else tile, nc))
    band = max(1, min(1 if band is None else band, n))
    return SliceGeometry(band, -(-n // band), tile, -(-nc // tile), smem)


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


def bg_slice_plain(grid_f: torch.Tensor, image: torch.Tensor, cfg: BGConfig,
                   zweight_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch TI on any device, with the kernel's corners, fractions
    and lerp order: ``(gx, gy, gz)`` + ``(h, w)`` -> ``(h, w)``, or batched.

    ``zweight_dtype=torch.bfloat16`` rounds the two z weights ``1 - zf`` and
    ``zf`` to bf16 before they weigh the z corners, as the fused kernels'
    bf16 form does (``bg::zlerp``); the staged kernel B6 and its callers
    keep the float32 default, under which this is the kernel's lerp."""
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

    w0, w1 = 1.0 - zf, zf
    if zweight_dtype != torch.float32:
        w0, w1 = (t.to(zweight_dtype).to(torch.float32) for t in (w0, w1))
    out = w0 * ti_bin(z0) + w1 * ti_bin(z0 + 1)
    return out[0] if image.dim() == 2 else out


class SliceShape(ctypes.Structure):
    """``csrc/bg_slice.cu``'s ``SliceShape``: a launch's shape and geometry,
    built once per shape and passed by pointer."""

    _fields_ = [(f, ctypes.c_int) for f in ("b", "h", "w", "r", "gx", "gy", "gz", "band", "tile")] + \
               [("inv_rs", ctypes.c_float), ("smem_bytes", ctypes.c_int), ("device", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    i = ctypes.c_int
    return _build.load(KERNEL, {"bg_slice_launch": ([ctypes.c_void_p] * 7, i),
                                "bg_slice_smem_optin": ([i], i)})


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """Opt-in shared memory per block of CUDA device ``index``."""
    smem = _lib().bg_slice_smem_optin(index)
    if smem <= 0:
        raise KernelLaunchError(f"{KERNEL}: cannot query shared memory of cuda:{index}")
    return smem


@functools.lru_cache(maxsize=256)
def _launch_args(b: int, h: int, w: int, cfg: BGConfig, index: int, band, tile) -> tuple:
    """``(geometry, shape, address)``: the launch's :class:`SliceGeometry`,
    its :class:`SliceShape` (kept alive by the cache) and that struct's
    address, cached per shape, config and knobs."""
    geo = slice_geometry(h, w, cfg, _smem_limit(index), band, tile)
    gx, gy, gz = grid_shape(h, w, cfg)
    shape = SliceShape(b, h, w, cfg.r, gx, gy, gz, geo.band, geo.tile,
                       float(np.float32(1.0 / cfg.range_scale)), geo.smem, index)
    return geo, shape, ctypes.addressof(shape)


def _launch(g: torch.Tensor, x: torch.Tensor, out: torch.Tensor, cfg: BGConfig, band=None,
            tile=None) -> SliceGeometry:
    """One kernel launch: the contiguous (b, gx, gy, gz) CUDA grids ``g`` at
    the (b, h, w) frames ``x`` into ``out``; ``band`` and ``tile`` override
    :func:`slice_geometry`'s rule (for sweeps); returns the geometry
    launched."""
    with tracing.span("kernel.bg_slice"):
        b, h, w = x.shape
        geo, _, shape = _launch_args(b, h, w, cfg, x.device.index, band, tile)
        yf, xf = _wrap.ti_fracs(w, cfg.r, x.device)
        err = _lib().bg_slice_launch(
            g.data_ptr(), x.data_ptr(), out.data_ptr(), yf.data_ptr(), xf.data_ptr(), shape,
            _wrap.stream(x.device),
        )
        _build.check(KERNEL, err)
        _wrap.count(bg_slice, "launches")
        return geo


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
    if b > 65535 or h * w >= 2**31:
        raise ValueError(f"bg_slice: {b} frames of {h}x{w} exceed one launch")
    out = torch.empty_like(x)
    _launch(g, x, out, cfg)
    return out[0] if image.dim() == 2 else out


bg_slice.launches = 0
