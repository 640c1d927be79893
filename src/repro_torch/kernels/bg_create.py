"""Standalone grid creation (GC): the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/bg_create.cu``, B4) replaces the JAX package's GC Pallas
kernel (``repro/kernels/bg_create.py:68``): frames in, the ``(count, sum)``
grid out in HBM, in the JAX layout ``(gx, gy, gz, 2)`` per frame. It bins as
the fused kernel does (the same device function): z bin ``floor(px / rs +
0.5)``, the reference's rule, integer round-half-up row and column cells,
pixels whose bin falls outside ``[0, gz)`` dropped. Each cell adds its pixels in a fixed
order (``bg::gc_cell``'s, the fused kernels'), so a frame's grid does not
depend on the batch, the launch or the split. A block walks a band of
x-planes of one column tile, each plane's rows staged in shared memory;
:func:`create_geometry` sizes the band, the tile and the z bins per task.
See the source for the design.

A CPU tensor runs :func:`bg_create_plain`; a CUDA tensor runs the kernel or
the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bilateral_grid import _divide
from repro_torch.reliability.errors import KernelLaunchError

from . import _build, _wrap
from .common import BGConfig, gc_cells, gc_row_split, grid_shape

__all__ = ["bg_create", "bg_create_plain", "CreateGeometry", "create_geometry", "create_smem_bytes"]

KERNEL = "bg_create"
THREADS = 256  # the kernel's kThreads
# The split rule (create_geometry), set from the sweep of its knobs at b = 1,
# 4 and 8 on an H100 (chip_smoke.py, phase "create_sweep"; PERF.md has the
# numbers): tasks of _ZGROUP z bins; column tiles of about one task per
# thread, halved until an SM holds _MIN_BLOCKS_PER_SM blocks, then cut
# finer until the launch has _LAUNCH_BLOCKS_PER_SM blocks per SM; bands of
# about _BAND_PX pixels of the tile (one plane at PAPER_DEFAULT). An SM holds
# at most _MAX_BLOCKS_PER_SM blocks of THREADS threads (2048 threads), and
# the card reserves _SMEM_PER_BLOCK bytes of shared memory per block.
_ZGROUP = 2
_MIN_BLOCKS_PER_SM = 4
_LAUNCH_BLOCKS_PER_SM = 2.5
_BAND_PX = 8192
_MAX_BLOCKS_PER_SM = 8
_SMEM_PER_BLOCK = 1024


class CreateGeometry(NamedTuple):
    """One B4 launch: ``band`` raw planes x ``tile`` column cells per
    block, ``bands`` x ``tiles`` blocks per frame, tasks of ``zgroup`` z
    bins, a ring of ``ring_rows`` rows, ``smem`` bytes of dynamic shared
    memory per block."""

    band: int
    bands: int
    tile: int
    tiles: int
    zgroup: int
    ring_rows: int
    smem: int


def bin_divisor(cfg: BGConfig) -> Tuple[float, float]:
    """``(rs, rcp_rs)`` the kernels' z bin divides by (``bg::gc_bin``): the
    float32 range scale and its correctly rounded float32 reciprocal."""
    rs = np.float32(cfg.range_scale)
    return float(rs), float(np.float32(1.0) / rs)


def bg_create_plain(image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """Plain PyTorch GC on any device: ``(h, w)`` -> ``(gx, gy, gz, 2)``,
    ``(b, h, w)`` -> ``(b, gx, gy, gz, 2)``, channel 0 the count and 1 the
    sum, with the kernel's bins. ``index_put_`` with accumulation adds each
    cell in a fixed order."""
    x = _wrap.frames(image, KERNEL)
    b, h, w = x.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    dev = x.device
    zbin = torch.floor(_divide(x, cfg.range_scale) + 0.5).long()
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


def ring_rows(r: int, band: int) -> int:
    """Rows of B4's ring: one plane (``r`` rows) for a band of one plane,
    else two (plane x+1 in flight while plane x is binned), rounded up to a
    multiple of 4 (so that every ring row keeps its HBM row's 16-byte
    alignment)."""
    return -(-(r if band == 1 else 2 * r) // 4) * 4


def create_smem_bytes(tile: int, r: int, rows: int) -> int:
    """Dynamic shared memory of one B4 block over ``tile`` column cells with
    a ring of ``rows`` rows: the 16 bytes of the bulk copies' mbarrier; a
    plane's z bin bytes, ``r`` rows of ``tile * r`` columns to a multiple
    of 4 (at least ``4 r`` bytes), to 16 bytes; then the ring, each row
    ``tile * r`` floats plus three of alignment, to a multiple of 4, plus up
    to three for the frame width."""
    nw = tile * r
    zbytes = -(-max(r * -(-nw // 4) * 4, 4 * r) // 16) * 16
    return 16 + zbytes + rows * (-(-(nw + 3) // 4) * 4 + 3) * 4


def create_geometry(
    b: int,
    h: int,
    w: int,
    cfg: BGConfig,
    num_sms: int,
    smem_limit: int,
    band: Optional[int] = None,
    tile: Optional[int] = None,
    zgroup: Optional[int] = None,
) -> CreateGeometry:
    """The :class:`CreateGeometry` of a B4 launch over ``b`` frames.

    Defaults: tasks of ``_ZGROUP`` z bins; column tiles of ``THREADS //
    groups`` cells (``groups = ceil(gz / zgroup)``: one task per thread),
    halved until an SM holds ``_MIN_BLOCKS_PER_SM`` blocks with a one-plane
    ring, then cut into more tiles until the launch has
    ``_LAUNCH_BLOCKS_PER_SM`` blocks per SM (at most one tile per cell), and
    evened out over the row of cells; bands of ``_BAND_PX // (tile * r * r)``
    planes, at least 1, shortened until every SM gets a block. Explicit
    knobs are cut to the grid; a tile whose one-plane ring does not fit
    ``smem_limit`` is halved until it does, and a band whose two-plane ring
    does not fit becomes one plane. A grid with more than 255 z bins (a bin
    is a byte), or whose one-cell tile of one plane does not fit, raises
    ``ValueError``.
    """
    gx, gy, gz = grid_shape(h, w, cfg)
    r = cfg.r
    if gz > 255:
        raise ValueError(f"bg_create: gz={gz} z bins do not fit a byte (at most 255)")
    need = create_smem_bytes(1, r, ring_rows(r, 1))
    if need > smem_limit:
        raise ValueError(
            f"bg_create: one column cell of a {h}x{w} frame at r={r} needs {need} bytes "
            f"of shared memory per block, above the card's {smem_limit}"
        )
    if zgroup is None:
        zgroup = _ZGROUP
    if zgroup not in (1, 2, 4):
        raise ValueError(f"bg_create: zgroup must be 1, 2 or 4, got {zgroup}")
    fits = lambda t, rows: create_smem_bytes(t, r, rows) <= smem_limit
    if tile is None:
        per_sm = lambda t: smem_limit // (create_smem_bytes(t, r, ring_rows(r, 1)) + _SMEM_PER_BLOCK)
        tile = max(1, THREADS // -(-gz // zgroup))
        while tile > 1 and per_sm(tile) < _MIN_BLOCKS_PER_SM:
            tile = -(-tile // 2)
        tiles = -(-gy // tile)
        while tiles < gy and b * gx * tiles < _LAUNCH_BLOCKS_PER_SM * num_sms:
            tiles += 1
        tile = -(-gy // tiles)
    tile = max(1, min(tile, gy))
    while tile > 1 and not fits(tile, ring_rows(r, 1)):
        tile = -(-tile // 2)
    tiles = -(-gy // tile)
    if band is None:
        band = max(1, _BAND_PX // (tile * r * r))
        while band > 1 and b * -(-gx // band) * tiles < num_sms:
            band -= 1
    band = max(1, min(band, gx))
    if not fits(tile, ring_rows(r, band)):
        band = 1
    rows = ring_rows(r, band)
    return CreateGeometry(band, -(-gx // band), tile, tiles, zgroup, rows,
                          create_smem_bytes(tile, r, rows))


class CreateShape(ctypes.Structure):
    """``csrc/bg_create.cu``'s ``CreateShape``: a launch's shape and
    geometry, built once per shape and passed by pointer."""

    _fields_ = [(f, ctypes.c_int) for f in ("b", "h", "w", "r", "gx", "gy", "gz", "split", "band",
                                            "tile", "zgroup", "ring_rows")] + \
               [(f, ctypes.c_float) for f in ("rs", "rcp_rs")] + \
               [(f, ctypes.c_int) for f in ("smem_bytes", "device")]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load(KERNEL, {"bg_create_launch": ([p] * 4, i), "bg_create_smem_optin": ([i], i)})


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(SM count, opt-in shared memory per block) of CUDA device ``index``."""
    smem = _lib().bg_create_smem_optin(index)
    if smem <= 0:
        raise KernelLaunchError(f"bg_create: cannot query shared memory of cuda:{index}")
    return torch.cuda.get_device_properties(index).multi_processor_count, smem


@functools.lru_cache(maxsize=256)
def _launch_args(b: int, h: int, w: int, cfg: BGConfig, index: int, knobs) -> tuple:
    """``(geometry, shape, address)`` of a launch, cached per shape, config
    and knobs (a launch takes microseconds, so its host work must too)."""
    num_sms, smem_limit = _device_limits(index)
    geo = create_geometry(b, h, w, cfg, num_sms, smem_limit, **dict(knobs))
    gx, gy, gz = grid_shape(h, w, cfg)
    shape = CreateShape(b, h, w, cfg.r, gx, gy, gz, gc_row_split(cfg.r), geo.band, geo.tile,
                        geo.zgroup, geo.ring_rows, *bin_divisor(cfg), geo.smem, index)
    return geo, shape, ctypes.addressof(shape)


def _launch(x: torch.Tensor, out: torch.Tensor, cfg: BGConfig, **knobs) -> CreateGeometry:
    """One kernel launch over the contiguous (b, h, w) CUDA frames ``x``
    into the (b, gx, gy, gz, 2) grid ``out``; ``knobs`` (``band``,
    ``tile``, ``zgroup``) override :func:`create_geometry`'s rule (for
    sweeps); returns the geometry launched."""
    b, h, w = x.shape
    geo, _, shape = _launch_args(b, h, w, cfg, x.device.index, tuple(sorted(knobs.items())))
    err = _lib().bg_create_launch(x.data_ptr(), out.data_ptr(), shape, _wrap.stream(x.device))
    _build.check(KERNEL, err)
    _wrap.count(bg_create, "launches")
    return geo


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
    if b > 65535 or gy > 65535 or h * w >= 2**31:
        raise ValueError(f"bg_create: {b} frames of {h}x{w} exceed one launch")
    out = torch.empty((b, gx, gy, gz, 2), dtype=torch.float32, device=x.device)
    _launch(x, out, cfg)
    return out[0] if image.dim() == 2 else out


bg_create.launches = 0
