"""Standalone grid filter (GF): the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/bg_blur.cu``, B5) replaces the JAX package's GF Pallas
kernel (``repro/kernels/bg_blur.py:57``): the separable 3x3x3 Gaussian on
both homogeneous channels of a ``(…, gx, gy, gz, 2)`` grid in HBM, zero
borders, taps along x, then z, then y (the fused kernel's order, the same
device function, so its values equal the fused kernel's bit for bit). A block walks a run of x-planes of one y tile with a ring
of planes in shared memory; :func:`blur_geometry` sizes the run and the
tile.

A CPU tensor runs :func:`bg_blur_plain`; a CUDA tensor runs the kernel or
the wrapper raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.reliability.errors import KernelLaunchError

from . import _build, _wrap
from .common import BGConfig, conv3_axis, taps_np

__all__ = ["bg_blur", "bg_blur_plain", "blur_geometry", "blur_smem_bytes"]

KERNEL = "bg_blur"
# The split rule: about _BLOCKS_PER_SM blocks per SM, from runs of x-planes
# when the batch has enough planes, else from y tiles of single planes; set
# from the sweep of runs and tiles at b = 1, 4 and 8 on an H100 (chip_smoke.py,
# phase "kernel_sweep"; PERF.md has the numbers).
_BLOCKS_PER_SM = 2


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


def blur_smem_bytes(ytile: int, gz: int) -> int:
    """Dynamic shared memory of one block over ``ytile`` y-cells: a ring of
    four plane tiles and the x-mixed tile, each ``(ytile + 2) * gz * 2``
    floats (the tile and its y halo, both channels)."""
    return 5 * (ytile + 2) * gz * 2 * 4


def blur_geometry(
    b: int,
    gx: int,
    gy: int,
    gz: int,
    num_sms: int,
    smem_limit: int,
    run: Optional[int] = None,
    ytile: Optional[int] = None,
) -> Tuple[int, int, int, int, int]:
    """``(run, runs_per_frame, ytile, ytiles_per_frame, smem_bytes)`` of a
    launch over ``b`` grids.

    By default a block owns whole planes (``ytile = gy``) and a run of
    ``b * gx // (_BLOCKS_PER_SM * num_sms)`` of them; a batch with fewer
    planes than that many blocks gets one plane per block and y tiles
    instead. Either is cut to what fits ``smem_limit``; a grid whose
    one-cell tile does not fit raises ``ValueError`` naming the bytes.
    """
    need = blur_smem_bytes(1, gz)
    if need > smem_limit:
        raise ValueError(
            f"bg_blur: a one-cell tile of a grid with gz={gz} needs {need} bytes "
            f"of shared memory per block, above the card's {smem_limit}"
        )
    fit = min(gy, smem_limit // (5 * 2 * gz * 4) - 2)
    target = _BLOCKS_PER_SM * num_sms
    if ytile is None:
        ytile = gy if b * gx >= target else -(-gy // -(-target // (b * gx)))
    ytile = max(1, min(ytile, fit))
    ytiles = -(-gy // ytile)
    if run is None:
        run = (b * gx * ytiles) // target
    run = max(1, min(run, gx))
    return run, -(-gx // run), ytile, ytiles, blur_smem_bytes(ytile, gz)


class BlurShape(ctypes.Structure):
    """``csrc/bg_blur.cu``'s ``BlurShape``: a launch's shape, built once per
    shape and passed by pointer."""

    _fields_ = [(f, ctypes.c_int) for f in ("b", "gx", "gy", "gz", "run", "ytile")] + \
               [(f, ctypes.c_float) for f in ("t0", "t1", "t2")] + \
               [(f, ctypes.c_int) for f in ("smem_bytes", "device")]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load(KERNEL, {"bg_blur_launch": ([p] * 4, i), "bg_blur_smem_optin": ([i], i)})


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(SM count, opt-in shared memory per block) of CUDA device ``index``."""
    smem = _lib().bg_blur_smem_optin(index)
    if smem <= 0:
        raise KernelLaunchError(f"bg_blur: cannot query shared memory of cuda:{index}")
    return torch.cuda.get_device_properties(index).multi_processor_count, smem


@functools.lru_cache(maxsize=256)
def _launch_args(b: int, gx: int, gy: int, gz: int, index: int, cfg: BGConfig, run, ytile) -> tuple:
    """``(shape, address)``: the launch's :class:`BlurShape` and that
    struct's address, cached: a launch takes microseconds, so its host work
    must too."""
    num_sms, smem_limit = _device_limits(index)
    run, _, ytile, _, smem = blur_geometry(b, gx, gy, gz, num_sms, smem_limit, run, ytile)
    t0, t1, t2 = (float(t) for t in taps_np(cfg))
    shape = BlurShape(b, gx, gy, gz, run, ytile, t0, t1, t2, smem, index)
    return shape, ctypes.addressof(shape)


def _launch(g: torch.Tensor, out: torch.Tensor, cfg: BGConfig, run=None, ytile=None) -> None:
    """One kernel launch over the contiguous (b, gx, gy, gz, 2) CUDA grids
    ``g`` into ``out``; ``run`` and ``ytile`` override :func:`blur_geometry`'s
    rule (for sweeps)."""
    with tracing.span("kernel.bg_blur"):
        _, shape = _launch_args(*g.shape[:4], g.device.index, cfg, run, ytile)
        err = _lib().bg_blur_launch(g.data_ptr(), out.data_ptr(), shape, _wrap.stream(g.device))
        _build.check(KERNEL, err)
        _wrap.count(bg_blur, "launches")


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
    if b > 65535 or gy > 65535 or gx * gy * gz * 2 >= 2**31:
        raise ValueError(f"bg_blur: {tuple(g.shape)} exceeds one launch")
    out = torch.empty_like(g)
    _launch(g, out, cfg)
    return out[0] if grid.dim() == 4 else out


bg_blur.launches = 0
