"""Fused GC -> GF -> TI bilateral-grid filter: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/bg_fused.cu``) replaces the JAX package's per-frame fused
Pallas kernel (``repro/kernels/bg_fused.py::_kernel``, launch at ``:645``).
It computes, per frame, the paper's grid creation, Gaussian grid filter with
per-cell normalization and trilinear slice, unquantized, with the grid held
in shared memory and never written to HBM. See the source for the design.

Dispatch follows the tensor's device and nothing else:

  * a CPU tensor goes to :func:`bg_fused_plain`;
  * a CUDA tensor goes to the kernel, or the wrapper raises.

There is no fallback from the kernel to the plain version. The plain version
is the reference the tests and ``chip_smoke.py`` hold the kernel to.

Per-frame results depend on nothing but the frame: not on the batch it
shares, not on ``batch_tile``, not on how the kernel cuts the frame into
bands (a band recomputes its halo planes with the same code as its
neighbours), and not on the launch (no float atomics).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .common import BGConfig, gc_cells, gc_row_split, grid_shape, taps_np, ti_col_fracs

__all__ = [
    "bg_fused",
    "bg_fused_plain",
    "launch_geometry",
    "smem_bytes",
]

KERNEL = "bg_fused"
# cudaDevAttrMaxSharedMemoryPerBlockOptin of the H100; the wrapper asks the
# card it launches on, the tests use this value for the geometry rules
H100_SMEM_OPTIN = 232448
# The band heuristic: about _BLOCKS_PER_SM blocks per SM, and never more
# than _MAX_BAND stripes per block. On an H100 at 1080x1920, b=8, wider
# bands lose more to fewer resident blocks than they save in recomputed halo
# planes (chip_smoke.py prints the sweep of stripes per block).
_BLOCKS_PER_SM = 2
_MAX_BAND = 2


# ----------------------------------------------------------------- plain
def bg_fused_plain(
    image: torch.Tensor, cfg: BGConfig, batch_tile: Optional[int] = None
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, on any device.

    Batched whole-image GC -> GF -> normalize -> TI in fp32 tensor ops, with
    the kernel's arithmetic: z bin ``floor(px * fp32(1/rs) + 0.5)``, integer
    row and column cells, blur along x, then z, then y, and the kernel's
    TI lerp order. It uses no matmul and no convolution, so TF32 settings do
    not reach it. ``batch_tile`` bounds the frames per pass (memory only; the
    result does not depend on it).
    """
    _check_batch_tile(batch_tile)
    x = _frames(image)
    b = x.shape[0]
    bt = b if batch_tile is None else min(batch_tile, b)
    out = torch.cat([_plain_frames(x[i:i + bt], cfg) for i in range(0, b, bt)])
    return out[0] if image.dim() == 2 else out


def _plain_frames(x: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    b, h, w = x.shape
    r = cfg.r
    gx, gy, gz = grid_shape(h, w, cfg)
    dev = x.device
    taps = tuple(float(t) for t in taps_np(cfg))
    inv_rs = float(np.float32(1.0 / cfg.range_scale))
    frame = torch.arange(b, device=dev)[:, None, None]

    # ---- GC: scatter (1, px) into (b, gx, 2, gz, gy); index_put_ with
    # accumulate sums each cell in a fixed order
    zbin = torch.floor(x * inv_rs + 0.5).long()
    inside = ((zbin >= 0) & (zbin < gz)).to(torch.float32)
    xc = torch.as_tensor(gc_cells(h, r), device=dev)[None, :, None]
    yc = torch.as_tensor(gc_cells(w, r), device=dev)[None, None, :]
    cell = ((frame * gx + xc) * gz + zbin.clamp(0, gz - 1)) * gy + yc
    grid = torch.zeros((2, b * gx * gz * gy), dtype=torch.float32, device=dev)
    flat = cell.reshape(-1)
    grid[0].index_put_((flat,), inside.reshape(-1), accumulate=True)
    grid[1].index_put_((flat,), (x * inside).reshape(-1), accumulate=True)
    grid = grid.reshape(2, b, gx, gz, gy).permute(1, 2, 0, 3, 4)  # (b, gx, 2, gz, gy)

    # ---- GF: x, z, y with zero borders, then eq. (4) per cell
    blurred = grid
    for axis in (1, 3, 4):
        blurred = _conv3(blurred, taps, axis)
    count, summ = blurred[:, :, 0], blurred[:, :, 1]
    norm = torch.where(
        count > 1e-12, summ / torch.clamp(count, min=1e-12), torch.zeros_like(summ)
    )  # (b, gx, gz, gy)

    # ---- TI: stripe k = i // r against planes k, k+1; kernel lerp order
    fz = x * inv_rs
    zfl = torch.floor(fz)
    zf = fz - zfl
    z0 = zfl.long()
    rows = torch.arange(h, device=dev)
    k = (rows // r)[None, :, None]
    wx = torch.as_tensor((np.arange(r) / r).astype(np.float32), device=dev)[rows % r][
        None, :, None
    ]
    wy = torch.as_tensor(ti_col_fracs(w, r), device=dev)[None, None, :]
    cols = torch.arange(w, device=dev)
    y0 = (cols // r)[None, None, :]
    y1 = torch.clamp(y0 + 1, max=gy - 1)
    flat_norm = norm.reshape(-1)

    def at(plane, z, y):
        return flat_norm[((frame * gx + plane) * gz + z) * gy + y]

    def ti_bin(z):
        ok = ((z >= 0) & (z < gz)).to(torch.float32)
        zc = z.clamp(0, gz - 1)
        a0 = at(k, zc, y0) * (1.0 - wy) + at(k, zc, y1) * wy
        a1 = at(k + 1, zc, y0) * (1.0 - wy) + at(k + 1, zc, y1) * wy
        return (a0 * (1.0 - wx) + a1 * wx) * ok

    return (1.0 - zf) * ti_bin(z0) + zf * ti_bin(z0 + 1)


def _conv3(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """t0*lo + t1*x + t2*hi along ``axis`` with zero borders."""
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    lo = torch.cat([zero, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    hi = torch.cat([x.narrow(axis, 1, x.shape[axis] - 1), zero], dim=axis)
    return taps[0] * lo + taps[1] * x + taps[2] * hi


# ---------------------------------------------------------------- kernel
def smem_bytes(band: int, gz: int, gy: int) -> int:
    """Dynamic shared memory of one block that owns ``band`` stripes: raw
    planes (count, sum) k0-1 .. k1+1 and normalized planes k0 .. k1."""
    return 4 * gz * gy * (2 * (band + 3) + (band + 1))


def launch_geometry(
    b: int,
    h: int,
    w: int,
    cfg: BGConfig,
    num_sms: int,
    smem_limit: int,
    band: Optional[int] = None,
) -> Tuple[int, int, int]:
    """``(band, bands_per_frame, smem_bytes)`` of a launch over ``b`` frames.

    ``band`` (stripes per block) defaults to a value that gives the card
    about ``_BLOCKS_PER_SM`` blocks per SM, at most ``_MAX_BAND``, cut to
    what fits ``smem_limit`` bytes of shared memory. A frame whose
    single-stripe working set does not fit raises ``ValueError``: the kernel
    has no y tiling yet.
    """
    _, gy, gz = grid_shape(h, w, cfg)
    n = -(-h // cfg.r)
    need = smem_bytes(1, gz, gy)
    if need > smem_limit:
        raise ValueError(
            f"bg_fused: one stripe of a {h}x{w} frame at r={cfg.r} (gy={gy}, "
            f"gz={gz}) needs {need} bytes of shared memory per block, above "
            f"the card's {smem_limit}; this shape needs y tiling, which the "
            f"kernel does not have yet"
        )
    fit = 1
    while fit < n and smem_bytes(fit + 1, gz, gy) <= smem_limit:
        fit += 1
    if band is None:
        band = min(_MAX_BAND, (b * n) // (_BLOCKS_PER_SM * num_sms))
    band = max(1, min(band, fit, n))
    return band, -(-n // band), smem_bytes(band, gz, gy)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bg_fused_launch.argtypes = [p, p, p, p] + [i] * 8 + [f] * 4 + [i, i, p]
    lib.bg_fused_launch.restype = i
    lib.bg_fused_smem_optin.argtypes = [i]
    lib.bg_fused_smem_optin.restype = i
    lib.bg_fused_error_string.argtypes = [i]
    lib.bg_fused_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> Tuple[int, int]:
    """(SM count, opt-in shared memory per block) of CUDA device ``index``."""
    smem = _lib().bg_fused_smem_optin(index)
    if smem <= 0:
        raise RuntimeError(f"bg_fused: cannot query shared memory of cuda:{index}")
    return torch.cuda.get_device_properties(index).multi_processor_count, smem


@functools.lru_cache(maxsize=64)
def _ti_fracs(w: int, r: int, device: torch.device):
    """(yf, xf) lerp fractions as the JAX kernel computes them, on device."""
    xf = (np.arange(r) / r).astype(np.float32)
    return (
        torch.as_tensor(ti_col_fracs(w, r), device=device),
        torch.as_tensor(xf, device=device),
    )


def _launch(x: torch.Tensor, out: torch.Tensor, cfg: BGConfig, band=None) -> None:
    """One kernel launch over the contiguous (b, h, w) CUDA frames ``x``."""
    b, h, w = x.shape
    dev = x.device
    num_sms, smem_limit = _device_limits(dev.index)
    band, _, smem = launch_geometry(b, h, w, cfg, num_sms, smem_limit, band)
    _, gy, gz = grid_shape(h, w, cfg)
    yf, xf = _ti_fracs(w, cfg.r, dev)
    t0, t1, t2 = (float(t) for t in taps_np(cfg))
    err = _lib().bg_fused_launch(
        x.data_ptr(), out.data_ptr(), yf.data_ptr(), xf.data_ptr(),
        b, h, w, cfg.r, gy, gz, gc_row_split(cfg.r), band,
        float(np.float32(1.0 / cfg.range_scale)), t0, t1, t2,
        smem, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = _lib().bg_fused_error_string(err).decode()
        raise RuntimeError(f"bg_fused launch failed: CUDA error {err} ({msg})")
    bg_fused.launches += 1


def bg_fused(
    image: torch.Tensor, cfg: BGConfig, batch_tile: Optional[int] = None
) -> torch.Tensor:
    """Fused BG filter, (h, w) -> (h, w) or (b, h, w) -> (b, h, w), float32,
    unquantized, paper normalization.

    CPU tensors run :func:`bg_fused_plain`; CUDA tensors run the kernel, one
    launch per ``batch_tile`` frames (``None``: all frames in one launch), on
    the current stream. ``bg_fused.launches`` counts kernel launches.
    """
    _check_batch_tile(batch_tile)
    if cfg.normalize_mode != "paper":
        raise ValueError(
            f"bg_fused implements the paper normalization mode, got "
            f"{cfg.normalize_mode!r}"
        )
    x = _frames(image)
    if x.device.type == "cpu":
        return bg_fused_plain(image, cfg, batch_tile)
    if x.device.type != "cuda":
        raise ValueError(f"bg_fused runs on CUDA or CPU tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("bg_fused needs contiguous frames")
    b, h, w = x.shape
    if b > 65535 or h * w >= 2**31:
        raise ValueError(f"bg_fused: {b} frames of {h}x{w} exceed one launch")
    out = torch.empty_like(x)
    bt = b if batch_tile is None else batch_tile
    for i in range(0, b, bt):
        _launch(x[i:i + bt], out[i:i + bt], cfg)
    return out[0] if image.dim() == 2 else out


bg_fused.launches = 0


def _frames(image: torch.Tensor) -> torch.Tensor:
    if not isinstance(image, torch.Tensor):
        raise TypeError(f"bg_fused takes a torch.Tensor, got {type(image).__name__}")
    if image.dtype != torch.float32:
        raise TypeError(f"bg_fused takes float32 frames, got {image.dtype}")
    if image.dim() == 2:
        image = image[None]
    if image.dim() != 3 or min(image.shape) < 1:
        raise ValueError(f"bg_fused takes (h, w) or (b, h, w) frames, got {tuple(image.shape)}")
    return image


def _check_batch_tile(batch_tile) -> None:
    if batch_tile is not None and (
        isinstance(batch_tile, bool) or not isinstance(batch_tile, int) or batch_tile < 1
    ):
        raise ValueError(f"batch_tile must be a positive int or None, got {batch_tile!r}")
