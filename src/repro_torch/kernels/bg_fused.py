"""Fused GC -> GF -> TI bilateral-grid filter: the CUDA kernel's wrapper and
its plain PyTorch version, per frame and temporal.

The kernel (``csrc/bg_fused.cu``) replaces the JAX package's fused Pallas
kernel (``repro/kernels/bg_fused.py::_kernel``) in both of its launches: per
frame (``:645``, B1) and temporal (``:569``, B2). It computes, per frame, the
paper's grid creation, Gaussian grid filter with per-cell normalization and
trilinear slice, unquantized, with the grid held in shared memory and never
written to HBM. The temporal launch (``carry=`` and ``alpha=``) blends each
blurred homogeneous plane with the frame's carry, ``B' = (1-a) B + a C``,
before TI reads it, and returns ``B'`` as the new carry. See the source for
the design.

Dispatch follows the tensor's device and nothing else:

  * a CPU tensor goes to :func:`bg_fused_plain`;
  * a CUDA tensor goes to the kernel, or the wrapper raises.

There is no fallback from the kernel to the plain version. The plain version
is the reference the tests and ``chip_smoke.py`` hold the kernel to.

Per-frame results depend on nothing but the frame (and its carry row and
alpha): not on the batch it shares, not on ``batch_tile``, not on how the
kernel cuts the frame into bands (a band recomputes its halo planes with the
same code as its neighbours), and not on the launch (no float atomics). An
``alpha == 0`` row of a temporal call equals the per-frame call bit for bit.
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
    image: torch.Tensor,
    cfg: BGConfig,
    batch_tile: Optional[int] = None,
    carry: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the fused kernel, on any device.

    Batched whole-image GC -> GF -> normalize -> TI in fp32 tensor ops, with
    the kernel's arithmetic: z bin ``floor(px * fp32(1/rs) + 0.5)``, integer
    row and column cells, blur along x, then z, then y, and the kernel's
    TI lerp order. It uses no matmul and no convolution, so TF32 settings do
    not reach it. ``batch_tile`` bounds the frames per pass (memory only; the
    result does not depend on it). With ``carry`` and ``alpha`` it is the
    temporal version and returns ``(out, new_carry)`` (see :func:`bg_fused`).
    """
    _check_batch_tile(batch_tile)
    x, carry, alpha = _operands(image, cfg, carry, alpha)
    b = x.shape[0]
    bt = b if batch_tile is None else min(batch_tile, b)
    if carry is None:
        out = torch.cat([_plain_frames(x[i:i + bt], cfg) for i in range(0, b, bt)])
        return out[0] if image.dim() == 2 else out
    parts = [
        _plain_frames(x[i:i + bt], cfg, carry[i:i + bt], alpha[i:i + bt])
        for i in range(0, b, bt)
    ]
    out = torch.cat([p[0] for p in parts])
    new_carry = torch.cat([p[1] for p in parts])
    return (out[0], new_carry[0]) if image.dim() == 2 else (out, new_carry)


def _plain_frames(x: torch.Tensor, cfg: BGConfig, carry=None, alpha=None):
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

    # ---- GF: x, z, y with zero borders
    blurred = grid
    for axis in (1, 3, 4):
        blurred = _conv3(blurred, taps, axis)
    if carry is not None:
        # ---- temporal EMA of the blurred homogeneous grid, the kernel's
        # rounding: each product and the sum rounded on its own
        a = alpha.reshape(b, 1, 1, 1, 1)
        blurred = (1.0 - a) * blurred + a * carry.permute(0, 1, 4, 3, 2)
    # ---- eq. (4) per cell
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

    out = (1.0 - zf) * ti_bin(z0) + zf * ti_bin(z0 + 1)
    if carry is None:
        return out
    return out, blurred.permute(0, 1, 4, 3, 2).contiguous()  # (b, gx, gy, gz, 2)


def _conv3(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """t0*lo + t1*x + t2*hi along ``axis`` with zero borders."""
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    lo = torch.cat([zero, x.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    hi = torch.cat([x.narrow(axis, 1, x.shape[axis] - 1), zero], dim=axis)
    return taps[0] * lo + taps[1] * x + taps[2] * hi


# ---------------------------------------------------------------- kernel
def smem_bytes(band: int, gz: int, gy: int, temporal: bool = False) -> int:
    """Dynamic shared memory of one block that owns ``band`` stripes: raw
    planes (count, sum) k0-1 .. k1+1 and normalized planes k0 .. k1, and for
    a temporal launch one more of each (the last band's drain plane when
    ``h % r == 0``)."""
    t = int(temporal)
    return 4 * gz * gy * (2 * (band + 3 + t) + (band + 1 + t))


def launch_geometry(
    b: int,
    h: int,
    w: int,
    cfg: BGConfig,
    num_sms: int,
    smem_limit: int,
    band: Optional[int] = None,
    temporal: bool = False,
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
    need = smem_bytes(1, gz, gy, temporal)
    if need > smem_limit:
        raise ValueError(
            f"bg_fused: one stripe of a {h}x{w} frame at r={cfg.r} (gy={gy}, "
            f"gz={gz}{', temporal' if temporal else ''}) needs {need} bytes of "
            f"shared memory per block, above the card's {smem_limit}; this "
            f"shape needs y tiling, which the kernel does not have yet"
        )
    fit = 1
    while fit < n and smem_bytes(fit + 1, gz, gy, temporal) <= smem_limit:
        fit += 1
    if band is None:
        band = min(_MAX_BAND, (b * n) // (_BLOCKS_PER_SM * num_sms))
    band = max(1, min(band, fit, n))
    return band, -(-n // band), smem_bytes(band, gz, gy, temporal)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.load(KERNEL)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bg_fused_launch.argtypes = [p] * 4 + [i] * 9 + [f] * 4 + [i, i, p]
    lib.bg_fused_launch.restype = i
    lib.bg_fused_temporal_launch.argtypes = [p] * 7 + [i] * 9 + [f] * 4 + [i, i, p]
    lib.bg_fused_temporal_launch.restype = i
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


def _launch(
    x: torch.Tensor,
    out: torch.Tensor,
    cfg: BGConfig,
    band=None,
    carry: Optional[torch.Tensor] = None,
    carry_out: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
) -> None:
    """One kernel launch over the contiguous (b, h, w) CUDA frames ``x``:
    B1, or B2 when ``carry`` is given (with ``carry_out`` and ``alpha``)."""
    b, h, w = x.shape
    dev = x.device
    temporal = carry is not None
    num_sms, smem_limit = _device_limits(dev.index)
    band, _, smem = launch_geometry(b, h, w, cfg, num_sms, smem_limit, band, temporal)
    gx, gy, gz = grid_shape(h, w, cfg)
    yf, xf = _ti_fracs(w, cfg.r, dev)
    t0, t1, t2 = (float(t) for t in taps_np(cfg))
    geometry = (
        b, h, w, cfg.r, gx, gy, gz, gc_row_split(cfg.r), band,
        float(np.float32(1.0 / cfg.range_scale)), t0, t1, t2,
        smem, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    lib = _lib()
    if temporal:
        err = lib.bg_fused_temporal_launch(
            x.data_ptr(), out.data_ptr(), carry.data_ptr(), carry_out.data_ptr(),
            alpha.data_ptr(), yf.data_ptr(), xf.data_ptr(), *geometry,
        )
    else:
        err = lib.bg_fused_launch(
            x.data_ptr(), out.data_ptr(), yf.data_ptr(), xf.data_ptr(), *geometry
        )
    if err != 0:
        msg = lib.bg_fused_error_string(err).decode()
        raise RuntimeError(f"bg_fused launch failed: CUDA error {err} ({msg})")
    if temporal:
        bg_fused.temporal_launches += 1
    else:
        bg_fused.launches += 1


def bg_fused(
    image: torch.Tensor,
    cfg: BGConfig,
    batch_tile: Optional[int] = None,
    carry: Optional[torch.Tensor] = None,
    alpha: Optional[torch.Tensor] = None,
):
    """Fused BG filter, (h, w) -> (h, w) or (b, h, w) -> (b, h, w), float32,
    unquantized, paper normalization.

    ``carry`` + ``alpha`` select the temporal path (the JAX package's
    ``bg_fused_impl(carry=, alpha=)``): ``carry`` is the ``(b, gx, gy, gz,
    2)`` float32 blurred-grid EMA state, one row per frame, ``alpha`` the
    ``(b,)`` float32 blend weights; the call then returns ``(out,
    new_carry)``, with ``new_carry`` a fresh tensor. An ``(h, w)`` frame
    takes a ``(gx, gy, gz, 2)`` carry and a one-element alpha and squeezes
    both results.

    CPU tensors run :func:`bg_fused_plain`; CUDA tensors run the kernel, one
    launch per ``batch_tile`` frames (``None``: all frames in one launch), on
    the current stream. ``bg_fused.launches`` counts per-frame launches and
    ``bg_fused.temporal_launches`` temporal ones.
    """
    _check_batch_tile(batch_tile)
    if cfg.normalize_mode != "paper":
        raise ValueError(
            f"bg_fused implements the paper normalization mode, got "
            f"{cfg.normalize_mode!r}"
        )
    x, carry_b, alpha_b = _operands(image, cfg, carry, alpha)
    if x.device.type == "cpu":
        return bg_fused_plain(image, cfg, batch_tile, carry, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"bg_fused runs on CUDA or CPU tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("bg_fused needs contiguous frames")
    b, h, w = x.shape
    if b > 65535 or h * w >= 2**31:
        raise ValueError(f"bg_fused: {b} frames of {h}x{w} exceed one launch")
    out = torch.empty_like(x)
    bt = b if batch_tile is None else batch_tile
    if carry_b is None:
        for i in range(0, b, bt):
            _launch(x[i:i + bt], out[i:i + bt], cfg)
        return out[0] if image.dim() == 2 else out
    for t, name in ((carry_b, "carry"), (alpha_b, "alpha")):
        if t.device != x.device:
            raise ValueError(f"bg_fused: {name} is on {t.device}, the frames on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"bg_fused needs a contiguous {name}")
    new_carry = torch.empty_like(carry_b)  # never aliased to the carry read
    for i in range(0, b, bt):
        s = slice(i, i + bt)
        _launch(x[s], out[s], cfg, carry=carry_b[s], carry_out=new_carry[s], alpha=alpha_b[s])
    return (out[0], new_carry[0]) if image.dim() == 2 else (out, new_carry)


bg_fused.launches = 0
bg_fused.temporal_launches = 0


def _operands(image, cfg: BGConfig, carry, alpha):
    """``(frames, carry, alpha)`` with a leading frame axis, checked as the
    JAX package's ``bg_fused_impl`` checks them; carry and alpha are
    ``None`` for a per-frame call."""
    x = _frames(image)
    if (carry is None) != (alpha is None):
        raise ValueError("temporal path needs both carry= and alpha= (or neither)")
    if carry is None:
        return x, None, None
    for t, name in ((carry, "carry"), (alpha, "alpha")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"bg_fused takes a torch.Tensor {name}, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"bg_fused takes a float32 {name}, got {t.dtype}")
    if image.dim() == 2:
        carry, alpha = carry[None], alpha.reshape(1)
    b, h, w = x.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    if tuple(carry.shape) != (b, gx, gy, gz, 2):
        raise ValueError(
            f"carry shape {tuple(carry.shape)} != {(b, gx, gy, gz, 2)} for "
            f"{(b, h, w)} frames"
        )
    if tuple(alpha.shape) != (b,):
        raise ValueError(f"alpha shape {tuple(alpha.shape)} != ({b},)")
    return x, carry, alpha


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
