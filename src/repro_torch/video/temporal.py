"""Temporal bilateral grid: a recursive EMA of the blurred grid per stream.

The port of ``repro/video/temporal.py``. Each frame's grid is built from
that frame's noise, so flat regions of a static scene shimmer at the
grid-cell scale. Carrying the blurred homogeneous grid (the (count, sum)
pair after GF) across frames and blending it before the slice fixes that:

    B_t = blur(create(f_t))                 # per-frame GC + GF
    G_t = (1 - a) * B_t + a * G_{t-1}       # temporal EMA, on the grid
    out = slice(normalize(G_t), f_t)        # TI against the blended grid

Every alpha rides the fused kernel: ``BGPlan(temporal=True,
backend="fused")`` is the CUDA kernel B2, which blends each blurred plane in
shared memory right before TI reads it, one launch per pack. An ``a == 0``
frame's blend is the exact float identity, so its output equals the
per-frame kernel's bit for bit. A pack with no carry and every alpha 0 goes
to the per-frame plan and materializes nothing temporal. The
``"reference"`` backend is the staged oracle (``blurred_grid_batch`` ->
blend -> normalize -> slice) that the kernel is held to. A bf16 plan keeps
every carry in ``torch.bfloat16`` (``BGPlan.storage_dtype``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bilateral_grid import (
    BGConfig,
    _round_half_up,
    _divide,
    _wrap_negative,
    conv3_axis,
    gaussian_taps,
    grid_shape,
)
from repro_torch.kernels.common import round_storage

__all__ = ["blurred_grid_batch", "carry_shape", "temporal_denoise"]


def carry_shape(h: int, w: int, cfg: BGConfig) -> Tuple[int, int, int, int]:
    """Shape of one stream's temporal carry: the blurred homogeneous grid
    ``(gx, gy, gz, 2)`` (channel 0 = blurred count, 1 = blurred sum)."""
    gx, gy, gz = grid_shape(h, w, cfg)
    return (gx, gy, gz, 2)


def blurred_grid_batch(frames: torch.Tensor, cfg: BGConfig, precision: str = "fp32") -> torch.Tensor:
    """(n, h, w) frames -> (n, gx, gy, gz, 2) blurred homogeneous grids, on
    the frames' device.

    One ``B_t = blur(create(f_t))`` per frame, the quantity the temporal
    EMA is defined over, as one batched scatter and batched convolutions:
    the spatial cell indices and the taps are built once for the batch.
    Equal to stacking ``grid_blur(grid_create(f))`` per frame.

    ``precision="bf16"`` is the staged oracle's precision axis (JAX
    ``repro/video/temporal.py::blurred_grid_batch``): the frames are rounded
    to bf16 before binning, the scatter and the blur accumulate in fp32, and
    the grid is returned as ``torch.bfloat16``. ``"fp32"`` is unchanged.
    """
    frames = round_storage(frames.to(torch.float32), precision)
    n, h, w = frames.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    dev = frames.device
    xg = _round_half_up(_divide(torch.arange(h, dtype=torch.float32, device=dev), cfg.r)).long()
    yg = _round_half_up(_divide(torch.arange(w, dtype=torch.float32, device=dev), cfg.r)).long()
    # a negative bin counts as bin + gz, and a pixel whose bin is still
    # outside [0, gz) is dropped, as in grid_create
    zg = _wrap_negative(_round_half_up(_divide(frames, cfg.range_scale)).long(), gz)
    inside = ((zg >= 0) & (zg < gz)).to(torch.float32)
    bi = torch.arange(n, device=dev)[:, None, None].expand(n, h, w)
    vals = torch.stack([inside, frames * inside], dim=-1)
    grid = torch.zeros((n, gx, gy, gz, 2), dtype=torch.float32, device=dev)
    grid.index_put_(
        (bi, xg[None, :, None].expand(n, h, w), yg[None, None, :].expand(n, h, w),
         zg.clamp(0, gz - 1)),
        vals,
        accumulate=True,
    )
    taps = tuple(float(t) for t in gaussian_taps(cfg))
    for axis in (1, 2, 3):  # batched layout (n, gx, gy, gz, 2): x, y, z
        grid = conv3_axis(grid, taps, axis)
    return grid.to(torch.bfloat16) if precision == "bf16" else grid


@functools.lru_cache(maxsize=64)
def _legacy_plan(cfg: BGConfig, quantize_output: bool, device, mesh):
    """The fused plan the keyword form names, cached (``temporal_denoise``
    sits on a per-pack path); ``mesh`` as the JAX package's ``_legacy_plan``
    takes it (``None``: every card when the caller wants the card and more
    than one is visible)."""
    from repro_torch.plan import BGPlan
    from repro_torch.sharding.bg_shard import _service_mesh

    return BGPlan(cfg=cfg, backend="fused", quantize_output=quantize_output, device=device,
                  mesh=_service_mesh(mesh, device))


def temporal_denoise(
    frames,
    cfg: Optional[BGConfig] = None,
    carry: Optional[torch.Tensor] = None,
    alpha=0.0,
    *,
    quantize_output: bool = True,
    plan=None,
    device=None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One temporal step for a pack of streams: denoise and advance the carry.

    Args:
      frames: ``(n, h, w)``, one frame from each of n streams, or a single
        ``(h, w)`` frame (n == 1); numpy or tensor.
      carry: ``None`` when no stream has temporal history, else the stacked
        ``(n, gx, gy, gz, 2)`` blurred-grid carries. Streams without history
        inside a warm pack pass a zero carry row and a zero alpha entry.
      alpha: scalar or length-n host-side blend weights in ``[0, 1)``.
      plan: a base :class:`repro_torch.plan.BGPlan` that fixes the dispatch
        (backend, batch tile, quantization, device, mesh); its temporal or
        per-frame variant is derived here per pack. Without it, ``cfg``
        (with ``quantize_output``, ``device`` and ``mesh``) names the fused
        plan; with a mesh the stream axis is split over it.

    Returns ``(out, new_carry)``. With no carry and every alpha zero the
    per-frame plan runs and ``new_carry`` is ``None``. Otherwise the
    temporal plan runs (``a == 0`` rows still equal the per-frame output
    bit for bit on the fused backend).
    """
    if plan is None:
        if cfg is None:
            raise TypeError("temporal_denoise needs cfg= or plan=")
        plan = _legacy_plan(cfg, quantize_output, device, mesh)
    elif device is not None or mesh is not None:
        raise ValueError("pass device= and mesh= with cfg=; a plan carries its own device and mesh")
    frames = torch.as_tensor(frames, dtype=torch.float32, device=plan.input_device)
    squeeze = frames.dim() == 2
    if squeeze:
        frames = frames[None]
    if frames.dim() != 3:
        raise ValueError(f"expected (h, w) or (n, h, w) frames, got {tuple(frames.shape)}")
    n = frames.shape[0]
    alpha_np = np.broadcast_to(np.asarray(alpha, np.float32), (n,))
    if np.any(alpha_np < 0.0) or np.any(alpha_np >= 1.0):
        raise ValueError(f"temporal alpha must be in [0, 1), got {alpha}")

    if carry is None and not alpha_np.any() and plan.backend != "reference":
        out = plan.as_temporal(False)(frames)
        return (out[0] if squeeze else out), None

    if carry is None:
        # warm-up pack of a temporal stream set: no history yet, so every
        # effective alpha is 0 this step, but the carry must be produced
        carry = torch.zeros(
            (n,) + carry_shape(*frames.shape[1:], plan.cfg),
            dtype=plan.storage_dtype, device=plan.device,
        )
        alpha_np = np.zeros((n,), np.float32)
    if carry.shape[0] != n:
        raise ValueError(f"carry leading axis {carry.shape[0]} != n frames {n}")
    alpha_t = torch.as_tensor(alpha_np.copy(), device=plan.input_device)  # checked above
    out, new_carry = plan.as_temporal(True)(frames, carry=carry, alpha=alpha_t)
    return (out[0] if squeeze else out), new_carry
