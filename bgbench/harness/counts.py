"""The yardstick's counts and peaks: what one frame's filter step has to
move and compute, from the configuration's shapes alone.

A frozen copy of the program's ``plan.py::fused_work``: each input read once
and each output written once, whatever a kernel reads again. Per frame of
``h x w`` fp32 pixels the step reads the frame and writes the filtered
frame (8 bytes a pixel) and reads the TI fractions, ``(w + r) * 4`` bytes;
the temporal step also reads and writes the carry (two channels, 4 bytes
each, every grid cell) and reads its alpha. Operations: 32 a pixel (5 in
GC, 27 in TI) and 33 a grid cell (GF and normalization), plus 6 a cell for
the temporal blend. The bound is the larger of bytes over the HBM rate and
operations over the fp32 rate of one H100 SXM (data sheet).
"""
from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "grid_shape", "fused_work", "frame_bound_s"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, 80 GB HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores


def grid_shape(h: int, w: int, cfg: dict):
    r = int(cfg["r"])
    range_scale = r * float(cfg["sigma_r"]) / float(cfg["sigma_s"])
    return (h // r + 2, w // r + 2, int(math.floor(float(cfg["intensity_max"]) / range_scale)) + 2)


def fused_work(b: int, h: int, w: int, cfg: dict, esize: int = 4, temporal: bool = False):
    """(bytes, operations) of the fused filter step on ``b`` frames."""
    gx, gy, gz = grid_shape(h, w, cfg)
    cells = gx * gy * gz
    nbytes = b * h * w * esize * 2 + (w + int(cfg["r"])) * 4
    flops = b * (32 * h * w + 33 * cells)
    if temporal:
        nbytes += b * (2 * cells * 2 * esize + 4)
        flops += b * 6 * cells
    return nbytes, flops


def frame_bound_s(cfg: dict, temporal: bool) -> float:
    """The least time one frame's step could take on the card."""
    nbytes, flops = fused_work(1, int(cfg["height"]), int(cfg["width"]), cfg, temporal=temporal)
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
