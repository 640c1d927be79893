"""Plain reference of the variable-window bilateral grid under bf16 storage:
the eager float32 filter of ``bilateral_grid.py`` (GC -> GF -> N -> TI -> Q,
and the temporal EMA), rounded to bf16 where the program's bf16 contract
stores a value in bf16, and nowhere else.

The contract (the program's ``repro_torch/kernels/bg_fused.py``, module
docstring, items 1 to 7) rounds to nearest even, as
``t.to(torch.bfloat16).to(torch.float32)`` does here (``_bf16``):

  1. Frame: the frames are rounded to bf16 (8-bit frames are exact).
  2. Raw grid: GC sums each cell in float32 (whole numbers under 2**24, so
     exact in any order); the complete cell, count and sum, is rounded.
  3. Blur: GF blurs the rounded raw grid in float32.
  4. Temporal only (``TemporalReplay``): the blend reads the bf16 carry,
     each product and the sum rounded on its own in float32, and the new
     carry is the blend rounded to bf16.
  5. Normalize: float32, from the unrounded blurred (blended) grid; the
     normalized grid is rounded.
  6. TI reads the rounded normalized grid; its two z weights ``1 - zf`` and
     ``zf`` are each rounded; the x and y weights stay float32.
  7. Output: the interpolated value is rounded to bf16, then quantized
     (round half up, clip to [0, intensity_max]).

Departures from the program, each in float32 arithmetic only, none at a
rounding point: GF blurs along x, y, z (the program x, z, y); TI sums the
eight weighted corners (the program lerps along y, x, then z); the z
coordinate divides by the range scale (the program multiplies by its
float32 reciprocal; for whole 8-bit frames the two give the same bf16 z
weights at every radius of the configurations). The arithmetic holds no
matmul and no convolution, so TF32 settings do not reach it.

It imports only torch and numpy: nothing of the program under test. Every
quotient divides once in float32 by a 0-dim tensor (a Python divisor on a
CUDA tensor is multiplied by its reciprocal, which moves values at a bin
edge).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BG", "grid_shape", "blurred_grids", "slice_quantized", "filter_frames",
           "TemporalReplay"]


class BG:
    """The configuration's numbers, read from its JSON file."""

    def __init__(self, cfg: dict):
        self.r = int(cfg["r"])
        self.sigma_s = float(cfg["sigma_s"])
        self.sigma_r = float(cfg["sigma_r"])
        self.intensity_max = float(cfg["intensity_max"])
        if cfg.get("normalize_mode", "paper") != "paper" or cfg.get("weight_mode", "float") != "float":
            raise ValueError("the reference covers normalize_mode 'paper' and weight_mode 'float'")
        if cfg.get("precision", "bf16") != "bf16":
            raise ValueError("this reference is the bf16 storage form")

    @property
    def range_scale(self) -> float:
        return self.r * self.sigma_r / self.sigma_s

    def taps(self):
        sigma_g = self.sigma_s / self.r
        e = np.asarray([np.exp(-1.0 / (2.0 * sigma_g ** 2))], np.float32)[0]
        return float(e), 1.0, float(e)


def grid_shape(h: int, w: int, bg: BG):
    return (h // bg.r + 2, w // bg.r + 2, int(np.floor(bg.intensity_max / bg.range_scale)) + 2)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and held as float32 again."""
    return t.to(torch.bfloat16).to(torch.float32)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def _rhu(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v + 0.5)


def _conv3(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    lo = torch.roll(x, 1, dims=axis)
    hi = torch.roll(x, -1, dims=axis)
    lo.select(axis, 0).zero_()
    hi.select(axis, -1).zero_()
    return taps[0] * lo + taps[1] * x + taps[2] * hi


def blurred_grids(frames: torch.Tensor, bg: BG) -> torch.Tensor:
    """(n, h, w) frames in [0, intensity_max] -> (n, gx, gy, gz, 2) blurred
    homogeneous grids (channel 0 the count, 1 the sum), float32, from the
    rounded frames (item 1) and the rounded raw grid (items 2 and 3)."""
    frames = _bf16(frames.to(torch.float32))
    n, h, w = frames.shape
    gx, gy, gz = grid_shape(h, w, bg)
    dev = frames.device
    xg = _rhu(_div(torch.arange(h, dtype=torch.float32, device=dev), bg.r)).long()
    yg = _rhu(_div(torch.arange(w, dtype=torch.float32, device=dev), bg.r)).long()
    zg = _rhu(_div(frames, bg.range_scale)).long().clamp(0, gz - 1)
    bi = torch.arange(n, device=dev)[:, None, None]
    cell = ((bi * gx + xg[None, :, None]) * gy + yg[None, None, :]) * gz + zg
    vals = torch.stack([torch.ones_like(frames), frames], dim=-1)
    grid = torch.zeros((n * gx * gy * gz, 2), dtype=torch.float32, device=dev)
    grid.index_add_(0, cell.reshape(-1), vals.reshape(-1, 2))
    grid = _bf16(grid.reshape(n, gx, gy, gz, 2))
    taps = bg.taps()
    for axis in (1, 2, 3):
        grid = _conv3(grid, taps, axis)
    return grid


def slice_quantized(blurred: torch.Tensor, frames: torch.Tensor, bg: BG) -> torch.Tensor:
    """Normalize (eq. 4; item 5), interpolate (eq. 5; item 6) and quantize
    (item 7): (n, h, w)."""
    count, summ = blurred[..., 0], blurred[..., 1]
    grid_f = torch.where(count > 1e-12, summ / torch.clamp(count, min=1e-12), torch.zeros_like(summ))
    grid_f = _bf16(grid_f)
    frames = _bf16(frames.to(torch.float32))
    n, h, w = frames.shape
    _, gx, gy, gz = grid_f.shape
    dev = frames.device
    fx = _div(torch.arange(h, dtype=torch.float32, device=dev), bg.r)
    fy = _div(torch.arange(w, dtype=torch.float32, device=dev), bg.r)
    fz = _div(frames, bg.range_scale)
    x0, y0, z0 = torch.floor(fx).long(), torch.floor(fy).long(), torch.floor(fz).long()
    xf = (fx - x0)[None, :, None]
    yf = (fy - y0)[None, None, :]
    zf = fz - z0
    flat = grid_f.reshape(-1)
    base_b = torch.arange(n, device=dev)[:, None, None] * gx
    out = torch.zeros((n, h, w), dtype=torch.float32, device=dev)
    for di, wxi in ((0, 1.0 - xf), (1, xf)):
        xi = (x0 + di).clamp(0, gx - 1)[None, :, None]
        for dj, wyj in ((0, 1.0 - yf), (1, yf)):
            yj = (y0 + dj).clamp(0, gy - 1)[None, None, :]
            for dk, wzk in ((0, _bf16(1.0 - zf)), (1, _bf16(zf))):
                zk = (z0 + dk).clamp(0, gz - 1)
                corner = flat[((base_b + xi) * gy + yj) * gz + zk]
                out = out + wxi * wyj * wzk * corner
    return torch.clamp(_rhu(_bf16(out)), 0.0, bg.intensity_max)


def filter_frames(frames: torch.Tensor, bg: BG) -> torch.Tensor:
    """The per-frame filter, quantized: (n, h, w) -> (n, h, w)."""
    return slice_quantized(blurred_grids(frames, bg), frames, bg)


class TemporalReplay:
    """Replays streams from their first frame: ``step(frames)`` takes the
    next (n, h, w) frame of each of n streams and returns their quantized
    outputs, carrying each stream's blended grid in bf16 (item 4; ``G_0 =
    B_0``). With ``quantize=False`` it only advances the carries and returns
    ``None``."""

    def __init__(self, bg: BG, alpha: float):
        self.bg = bg
        self.alpha = float(np.float32(alpha))
        self.carry = None  # bf16 values, held as float32

    def step(self, frames: torch.Tensor, quantize: bool = True):
        blend = blurred_grids(frames, self.bg)
        if self.carry is not None:
            a = torch.tensor(self.alpha, dtype=torch.float32, device=blend.device)
            blend = (1.0 - a) * blend + a * self.carry
        self.carry = _bf16(blend)
        if not quantize:
            return None
        return slice_quantized(blend, frames, self.bg)
