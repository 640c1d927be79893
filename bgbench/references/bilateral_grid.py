"""Plain reference of the variable-window bilateral grid and its temporal
EMA: whole-image GC -> GF -> TI in eager float32 PyTorch, batched over a
leading frame axis.

This is the benchmark's yardstick for `correct`. It follows the paper
(Hashimoto and Takamaeda-Yamazaki 2021, Algorithm 1, eqs. 3 to 5):

  GC  grid[round(ix/r), round(iy/r), round(f/(r*sigma_r/sigma_s))] += (1, f)
  GF  separable 3-tap Gaussian [e, 1, e], e = exp(-1/(2 (sigma_s/r)^2)),
      along x, y and z, zero outside the grid
  N   grid_f = blurred_sum / blurred_count, 0 where the count is 0 (eq. 4)
  TI  trilinear interpolation of grid_f at (ix/r, iy/r, f/rs)       (eq. 5)
  Q   round half up, clip to [0, intensity_max]

and, for video, the EMA of the blurred homogeneous grid per stream:
G_t = (1 - a) * B_t + a * G_{t-1}, with G_0 = B_0, sliced against f_t.

Frames hold whole 8-bit values, so every cell's count and sum is a whole
number far below 2**24 and the scatter's float32 sums are exact in any
order. It imports only torch and numpy: nothing of the program under test. Every
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

    @property
    def range_scale(self) -> float:
        return self.r * self.sigma_r / self.sigma_s

    def taps(self):
        sigma_g = self.sigma_s / self.r
        e = np.asarray([np.exp(-1.0 / (2.0 * sigma_g ** 2))], np.float32)[0]
        return float(e), 1.0, float(e)


def grid_shape(h: int, w: int, bg: BG):
    return (h // bg.r + 2, w // bg.r + 2, int(np.floor(bg.intensity_max / bg.range_scale)) + 2)


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
    homogeneous grids (channel 0 the count, 1 the sum)."""
    frames = frames.to(torch.float32)
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
    grid = grid.reshape(n, gx, gy, gz, 2)
    taps = bg.taps()
    for axis in (1, 2, 3):
        grid = _conv3(grid, taps, axis)
    return grid


def slice_quantized(blurred: torch.Tensor, frames: torch.Tensor, bg: BG) -> torch.Tensor:
    """Normalize (eq. 4), interpolate (eq. 5) and quantize: (n, h, w)."""
    count, summ = blurred[..., 0], blurred[..., 1]
    grid_f = torch.where(count > 1e-12, summ / torch.clamp(count, min=1e-12), torch.zeros_like(summ))
    frames = frames.to(torch.float32)
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
            for dk, wzk in ((0, 1.0 - zf), (1, zf)):
                zk = (z0 + dk).clamp(0, gz - 1)
                corner = flat[((base_b + xi) * gy + yj) * gz + zk]
                out = out + wxi * wyj * wzk * corner
    return torch.clamp(_rhu(out), 0.0, bg.intensity_max)


def filter_frames(frames: torch.Tensor, bg: BG) -> torch.Tensor:
    """The per-frame filter, quantized: (n, h, w) -> (n, h, w)."""
    return slice_quantized(blurred_grids(frames, bg), frames, bg)


class TemporalReplay:
    """Replays streams from their first frame: ``step(frames)`` takes the
    next (n, h, w) frame of each of n streams and returns their quantized
    outputs, carrying each stream's blended grid (``G_0 = B_0``). With
    ``quantize=False`` it only advances the carries and returns ``None``."""

    def __init__(self, bg: BG, alpha: float):
        self.bg = bg
        self.alpha = float(np.float32(alpha))
        self.carry = None

    def step(self, frames: torch.Tensor, quantize: bool = True):
        b = blurred_grids(frames, self.bg)
        if self.carry is None:
            self.carry = b
        else:
            a = torch.tensor(self.alpha, dtype=torch.float32, device=b.device)
            self.carry = (1.0 - a) * b + a * self.carry
        if not quantize:
            return None
        return slice_quantized(self.carry, frames, self.bg)
