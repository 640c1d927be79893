"""Bilateral grid with a variable-sized window (Hashimoto & Takamaeda-Yamazaki, 2021),
whole-image, in PyTorch.

The grid is re-derived so that the bilateral-filter window radius ``r`` lives
on the *input image*:

    fv(i) = (ix / r,  iy / r,  f(i) / (r * sigma_r / sigma_s))

and the grid-space blur is always a 3x3x3 Gaussian with ``sigma_g = sigma_s/r``.
The pipeline is three stages, as in the paper's Algorithm 1:

  GC  (grid creation)          grid[round(fv(i))] += (1, f(i))
  GF  (3^3 Gaussian filter)    grid_f = blur(grid);  normalized per cell (eq. 4)
  TI  (trilinear interpolation) out(i) = trilerp(grid_f, fv(i))        (eq. 5)

Two normalization orders are supported:
  * ``"paper"``   — eq. (4)/Algorithm 1: divide blurred sum by blurred count per
                    grid cell (0 where empty), then interpolate the scalar grid.
  * ``"classic"`` — eq. (2)/Chen et al.: interpolate the homogeneous
                    (sum, count) pair and divide at the slice point.

All images are float32 intensities in [0, intensity_max] of shape (h, w), on
whatever device the caller put them; every function here is plain eager
PyTorch and keeps its result on the input's device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BGConfig",
    "conv3_axis",
    "gaussian_taps",
    "grid_shape",
    "grid_create",
    "grid_blur",
    "grid_normalize",
    "grid_slice",
    "grid_slice_homogeneous",
    "bilateral_grid_filter",
    "quantize_intensity",
]


def _round_half_up(v: torch.Tensor) -> torch.Tensor:
    """Deterministic round-half-up, used for every [.] in the paper."""
    return torch.floor(v + 0.5)


def _wrap_negative(idx: torch.Tensor, size: int) -> torch.Tensor:
    """A negative index plus ``size``, as jnp indexing normalizes it before
    a scatter drops, or a gather clamps, what is still out of range."""
    return torch.where(idx < 0, idx + size, idx)


def quantize_intensity(out: torch.Tensor, cfg: "BGConfig") -> torch.Tensor:
    """The paper's output quantization: round-half-up, clip to the intensity
    range. Every pipeline exit of the port goes through this function."""
    return torch.clamp(_round_half_up(out), 0.0, cfg.intensity_max)


@dataclasses.dataclass(frozen=True)
class BGConfig:
    """Static configuration of the variable-window bilateral grid.

    Attributes:
      r:         window radius on the *input image* (the paper's key parameter).
      sigma_s:   spatial Gaussian std-dev, in input-image pixels.
      sigma_r:   range Gaussian std-dev, in intensity units.
      intensity_max: top of the intensity range (255 for 8-bit).
      normalize_mode: "paper" (eq. 4, per-cell after GF) or "classic" (eq. 2).
      weight_mode: "float" exact Gaussian taps, or "pow2" taps quantized to
          powers of two (the paper's shift-only arithmetic, Figs. 7-8).
    """

    r: int
    sigma_s: float
    sigma_r: float
    intensity_max: float = 255.0
    normalize_mode: str = "paper"
    weight_mode: str = "float"

    def __post_init__(self):
        if self.r < 1:
            raise ValueError(f"window radius must be >= 1, got {self.r}")
        if self.sigma_s <= 0 or self.sigma_r <= 0:
            raise ValueError("sigma_s and sigma_r must be positive")
        if self.normalize_mode not in ("paper", "classic"):
            raise ValueError(f"bad normalize_mode {self.normalize_mode!r}")
        if self.weight_mode not in ("float", "pow2"):
            raise ValueError(f"bad weight_mode {self.weight_mode!r}")

    @property
    def range_scale(self) -> float:
        """Divisor of the intensity axis: r * sigma_r / sigma_s."""
        return self.r * self.sigma_r / self.sigma_s

    @property
    def sigma_g(self) -> float:
        """Grid-space Gaussian std-dev (isotropic after rescaling)."""
        return self.sigma_s / self.r

    @property
    def gz(self) -> int:
        return int(np.floor(self.intensity_max / self.range_scale)) + 2


def grid_shape(h: int, w: int, cfg: BGConfig) -> Tuple[int, int, int]:
    """(gx, gy, gz) per the paper: (floor(h/r)+2, floor(w/r)+2, floor(I/rs)+2).

    The paper indexes x by image *rows* (height) and y by columns.
    """
    return (h // cfg.r + 2, w // cfg.r + 2, cfg.gz)


def _taps(cfg: BGConfig) -> Tuple[float, float, float]:
    e = float(np.exp(-1.0 / (2.0 * cfg.sigma_g**2)))
    if cfg.weight_mode == "pow2":
        # 2^round(log2(e)); underflow to the smallest shift maps to zero
        e = 0.0 if e <= 2.0**-30 else float(2.0 ** np.round(np.log2(e)))
    # round through float32 so every caller multiplies by the same values
    t = np.asarray([e, 1.0, e], dtype=np.float32)
    return float(t[0]), float(t[1]), float(t[2])


def gaussian_taps(cfg: BGConfig) -> torch.Tensor:
    """1-D taps [e, 1, e] with e = exp(-1/(2 sigma_g^2)), float32 on the CPU.

    The 27 3-D weights are the separable outer product of these taps; in
    ``pow2`` mode each tap is quantized to the nearest power of two.
    """
    return torch.tensor(_taps(cfg), dtype=torch.float32)


# --------------------------------------------------------------------------
# GC — grid creation
# --------------------------------------------------------------------------

def feature_coords(h: int, w: int, image: torch.Tensor, cfg: BGConfig):
    """fv(i) components: (ix/r, iy/r, f(i)/range_scale). Shapes (h,), (w,), (h,w)."""
    dev = image.device
    fx = torch.arange(h, dtype=torch.float32, device=dev) / cfg.r
    fy = torch.arange(w, dtype=torch.float32, device=dev) / cfg.r
    fz = image.to(torch.float32) / cfg.range_scale
    return fx, fy, fz


def grid_create(image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """GC: scatter each pixel's (1, f) into grid[round(fv)].

    Returns a float32 grid of shape (gx, gy, gz, 2): channel 0 = pixel count,
    channel 1 = intensity sum. The scatter is ``index_put_`` with
    ``accumulate=True``, which sums each cell in a fixed order. For input
    outside [0, intensity_max] the bin index is JAX's: a negative bin z
    counts as z + gz (-1 is the top bin), and a pixel whose bin is still
    outside [0, gz) is dropped, as JAX's scatter drops it.
    """
    h, w = image.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    image = image.to(torch.float32)
    fx, fy, fz = feature_coords(h, w, image, cfg)
    xg = _round_half_up(fx).long()
    yg = _round_half_up(fy).long()
    zg = _wrap_negative(_round_half_up(fz).long(), gz)
    inside = ((zg >= 0) & (zg < gz)).to(torch.float32)
    zg = zg.clamp(0, gz - 1)
    x_idx = xg[:, None].expand(h, w)
    y_idx = yg[None, :].expand(h, w)
    vals = torch.stack([inside, image * inside], dim=-1)
    grid = torch.zeros((gx, gy, gz, 2), dtype=torch.float32, device=image.device)
    return grid.index_put_((x_idx, y_idx, zg), vals, accumulate=True)


# --------------------------------------------------------------------------
# GF — 3x3x3 Gaussian filter on the grid
# --------------------------------------------------------------------------

def conv3_axis(x: torch.Tensor, taps: Sequence[float], axis: int) -> torch.Tensor:
    """Width-3 conv along ``axis`` with zero boundary (the paper's implicit
    border). Layout-agnostic: the caller's comment names which grid axis
    ``axis`` is."""
    lo = torch.roll(x, 1, dims=axis)
    hi = torch.roll(x, -1, dims=axis)
    lo.select(axis, 0).zero_()
    hi.select(axis, -1).zero_()
    return taps[0] * lo + taps[1] * x + taps[2] * hi


def grid_blur(grid: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """GF numerator and denominator together: separable 3-tap blur on both
    channels (exact, since the 27 weights are an outer product)."""
    taps = _taps(cfg)
    out = grid.to(torch.float32)
    for axis in range(3):  # grid layout (gx, gy, gz, 2): axes 0/1/2 = x/y/z
        out = conv3_axis(out, taps, axis)
    return out


def grid_normalize(blurred: torch.Tensor) -> torch.Tensor:
    """Eq. (4): grid_f = blurred_sum / blurred_count, 0 where count == 0."""
    count = blurred[..., 0]
    summ = blurred[..., 1]
    return torch.where(
        count > 1e-12, summ / torch.clamp(count, min=1e-12), torch.zeros_like(summ)
    )


# --------------------------------------------------------------------------
# TI — trilinear interpolation (slice)
# --------------------------------------------------------------------------

def grid_slice(grid_f: torch.Tensor, image: torch.Tensor, cfg: BGConfig) -> torch.Tensor:
    """TI of a scalar grid at fv(i) for every pixel i. Returns float32 (h, w).

    ``image`` is the original input (its intensities give the z coordinate).
    Corner weights are the standard trilinear (1-frac, frac) pair. Corner
    indices are JAX's: a negative z corner counts as z + gz, then every
    corner is clamped to the grid, as JAX's gather clamps it (only z can be
    negative, for input below 0).
    """
    h, w = image.shape
    fx, fy, fz = feature_coords(h, w, image, cfg)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    z0 = torch.floor(fz).long()
    xf = (fx - x0)[:, None]
    yf = (fy - y0)[None, :]
    zf = fz - z0
    x0b = x0[:, None].expand(h, w)
    y0b = y0[None, :].expand(h, w)
    grid_f = grid_f.to(torch.float32)
    gx, gy, gz = grid_f.shape
    out = torch.zeros((h, w), dtype=torch.float32, device=image.device)
    for di, wxi in ((0, 1.0 - xf), (1, xf)):
        for dj, wyj in ((0, 1.0 - yf), (1, yf)):
            for dk, wzk in ((0, 1.0 - zf), (1, zf)):
                corner = grid_f[
                    (x0b + di).clamp(0, gx - 1),
                    (y0b + dj).clamp(0, gy - 1),
                    _wrap_negative(z0 + dk, gz).clamp(0, gz - 1),
                ]
                out = out + wxi * wyj * wzk * corner
    return out


def grid_slice_homogeneous(
    blurred: torch.Tensor, image: torch.Tensor, cfg: BGConfig
) -> torch.Tensor:
    """Classic-BG slice (eq. 2): interpolate (sum, count), divide at the point."""
    num = grid_slice(blurred[..., 1], image, cfg)
    den = grid_slice(blurred[..., 0], image, cfg)
    return torch.where(
        den > 1e-12, num / torch.clamp(den, min=1e-12), torch.zeros_like(num)
    )


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def bilateral_grid_filter(
    image: torch.Tensor, cfg: BGConfig, quantize_output: bool = True
) -> torch.Tensor:
    """GC -> GF -> TI. Input float32 (h, w) in [0, intensity_max].

    ``quantize_output=True`` rounds to integers and clips to the intensity
    range (the paper's output is 8-bit); False returns the raw float surface.
    """
    image = image.to(torch.float32)
    blurred = grid_blur(grid_create(image, cfg), cfg)
    if cfg.normalize_mode == "paper":
        out = grid_slice(grid_normalize(blurred), image, cfg)
    else:
        out = grid_slice_homogeneous(blurred, image, cfg)
    if quantize_output:
        out = quantize_intensity(out, cfg)
    return out
