"""Shift-only / integer arithmetic mode, the paper's Figs. 7-8, in int32
PyTorch, equal to the JAX package's ``repro/core/fixed_point.py`` bit for bit.

The FPGA removes all floating point by (a) quantizing every Gaussian tap to a
power of two (multiplication = shift) and (b) keeping the grid in integer
(count, sum) pairs. The same datapath in int32:

  GC   integer (count, sum) accumulation (exact, so independent of order:
       the card gives the CPU's bits).
  GF   separable width-3 convolution where each tap is 2^-k: ``x << F``
       then ``x + ((lo + hi) >> k)`` per axis, at F fractional bits. The
       common 2^F scale cancels in the normalization ratio.
  norm two-step integer division producing the cell value at Q=8 fractional
       bits (quotient + remainder refinement, as a divider pipeline would).
  TI   three cascaded integer lerps (z, then y, then x) with Q=8 coefficient
       LUTs (the paper's L1/L2/L3), rescaling >> 8 after each stage so every
       intermediate fits 32 bits.

Index rules are JAX's: torch raises on an out-of-range gather where JAX
clamps, so every gather here wraps a negative index once (as jnp indexing
normalizes it) and then clamps. That covers inputs outside [0,
``intensity_max``] (the LUT gathers) and the top z bin (``z0 + 1`` in TI).
``.to(torch.int32)`` truncates toward zero as ``astype(jnp.int32)`` does;
``>>`` on int32 is arithmetic and ``//`` floors in both.

Bounds: with F=8 fractional GF bits, values fit int32 for r <= 31 (the paper
uses r <= 16); larger radii raise ``ValueError``, as in JAX.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bilateral_grid import BGConfig, _wrap_negative, grid_shape

__all__ = [
    "pow2_shift",
    "intensity_luts",
    "bilateral_grid_filter_fixed",
]

_F = 8  # GF fixed-point fractional bits
_Q = 8  # interpolation-coefficient fractional bits


def pow2_shift(cfg: BGConfig) -> int:
    """Shift k for the off-center tap: e = exp(-1/(2 sigma_g^2)) ~ 2^-k.

    Returns k >= 0; k > 30 means the tap underflows to zero (no neighbor
    contribution, sigma_g tiny)."""
    e = float(np.exp(-1.0 / (2.0 * cfg.sigma_g**2)))
    if e <= 2.0**-30:
        return 31
    return int(np.clip(np.round(-np.log2(e)), 0, 31))


def intensity_luts(cfg: BGConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The paper's L1 LUT: intensity l -> (z bin, z fraction at Q bits), int32
    numpy arrays of ``intensity_max + 1`` entries.

    GC uses round(l/rs) (derived as z0 + (zf >= 0.5)); TI uses (z0, zf).
    """
    levels = np.arange(int(cfg.intensity_max) + 1, dtype=np.float64)
    fz = levels / cfg.range_scale
    z0 = np.floor(fz).astype(np.int32)
    zf = np.round((fz - z0) * (1 << _Q)).astype(np.int32)
    # keep zf in [0, 2^Q - 1] so the lerp never indexes past z0+1
    carry = zf >> _Q
    z0 = z0 + carry
    zf = zf - (carry << _Q)
    return z0, zf


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with JAX's gather rule: a negative index wraps once,
    then the index clamps to the table."""
    n = table.shape[0]
    return table[_wrap_negative(idx, n).clamp(0, n - 1)]


def _conv3_shift_axis(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """Integer width-3 conv with taps (2^-k, 1, 2^-k) at F fractional bits.

    Input is at F fractional bits already; neighbors contribute x >> k
    (exact when k <= F, which holds for every practical sigma_g)."""
    if k >= 31:
        return x
    lo = torch.roll(x, 1, dims=axis)
    hi = torch.roll(x, -1, dims=axis)
    lo.select(axis, 0).zero_()
    hi.select(axis, -1).zero_()
    return x + ((lo + hi) >> k)


def _div_q8(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """floor(num/den * 2^Q) without overflowing int32 (two-step division)."""
    den_safe = torch.clamp(den, min=1)
    q = num // den_safe
    rem = num - q * den_safe
    frac = (rem << _Q) // den_safe
    out = (q << _Q) + frac
    return torch.where(den > 0, out, torch.zeros_like(out))


def _lerp_q8(a: torch.Tensor, b: torch.Tensor, f_q8: torch.Tensor) -> torch.Tensor:
    """((1-f) a + f b) with f at Q=8 bits; result rescaled back (>> Q)."""
    return (a * ((1 << _Q) - f_q8) + b * f_q8) >> _Q


def bilateral_grid_filter_fixed(image, cfg: BGConfig, *, device=None) -> torch.Tensor:
    """Integer/shift-only BG pipeline on one integer-valued (h, w) frame in
    [0, 255], on the CUDA card unless ``device="cpu"``.

    Returns a float32 image (integer-valued), like the quantized float path.
    """
    if cfg.r > 31:
        raise ValueError("fixed-point mode supports r <= 31 (int32 bounds)")
    image = torch.as_tensor(image, dtype=torch.float32, device=resolve_device(device))
    if image.dim() != 2:
        raise ValueError(f"expected one (h, w) frame, got {tuple(image.shape)}")
    dev = image.device
    image_i = image.to(torch.int32)  # truncates toward zero, as astype
    h, w = image.shape
    gx, gy, gz = grid_shape(h, w, cfg)
    k = pow2_shift(cfg)
    z0_np, zf_np = intensity_luts(cfg)
    z0_lut = torch.from_numpy(z0_np).to(dev)
    zf_lut = torch.from_numpy(zf_np).to(dev)
    r = cfg.r

    # ---- GC (exact integer) ----
    ix = torch.arange(h, dtype=torch.int32, device=dev)
    iy = torch.arange(w, dtype=torch.int32, device=dev)
    # round(i/r) = (2i + r) // (2r) for integers: the counter logic of Alg. 1
    xg = (2 * ix + r) // (2 * r)
    yg = (2 * iy + r) // (2 * r)
    z0 = _take(z0_lut, image_i)
    zf = _take(zf_lut, image_i)
    z_q = z0 + (zf >> (_Q - 1))  # round(fz)
    vals = torch.stack([torch.ones_like(image_i), image_i], dim=-1)
    grid = torch.zeros((gx, gy, gz, 2), dtype=torch.int32, device=dev)
    grid.index_put_(
        (xg.long()[:, None].expand(h, w), yg.long()[None, :].expand(h, w), z_q.long()),
        vals, accumulate=True,
    )

    # ---- GF (shift-only, F fractional bits) ----
    g = grid << _F
    for axis in range(3):
        g = _conv3_shift_axis(g, k, axis)
    # the 2^F scale cancels in the count/sum ratio
    grid_f_q8 = _div_q8(g[..., 1], g[..., 0])  # (gx, gy, gz) at Q bits

    # ---- TI (cascaded integer lerps, L1/L2/L3 LUTs) ----
    # L2/L3: spatial fractions: frac(i/r) at Q bits == ((i mod r) << Q) // r
    xf = (((ix % r) << _Q) // r)[:, None]
    yf = (((iy % r) << _Q) // r)[None, :]
    x0 = (ix // r).long()[:, None]
    y0 = (iy // r).long()[None, :]
    z0 = z0.long()

    def corner(di, dj):
        xi = (x0 + di).clamp(0, gx - 1)
        yi = (y0 + dj).clamp(0, gy - 1)
        c0 = grid_f_q8[xi, yi, z0.clamp(0, gz - 1)]
        c1 = grid_f_q8[xi, yi, (z0 + 1).clamp(0, gz - 1)]  # the top bin clamps
        return _lerp_q8(c0, c1, zf)

    v0 = _lerp_q8(corner(0, 0), corner(0, 1), yf)
    v1 = _lerp_q8(corner(1, 0), corner(1, 1), yf)
    v = _lerp_q8(v0, v1, xf)  # Q8 intensity

    out = (v + (1 << (_Q - 1))) >> _Q  # round
    out = torch.clamp(out, 0, int(cfg.intensity_max))
    return out.to(torch.float32)
