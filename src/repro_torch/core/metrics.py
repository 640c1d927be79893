"""Image-quality metrics: MSSIM (Wang et al. 2004, as configured in the paper)
and PSNR.

The paper fixes C1 = (0.01*255)^2, C2 = (0.03*255)^2 and uses a 7x7 square
(uniform) window; MSSIM is the mean of the SSIM map over valid positions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mssim", "psnr"]

_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over win x win windows, 'valid' region only."""
    return F.avg_pool2d(x[None, None], win, stride=1)[0, 0]


def mssim(a: torch.Tensor, b: torch.Tensor, win: int = 7) -> torch.Tensor:
    """Mean structural similarity between two [0,255] grayscale (h, w) images."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    mu_a = _uniform_filter(a, win)
    mu_b = _uniform_filter(b, win)
    mu_aa = _uniform_filter(a * a, win)
    mu_bb = _uniform_filter(b * b, win)
    mu_ab = _uniform_filter(a * b, win)
    var_a = torch.clamp(mu_aa - mu_a * mu_a, min=0.0)
    var_b = torch.clamp(mu_bb - mu_b * mu_b, min=0.0)
    cov = mu_ab - mu_a * mu_b
    ssim_map = ((2.0 * mu_a * mu_b + _C1) * (2.0 * cov + _C2)) / (
        (mu_a * mu_a + mu_b * mu_b + _C1) * (var_a + var_b + _C2)
    )
    return ssim_map.mean()


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(255.0**2 / torch.clamp(mse, min=1e-12))
