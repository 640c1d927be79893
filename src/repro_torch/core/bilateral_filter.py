"""Exact bilateral filter (eq. 1), the paper's comparison baseline, and a
plain Gaussian blur, in PyTorch.

Direct O((2r+1)^2) sliding-window evaluation, one pass per window offset in
the JAX package's order (``repro/core/bilateral_filter.py``). Border
handling: out-of-image pixels carry zero weight (valid-mask padding). Both
functions take an (h, w) frame or a (b, h, w) batch (the JAX functions take
one frame) and run on the CUDA card unless the caller passes
``device="cpu"``. No kernel: plain tensor operations, as ``jnp`` there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["bilateral_filter", "gaussian_blur"]


def _frames(image, device) -> torch.Tensor:
    x = torch.as_tensor(image, dtype=torch.float32, device=resolve_device(device))
    if x.dim() not in (2, 3):
        raise ValueError(f"expected (h, w) or (b, h, w) frames, got {tuple(x.shape)}")
    return x


def bilateral_filter(
    image,
    r: int,
    sigma_s: float,
    sigma_r: float,
    quantize_output: bool = True,
    *,
    device=None,
) -> torch.Tensor:
    """f_BF(i) = (1/k) sum_j g_ss(j) g_sr(f(i)-f(i-j)) f(i-j), j in [-r, r]^2.

    ``quantize_output`` rounds half up and clips to [0, 255], as the JAX
    function does."""
    image = _frames(image, device)
    h, w = image.shape[-2:]
    pad = torch.nn.functional.pad(image, (r, r, r, r))  # zero pad
    mask = torch.nn.functional.pad(
        torch.ones((h, w), dtype=torch.float32, device=image.device), (r, r, r, r)
    )
    offs = np.stack(
        np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij"), axis=-1
    ).reshape(-1, 2)
    spatial = np.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2) / (2.0 * sigma_s**2)).astype(np.float32)
    offs = offs + r  # shift into padded coordinates
    inv_2sr2 = 1.0 / (2.0 * sigma_r**2)

    num = torch.zeros_like(image)
    den = torch.zeros_like(image)
    for (oi, oj), ws in zip(offs.tolist(), spatial.tolist()):
        shifted = pad[..., oi : oi + h, oj : oj + w]
        wr = torch.exp(-((image - shifted) ** 2) * inv_2sr2)
        wgt = ws * wr * mask[oi : oi + h, oj : oj + w]
        num = num + wgt * shifted
        den = den + wgt
    out = num / den  # center tap weight 1 => den >= 1
    if quantize_output:
        out = torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)
    return out


def gaussian_blur(image, r: int, sigma: float, *, device=None) -> torch.Tensor:
    """Plain (non-edge-preserving) Gaussian blur, the naive denoiser
    strawman: edge padding and one separable pass of 2r+1 taps per axis."""
    image = _frames(image, device)
    taps = np.exp(-np.arange(-r, r + 1) ** 2 / (2.0 * sigma**2))
    taps = (taps / taps.sum()).astype(np.float32).tolist()

    def conv1d(x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim]
        edge = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)  # edge padding
        xp = x.index_select(dim, edge)
        out = torch.zeros_like(x)
        for k in range(2 * r + 1):
            out = out + taps[k] * xp.narrow(dim, k, n)
        return out

    return conv1d(conv1d(image, -2), -1)
