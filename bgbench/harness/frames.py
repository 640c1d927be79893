"""The frame pool: noisy 8-bit grayscale frames made on the device from the
seed, in a few large calls.

A scene is a smooth shaded background with hard-edged ellipses, a fine
texture and lumpy shading (the ingredients a natural photo stresses in an
edge-preserving filter; the program's ``core/noise.py`` scene, drawn here
on the device). Pool frame ``j`` is a crop of scene ``j // per_scene``,
panned diagonally by ``motion_px`` pixels per frame, plus Gaussian noise of
``noise_sigma``, rounded half up and clipped to [0, 255]: values a camera
delivers, held as float32 on the device.
"""
from __future__ import annotations

import math

import torch

__all__ = ["make_pool"]


def _scenes(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None] / h
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :] / w
    # per scene: 6 ellipses x (cx, cy, ax, ay, theta, level), uniform in [0, 1)
    p = torch.rand((n, 6, 6), generator=gen, device=device)
    cx, cy = 0.12 + 0.76 * p[..., 0], 0.12 + 0.76 * p[..., 1]
    ax, ay = 0.06 + 0.16 * p[..., 2], 0.06 + 0.16 * p[..., 3]
    th, level = math.pi * p[..., 4], 20.0 + 215.0 * p[..., 5]
    out = torch.empty((n, h, w), dtype=torch.float32, device=device)
    for s in range(n):
        img = 150.0 + 60.0 * (xx - 0.5) + 35.0 * torch.sin(2.3 * math.pi * yy)
        img = img.expand(h, w).clone()
        for k in range(6):
            dx = (xx - cx[s, k]) * w
            dy = (yy - cy[s, k]) * h
            c, sn = torch.cos(th[s, k]), torch.sin(th[s, k])
            u = (dx * c + dy * sn) / (ax[s, k] * w)
            v = (-dx * sn + dy * c) / (ay[s, k] * h)
            img = torch.where(u * u + v * v <= 1.0, level[s, k], img)
        img = img + 6.0 * torch.sin(2 * math.pi * (xx * w / 7.3 + yy * h / 11.1))
        img = img + 12.0 * torch.sin(2 * math.pi * xx * 1.7) * torch.cos(2 * math.pi * yy * 1.3)
        out[s] = img.clamp(0.0, 255.0)
    return out


def make_pool(seed: int, n_frames: int, h: int, w: int, *, scenes: int, motion_px: float,
              noise_sigma: float, device) -> torch.Tensor:
    """``(n_frames, h, w)`` float32 frames on ``device``, the same for the
    same seed on the same kind of device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    per = -(-n_frames // scenes)
    span = int(math.ceil(motion_px * (per - 1)))
    big = _scenes(gen, scenes, h + span, w + span, device)
    pool = torch.empty((n_frames, h, w), dtype=torch.float32, device=device)
    for j in range(n_frames):
        off = int(round(motion_px * (j % per)))
        pool[j] = big[j // per, off:off + h, off:off + w]
    del big
    for lo in range(0, n_frames, 16):
        part = pool[lo:lo + 16]
        noise = torch.randn(part.shape, generator=gen, device=device)
        part.add_(noise.mul_(noise_sigma)).add_(0.5).floor_().clamp_(0.0, 255.0)
    return pool
