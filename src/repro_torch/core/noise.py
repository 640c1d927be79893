"""Synthetic evaluation images and noise models.

The paper evaluates on a full-HD grayscale photo plus Gaussian noise with
sigma=30. The synthetic scene carries the same ingredients a natural photo
stresses in an edge-preserving filter: smooth shading gradients, hard
intensity edges (objects), and fine texture. It is built in numpy float64,
exactly as the JAX package builds it, so both packages see the same pixels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = [
    "synthetic_image_np",
    "synthetic_image",
    "synthetic_batch",
    "add_gaussian_noise",
    "NOISE_SIGMA_PAPER",
]

NOISE_SIGMA_PAPER = 30.0


def synthetic_image_np(h: int = 256, w: int = 384, seed: int = 0) -> np.ndarray:
    """Deterministic 'natural-like' grayscale scene in [0, 255], float32 numpy.

    Composition: vignette-like smooth background + several constant-intensity
    ellipses (hard edges) + low-amplitude band texture + mild lumpy shading.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u = xx / w
    v = yy / h

    img = 150.0 + 60.0 * (u - 0.5) + 35.0 * np.sin(2.3 * np.pi * v)

    for _ in range(6):  # hard-edged objects
        cx = rng.uniform(0.12, 0.88) * w
        cy = rng.uniform(0.12, 0.88) * h
        ax = rng.uniform(0.06, 0.22) * w
        ay = rng.uniform(0.06, 0.22) * h
        theta = rng.uniform(0, np.pi)
        level = rng.uniform(20.0, 235.0)
        dx = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
        dy = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
        inside = (dx / ax) ** 2 + (dy / ay) ** 2 <= 1.0
        img = np.where(inside, level, img)

    # fine texture (what the filter must smooth less than noise)
    img = img + 6.0 * np.sin(2 * np.pi * (xx / 7.3 + yy / 11.1))
    # lumpy low-frequency shading
    img = img + 12.0 * np.sin(2 * np.pi * u * 1.7) * np.cos(2 * np.pi * v * 1.3)
    return np.clip(img, 0.0, 255.0).astype(np.float32)


def synthetic_image(
    h: int = 256, w: int = 384, seed: int = 0, device=None
) -> torch.Tensor:
    """:func:`synthetic_image_np` as a float32 tensor on ``device`` (default:
    the CUDA card)."""
    return torch.from_numpy(synthetic_image_np(h, w, seed)).to(resolve_device(device))


def synthetic_batch(
    b: int, h: int = 256, w: int = 384, seed: int = 0, device=None
) -> torch.Tensor:
    """(b, h, w) stack of distinct synthetic scenes (seeds seed..seed+b-1)."""
    frames = np.stack([synthetic_image_np(h, w, seed=seed + i) for i in range(b)])
    return torch.from_numpy(frames).to(resolve_device(device))


def add_gaussian_noise(
    image: torch.Tensor,
    sigma: float = NOISE_SIGMA_PAPER,
    *,
    generator: torch.Generator,
) -> torch.Tensor:
    """image + N(0, sigma^2), clipped to [0,255] and quantized to integers
    (the paper's noisy input is an 8-bit picture).

    The noise comes from ``generator``, which must live on ``image``'s
    device. Its numbers differ from ``jax.random``'s for the same seed, so
    tests that compare the two packages make their noise in numpy.
    """
    noise = torch.randn(
        image.shape, generator=generator, dtype=torch.float32, device=image.device
    )
    noisy = image.to(torch.float32) + sigma * noise
    return torch.clamp(torch.floor(noisy + 0.5), 0.0, 255.0)
