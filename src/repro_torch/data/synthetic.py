"""Synthetic data: the port's own copies of the JAX package's
``repro/data/synthetic.py``: the LM token streams ``TokenStream`` and
``lm_batches``, ``synthetic_video`` and the stub modality inputs
``vision_context`` and ``audio_frames``, built in numpy exactly as there,
so both packages see the same values."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.noise import synthetic_image_np

__all__ = ["TokenStream", "lm_batches", "synthetic_video", "synthetic_video_np", "vision_context",
           "audio_frames"]


class TokenStream:
    """Deterministic pseudo-language: t_{i} = (a*t_{i-1} + b*t_{i-2} +
    c*t_{i-3} + noise) mod V with segment resets."""

    def __init__(self, vocab: int, seed: int = 0, noise: float = 0.05):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.coef = (3, 5, 7)

    def sample(self, batch: int, seq: int) -> np.ndarray:
        V = self.vocab
        out = np.empty((batch, seq + 1), np.int32)
        state = self.rng.integers(0, V, size=(batch, 3))
        a, b, c = self.coef
        for t in range(seq + 1):
            nxt = (a * state[:, -1] + b * state[:, -2] + c * state[:, -3]) % V
            flip = self.rng.random(batch) < self.noise
            nxt = np.where(flip, self.rng.integers(0, V, batch), nxt)
            out[:, t] = nxt
            state = np.concatenate([state[:, 1:], nxt[:, None]], axis=1)
        return out


def lm_batches(vocab: int, batch: int, seq: int, steps: int, seed: int = 0) -> Iterator[dict]:
    """Yields {tokens, labels} numpy batches for `steps` steps."""
    stream = TokenStream(vocab, seed)
    for _ in range(steps):
        toks = stream.sample(batch, seq)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def synthetic_video_np(
    key: int, n_frames: int, h: int = 128, w: int = 192, motion: float = 2.0
) -> np.ndarray:
    """Deterministic clean video: a panning crop over one synthetic scene.

    Frame t is an ``(h, w)`` window into a larger
    :func:`repro_torch.core.synthetic_image_np` scene, translated diagonally
    by ``motion`` pixels per frame, so consecutive frames are the same
    content under camera motion. ``motion=0`` gives a static scene (every
    frame identical). Returns float32 ``(n_frames, h, w)`` in [0, 255].
    """
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    span = int(np.ceil(abs(motion) * (n_frames - 1)))
    scene = synthetic_image_np(h + span, w + span, seed=key)
    frames = np.empty((n_frames, h, w), np.float32)
    for t in range(n_frames):
        off = int(round(abs(motion) * t))
        frames[t] = scene[off : off + h, off : off + w]
    return frames


def synthetic_video(
    key: int,
    n_frames: int,
    h: int = 128,
    w: int = 192,
    motion: float = 2.0,
    device=None,
) -> torch.Tensor:
    """:func:`synthetic_video_np` as a float32 tensor on ``device`` (default:
    the CUDA card)."""
    frames = synthetic_video_np(key, n_frames, h, w, motion)
    return torch.from_numpy(frames).to(resolve_device(device))


def vision_context(batch: int, n_tokens: int, dim: int, seed: int = 0) -> np.ndarray:
    """Stub precomputed patch embeddings, float32 numpy (batch, n_tokens, dim)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n_tokens, dim)).astype(np.float32) * 0.02


def audio_frames(batch: int, seq: int, dim: int, seed: int = 0) -> np.ndarray:
    """Stub precomputed frame embeddings for the encoder-only audio arch,
    float32 numpy (batch, seq, dim)."""
    rng = np.random.default_rng(seed)
    t = np.arange(seq)[None, :, None] / 50.0
    base = np.sin(t * (1 + rng.random((batch, 1, dim)) * 4))
    return (base + 0.1 * rng.standard_normal((batch, seq, dim))).astype(np.float32)
