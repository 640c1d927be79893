"""Modality frontends, stubs as in the JAX package's
``repro/models/frontends.py``: the [audio] / [vlm] archs specify the
transformer backbone only, and the frontend supplies precomputed frame or
patch embeddings. The specs are meta tensors (PyTorch's shape-and-dtype
stand-in, JAX's ``ShapeDtypeStruct``); the inputs come from the numpy
stubs of :mod:`repro_torch.data.synthetic`, the JAX package's numbers. The
real-data path runs the paper's BG denoiser first
(:func:`repro_torch.data.vlm_preprocess`, :func:`repro_torch.data.spectrogram_denoise`).
"""
from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import audio_frames, vision_context

__all__ = [
    "input_specs_vision_ctx",
    "input_specs_audio_embeds",
    "make_vision_inputs",
    "make_audio_inputs",
]


def _require(cfg: ModelConfig, frontend: str) -> None:
    if cfg.frontend != frontend:
        raise ValueError(f"{cfg.name} has frontend {cfg.frontend!r}, not {frontend!r}")


def input_specs_vision_ctx(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """Cross-attention context stand-in: (B, n_patches(+cls), d_model)."""
    _require(cfg, "vision")
    return torch.empty((batch, cfg.cross_attn_tokens, cfg.d_model), dtype=torch.bfloat16, device="meta")


def input_specs_audio_embeds(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    """Frame-embedding stand-in replacing tokens: (B, S, d_model)."""
    _require(cfg, "audio")
    return torch.empty((batch, seq, cfg.d_model), dtype=torch.bfloat16, device="meta")


def make_vision_inputs(cfg: ModelConfig, batch: int, seed: int = 0, device=None) -> torch.Tensor:
    return torch.from_numpy(vision_context(batch, cfg.cross_attn_tokens, cfg.d_model, seed)).to(
        resolve_device(device))


def make_audio_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, device=None) -> torch.Tensor:
    return torch.from_numpy(audio_frames(batch, seq, cfg.d_model, seed)).to(resolve_device(device))
