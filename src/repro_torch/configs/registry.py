"""Architecture registry: --arch <id> -> config, plus per-cell skip rules (the
port's copy of the JAX package's ``repro/configs/registry.py``)."""
from __future__ import annotations

from typing import Callable, Optional

from .base import ModelConfig, SHAPES, ShapeSpec
from . import (
    gemma2_9b,
    hubert_xlarge,
    llama4_scout_17b_a16e,
    llama_3_2_vision_11b,
    qwen1_5_110b,
    qwen2_moe_a2_7b,
    recurrentgemma_9b,
    stablelm_1_6b,
    xlstm_350m,
    yi_6b,
)

__all__ = ["ARCHS", "get_config", "get_smoke_config", "cell_skip_reason", "all_cells"]

_MODULES = {
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "yi-6b": yi_6b,
    "stablelm-1.6b": stablelm_1_6b,
    "qwen1.5-110b": qwen1_5_110b,
    "gemma2-9b": gemma2_9b,
    "xlstm-350m": xlstm_350m,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "hubert-xlarge": hubert_xlarge,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCHS = tuple(_MODULES)

# archs with bounded decode state (sub-quadratic attention / recurrent):
# only these run the long_500k cell (spec: skip pure full-attention archs)
_SUBQUADRATIC = {"xlstm-350m", "recurrentgemma-9b"}
_ENCODER_ONLY = {"hubert-xlarge"}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return _MODULES[arch].full_config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()


def cell_skip_reason(arch: str, shape: str) -> Optional[str]:
    """None if the (arch x shape) cell runs; otherwise the documented reason."""
    s = SHAPES[shape]
    if s.kind == "decode" and arch in _ENCODER_ONLY:
        return "encoder-only: no decode step"
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return "full-attention arch: 500k decode needs sub-quadratic attention"
    return None


def all_cells():
    """Every runnable (arch, shape) pair + the skip table."""
    runnable, skipped = [], []
    for a in ARCHS:
        for s in SHAPES:
            reason = cell_skip_reason(a, s)
            (skipped if reason else runnable).append((a, s, reason))
    return runnable, skipped
