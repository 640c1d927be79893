"""input_specs(): meta-tensor stand-ins for every model input of every (arch x
shape) cell, the port of the JAX package's ``repro/launch/specs.py``.

JAX's ``ShapeDtypeStruct`` becomes a tensor on the ``meta`` device (ROADMAP
L4): the same shape and dtype, no storage, shardable as a DTensor. Token,
label and position ids are int64, the integer type the port's
``ServeEngine`` and train step take for ids (ROADMAP L3), where JAX's are
int32; every other dtype, the caches' included, is JAX's.

Modality frontends are STUBS, as in the JAX package: [vlm] cells get
precomputed patch embeddings as cross-attention context; [audio] cells get
precomputed frame embeddings instead of tokens.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import cache_logical_axes, init_caches
from repro_torch.models.layers import dtype_of

__all__ = ["input_specs", "batch_logical_axes", "effective_accum", "shape_cfg"]


def shape_cfg(cfg: ModelConfig, shape: ShapeSpec, dp: int) -> ModelConfig:
    """Per-cell config adjustments: accumulation that divides the mesh."""
    if shape.kind != "train":
        return dataclasses.replace(cfg, grad_accum=1)
    accum = effective_accum(cfg.grad_accum, shape.global_batch, dp)
    return dataclasses.replace(cfg, grad_accum=accum)


def effective_accum(requested: int, global_batch: int, dp: int) -> int:
    """Largest accum <= requested such that each microbatch still divides the
    DP ways (gb % (accum*dp) == 0); falls back to 1."""
    for a in range(min(requested, max(global_batch // dp, 1)), 0, -1):
        if global_batch % (a * dp) == 0:
            return a
    return 1


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The batch tree for one cell, as meta tensors (tokens, labels and
    positions int64; the decode caches are ``init_caches(cfg, B, S,
    device="meta")``)."""
    act = dtype_of(cfg.act_dtype)
    B, S = shape.global_batch, shape.seq_len
    ids = torch.int64

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.frontend == "audio":
            batch["embeds"] = sds((B, S, cfg.d_model), act)
        else:
            batch["tokens"] = sds((B, S), ids)
        if shape.kind == "train":
            batch["labels"] = sds((B, S), ids)
        if cfg.frontend == "vision":
            batch["cross_ctx"] = sds((B, cfg.cross_attn_tokens, cfg.d_model), act)
        return batch

    if shape.kind == "decode":
        batch = {"tokens": sds((B, 1), ids), "positions": sds((B,), ids)}
        if cfg.frontend == "vision":
            batch["cross_ctx"] = sds((B, cfg.cross_attn_tokens, cfg.d_model), act)
        # the KV/recurrent cache at context length S
        batch["caches"] = init_caches(cfg, B, S, device="meta")
        return batch

    raise ValueError(shape.kind)


def batch_logical_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Logical axes tree matching input_specs (resolved by partitioning)."""
    axes = {}
    if shape.kind in ("train", "prefill"):
        tok = ("batch", "seq")
        if cfg.frontend == "audio":
            axes["embeds"] = ("batch", "seq", "embed")
        else:
            axes["tokens"] = tok
        if shape.kind == "train":
            axes["labels"] = tok
        if cfg.frontend == "vision":
            axes["cross_ctx"] = ("batch", None, "embed")
        return axes
    axes = {"tokens": ("batch", None), "positions": ("batch",)}
    if cfg.frontend == "vision":
        axes["cross_ctx"] = ("batch", None, "embed")
    axes["caches"] = cache_logical_axes(cfg, shape.global_batch, shape.seq_len)
    return axes
