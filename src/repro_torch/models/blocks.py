"""Composable transformer/recurrent blocks driven by BlockSpec: the port of
the JAX package's ``repro/models/blocks.py``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig

from .attention import attention, init_attention, init_cache
from .layers import apply_norm, dtype_of, init_norm, mesh_like
from .moe import ffn_apply, init_ffn, init_moe, moe_ffn
from .recurrent import (
    init_mlstm_block,
    init_mlstm_state,
    init_rglru_block,
    init_rglru_state,
    init_slstm_block,
    init_slstm_state,
    mlstm_block,
    rglru_block,
    slstm_block,
)

__all__ = ["init_block", "block_apply", "init_block_cache"]

_MIXERS = {"rglru": (init_rglru_block, rglru_block, init_rglru_state),
           "mlstm": (init_mlstm_block, mlstm_block, init_mlstm_state),
           "slstm": (init_slstm_block, slstm_block, init_slstm_state)}


def init_block(gen, cfg: ModelConfig, spec: BlockSpec, lead=(), device=None):
    """One block's parameters, each with the leading axes ``lead``."""
    d = cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    p = {"ln1": init_norm(d, cfg.norm, **kw)}
    if spec.kind == "attn":
        p["attn"] = init_attention(gen, cfg, spec.attn, **kw)
    elif spec.kind in _MIXERS:
        p["mixer"] = _MIXERS[spec.kind][0](gen, cfg, **kw)
    else:
        raise ValueError(spec.kind)
    if spec.cross_attn:
        p["ln_x"] = init_norm(d, cfg.norm, **kw)
        p["cross"] = init_attention(gen, cfg, spec.attn, **kw)
    if spec.post_norm:
        p["ln1_post"] = init_norm(d, cfg.norm, **kw)
    if spec.moe is not None:
        p["ln2"] = init_norm(d, cfg.norm, **kw)
        p["moe"] = init_moe(gen, cfg, spec.moe, **kw)
    elif spec.ffn != "none":
        p["ln2"] = init_norm(d, cfg.norm, **kw)
        p["mlp"] = init_ffn(gen, d, cfg.d_ff, spec.ffn, dt, **kw)
    if spec.post_norm and (spec.moe is not None or spec.ffn != "none"):
        p["ln2_post"] = init_norm(d, cfg.norm, **kw)
    return p


def init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, max_len: int, lead=(),
                     device=None):
    """Decode state of one block, each tensor with the leading axes ``lead``."""
    if spec.kind == "attn":
        return {"attn": init_cache(cfg, spec.attn, batch, max_len, lead=lead, device=device)}
    if spec.kind in _MIXERS:
        return {"state": _MIXERS[spec.kind][2](cfg, batch, lead=lead, device=device)}
    raise ValueError(spec.kind)


def block_apply(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: BlockSpec,
    positions: torch.Tensor,
    mode: str = "train",
    cache: Optional[dict] = None,
    cross_ctx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Pre-norm residual block. Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}

    # --- cross-attention sublayer (vision-text), before self mixing
    if spec.cross_attn:
        if cross_ctx is None:
            raise ValueError("a cross_attn block needs cross_ctx")
        h = apply_norm(params["ln_x"], x, cfg.norm)
        n_ctx = cross_ctx.shape[1]
        src_pos = mesh_like(torch.arange(n_ctx, dtype=torch.int32, device=x.device)[None].expand(x.shape[0], n_ctx), x)
        y, _ = attention(params["cross"], h, cfg, spec.attn, positions, mode="train",
                         kv_override=(cross_ctx.to(h.dtype), src_pos))
        x = x + y

    # --- token mixer
    h = apply_norm(params["ln1"], x, cfg.norm)
    if spec.kind == "attn":
        y, c = attention(params["attn"], h, cfg, spec.attn, positions, mode=mode,
                         cache=None if cache is None else cache.get("attn"))
        if c is not None:
            new_cache["attn"] = c
    else:
        y, st = _MIXERS[spec.kind][1](params["mixer"], h, cfg, mode=mode,
                                      state=None if cache is None else cache.get("state"))
        if st is not None:
            new_cache["state"] = st
    if spec.post_norm:
        y = apply_norm(params["ln1_post"], y, cfg.norm)
    x = x + y

    # --- FFN / MoE
    if spec.moe is not None:
        h = apply_norm(params["ln2"], x, cfg.norm)
        y, aux = moe_ffn(params["moe"], h, cfg, spec.moe)
    elif spec.ffn != "none":
        h = apply_norm(params["ln2"], x, cfg.norm)
        y = ffn_apply(params["mlp"], h, spec.ffn, dtype_of(cfg.act_dtype))
    else:
        y = None
    if y is not None:
        if spec.post_norm:
            y = apply_norm(params["ln2_post"], y, cfg.norm)
        x = x + y

    return x, (new_cache if new_cache else None), aux
