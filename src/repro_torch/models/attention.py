"""Attention: GQA/MQA, global / sliding-window / chunked-causal masks,
logit softcapping, partial RoPE, cross-attention, and decode KV caches
(ring-buffer caches for windowed layers): the port of the JAX package's
``repro/models/attention.py``, in plain PyTorch (the JAX package has no
kernel here either).

Modes:
  train   — full self-attention over (B, S), no cache.
  prefill — as train, but also returns a filled decode cache.
  decode  — S_q == 1 step against the cache; per-sample positions (B,).

Caches are functional, as in JAX: a write returns new tensors and leaves
the caller's cache as it was.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import AttnSpec, ModelConfig

from repro_torch.sharding.compat import is_dtensor
from repro_torch.sharding.partitioning import logical_constraint, logical_constraint_padded

from .layers import apply_rope, dense, dtype_of, init_dense, merge_heads, on_local_shards, rope_angles, splittable

__all__ = ["init_attention", "attention", "init_cache", "NEG_INF"]

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, spec: AttnSpec, lead=(), device=None):
    d = cfg.d_model
    q_dim = cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    dt = dtype_of(cfg.param_dtype)
    kw = dict(dtype=dt, lead=lead, device=device)
    return {
        "q": init_dense(gen, d, q_dim, bias=spec.qkv_bias, **kw),
        "k": init_dense(gen, d, kv_dim, bias=spec.qkv_bias, **kw),
        "v": init_dense(gen, d, kv_dim, bias=spec.qkv_bias, **kw),
        "o": init_dense(gen, q_dim, d, **kw),
    }


def cache_len(cfg: ModelConfig, spec: AttnSpec, max_len: int) -> int:
    if spec.kind == "local" and spec.window:
        return min(spec.window, max_len)
    if spec.kind == "chunked" and spec.chunk:
        return min(spec.chunk, max_len)
    return max_len


def init_cache(cfg: ModelConfig, spec: AttnSpec, batch: int, max_len: int, lead=(), device=None):
    """Decode cache: K/V slots + the absolute position stored in each slot.

    kv_cache_dtype="int8" stores K/V quantized with one fp32 scale per
    (token, kv_head) (KIVI-style per-token quantization)."""
    L = cache_len(cfg, spec, max_len)
    quant = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if quant else dtype_of(cfg.act_dtype)
    shape = (*lead, batch, L, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((*lead, batch, L), -1, dtype=torch.int32, device=device),
    }
    if quant:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def _quantize_kv(t: torch.Tensor):
    """(..., D) -> int8 values + fp32 scale over the last dim. Both divisions
    divide by a tensor (never a Python number, which CUDA torch turns into a
    product with the reciprocal), and ``torch.round`` rounds half to even as
    ``jnp.round`` does."""
    t32 = t.to(torch.float32)
    scale = torch.amax(torch.abs(t32), dim=-1) / torch.tensor(127.0, device=t.device)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q, scale, dt):
    return (q.to(torch.float32) * scale[..., None]).to(dt)


def _split_heads(x, n, d):
    return splittable(x, x.ndim - 1, n).reshape(*x.shape[:-1], n, d)


def _mask_logits(logits, qpos, kpos, spec: AttnSpec):
    """logits (..., Sq, Sk) + positional mask by attention kind.

    kpos may be -1 for empty cache slots (always masked). A row with every
    key masked gets ``NEG_INF`` everywhere: a uniform softmax, not NaN."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    ok = k >= 0
    if spec.causal:
        ok = ok & (k <= q)
    if spec.kind == "local" and spec.window:
        ok = ok & (k > q - spec.window)
    if spec.kind == "chunked" and spec.chunk:
        ok = ok & (torch.div(k, spec.chunk, rounding_mode="floor")
                   == torch.div(q, spec.chunk, rounding_mode="floor"))
    return torch.where(ok, logits, torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device))


# Sequences at least this long route through the online-softmax blocked path
# (prefill_32k would otherwise materialize an S^2 logit tensor).
FLASH_MIN_SEQ = 8192
FLASH_Q_BLOCK = 1024
FLASH_KV_BLOCK = 2048


def _q_scale(q: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(D)`` rounded as the JAX package rounds it: the float32 root
    cast to the query's dtype, then the quotient in that dtype."""
    D = q.shape[-1]
    root = torch.sqrt(torch.tensor(float(D), dtype=torch.float32, device=q.device)).to(q.dtype)
    return 1.0 / root


def _sdpa_plain(q, k, v, qpos, kpos, spec: AttnSpec, softcap: float):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D). GQA grouped einsum."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg * _q_scale(q), k).to(torch.float32)
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = _mask_logits(logits, qpos[:, None, None, :], kpos[:, None, None, :], spec)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)


def _sdpa_blocked(q, k, v, qpos, kpos, spec: AttnSpec, softcap: float,
                  q_block: int = FLASH_Q_BLOCK, kv_block: int = FLASH_KV_BLOCK):
    """FlashAttention-style online softmax over KV blocks inside a loop over
    Q blocks: O(S * block) memory instead of O(S^2). The same math as
    ``_sdpa_plain``, summed in another order."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    if Sq % q_block or Sk % kv_block:
        raise ValueError(f"blocks must divide the sequences: {(Sq, q_block, Sk, kv_block)}")
    qg = (q * _q_scale(q)).reshape(B, Sq, KV, G, D)
    outs = []
    for q0 in range(0, Sq, q_block):
        qblk, qp = qg[:, q0:q0 + q_block], qpos[:, q0:q0 + q_block]
        m = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, q_block, D), dtype=q.dtype, device=q.device)
        for k0 in range(0, Sk, kv_block):
            kblk, vblk = k[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block]
            logits = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk).to(torch.float32)
            if softcap > 0.0:
                logits = softcap * torch.tanh(logits / softcap)
            logits = _mask_logits(logits, qp[:, None, None, :],
                                  kpos[:, None, None, k0:k0 + kv_block], spec)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vblk)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B,qb,KV,G,D)
    return torch.cat(outs, dim=1).reshape(B, Sq, H, D)


def _sdpa(q, k, v, qpos, kpos, spec: AttnSpec, softcap: float):
    """Dispatch: blocked online-softmax path for long sequences; DTensors
    attend on each rank's local shards (``on_local_shards``)."""
    if is_dtensor(q):
        # attention is independent per row and head: each rank attends on
        # its local shards (torch 2.11's DTensor cannot flatten sharded
        # batch and head dims together into the einsums' batched products)
        return on_local_shards(lambda *a: _sdpa(*a, spec, softcap), [q, k, v, qpos, kpos],
                               [(0, 2), (0, 2), (0, 2), (0, None), (0, None)], (0, 2))
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq >= FLASH_MIN_SEQ and Sq == Sk and Sq % FLASH_Q_BLOCK == 0:
        return _sdpa_blocked(q, k, v, qpos, kpos, spec, softcap)
    return _sdpa_plain(q, k, v, qpos, kpos, spec, softcap)


def _apply_rope_qk(q, k, qpos, kpos, spec: AttnSpec, head_dim: int):
    if not spec.rope:
        return q, k
    cq, sq, rot = rope_angles(qpos, head_dim, spec.rope_theta, spec.rope_fraction)
    ck, sk, _ = rope_angles(kpos, head_dim, spec.rope_theta, spec.rope_fraction)
    return apply_rope(q, cq, sq, rot), apply_rope(k, ck, sk, rot)


def _put_rows(c, new, slots):
    """A copy of ``c`` (B, L, ...) with ``new`` (B, m, ...) in ``slots``
    (B, m) of each row."""
    c = c.clone()
    c[torch.arange(c.shape[0], device=c.device)[:, None], slots.long()] = new.to(c.dtype)
    return c


def _head_dim_of(t, dims=(2, 3)):
    """The dim among ``dims`` a DTensor ``t`` is sharded on (its heads, or
    its head_dim where the heads do not divide the mesh axis), else
    ``dims[0]``."""
    if is_dtensor(t):
        for p in t.placements:
            if getattr(p, "dim", None) in dims:
                return p.dim
    return dims[0]


def _write_cache(cache, k_new, v_new, pos_new, slots):
    """A copy of ``cache`` with ``(k_new, v_new, pos_new)`` (B, m, ...) in
    ``slots`` (B, m) of each row (JAX's ``.at[bidx, slots].set``). Each
    write is independent per row and per head, so on a mesh each rank
    writes its own shards (``on_local_shards``; DTensor cannot write the
    indexed rows of a sharded cache in place)."""
    news = {"pos": pos_new.to(torch.int32)}
    if "k_scale" in cache:
        news["k"], news["k_scale"] = _quantize_kv(k_new)
        news["v"], news["v_scale"] = _quantize_kv(v_new)
    else:
        news["k"], news["v"] = k_new, v_new
    out = dict(cache)
    for name, new in news.items():
        c = cache[name]
        h = None if name == "pos" else _head_dim_of(c, (2,) if name.endswith("scale") else (2, 3))
        out[name] = on_local_shards(_put_rows, [c, new, slots], [(0, h), (0, h), (0, None)], (0, h))
    for name in ("k", "v"):
        out[name] = logical_constraint(out[name], "batch", "kv_len", "kv_heads", "kv_dim")
    return out


def _read_cache(cache, dt):
    if "k_scale" in cache:
        return (_dequantize_kv(cache["k"], cache["k_scale"], dt),
                _dequantize_kv(cache["v"], cache["v_scale"], dt))
    return cache["k"].to(dt), cache["v"].to(dt)


def attention(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    spec: AttnSpec,
    positions: torch.Tensor,
    mode: str = "train",
    cache: Optional[dict] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (output (B,S,d_model), updated cache or None).

    kv_override supplies external K/V inputs (cross-attention): K/V are
    projected from the override source; no mask beyond validity; no cache.
    """
    act = dtype_of(cfg.act_dtype)
    S = x.shape[1]
    q = _split_heads(dense(params["q"], x, act), cfg.n_heads, cfg.head_dim)
    # padded constraint: queries are head-sharded even when n_heads does
    # not divide the model axis (llama4: 40/16), see logical_constraint_padded
    q = logical_constraint_padded(q, "batch", "seq", "heads", None)

    if kv_override is not None:
        src, src_pos = kv_override
        k = _split_heads(dense(params["k"], src, act), cfg.n_kv_heads, cfg.head_dim)
        v = _split_heads(dense(params["v"], src, act), cfg.n_kv_heads, cfg.head_dim)
        cross_spec = AttnSpec(kind="global", rope=False, causal=False)
        out = _sdpa(q, k, v, positions, src_pos, cross_spec, spec.softcap)
        y = dense(params["o"], merge_heads(out), act)
        return logical_constraint(y, "batch", "seq", "embed"), None

    k = _split_heads(dense(params["k"], x, act), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(params["v"], x, act), cfg.n_kv_heads, cfg.head_dim)
    k = logical_constraint(k, "batch", "seq", "kv_heads", None)
    v = logical_constraint(v, "batch", "seq", "kv_heads", None)
    q, k = _apply_rope_qk(q, k, positions, positions, spec, cfg.head_dim)

    if mode == "train":
        out = _sdpa(q, k, v, positions, positions, spec, spec.softcap)
        y = dense(params["o"], merge_heads(out), act)
        return logical_constraint(y, "batch", "seq", "embed"), None

    if cache is None:
        raise ValueError(f"mode {mode!r} needs a cache")
    if mode == "prefill":
        out = _sdpa(q, k, v, positions, positions, spec, spec.softcap)
        y = dense(params["o"], merge_heads(out), act)
        L = cache["k"].shape[1]
        m = min(S, L)
        tail = positions[:, S - m:]
        new_cache = _write_cache(cache, k[:, S - m:], v[:, S - m:], tail, tail % L)
        return logical_constraint(y, "batch", "seq", "embed"), new_cache

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode takes one token per row, got {S}")
        L = cache["k"].shape[1]
        new_cache = _write_cache(cache, k, v, positions, positions[:, :1] % L)
        kc, vc = _read_cache(new_cache, q.dtype)
        out = _sdpa(q, kc, vc, positions, new_cache["pos"], spec, spec.softcap)
        y = dense(params["o"], merge_heads(out), act)
        return logical_constraint(y, "batch", "seq", "embed"), new_cache

    raise ValueError(f"unknown mode {mode!r}")
