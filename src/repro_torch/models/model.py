"""Top-level model: a pattern of blocks repeated ``n_repeats`` times, then
the tail blocks: the port of the JAX package's ``repro/models/model.py``.

Parameters and caches keep the JAX layout: every leaf of a pattern block
has a leading ``n_repeats`` axis (JAX stacks them with ``jax.vmap`` and
scans over them with ``jax.lax.scan``); the port loops over the repeats in
Python, indexing the stacked tensors, so the JAX package's trees carry over
as a pure relabel (:func:`params_from_jax`, :func:`caches_from_jax`).

:func:`param_logical_axes` / :func:`cache_logical_axes` give trees of
logical axis names mirroring the parameter and cache trees (resolved to
DTensor layouts by ``repro_torch.sharding.partitioning``), built from meta
tensors. With DTensor parameters under ``axis_rules`` and ``set_mesh`` the
forward pass constrains its activations where JAX does; without a mesh
those constraints do nothing.

In ``mode="train"`` under autograd each repeat's body is rematerialised as
``cfg.remat`` says, as JAX wraps it in ``jax.checkpoint``: ``"full"`` keeps
only the body's inputs and recomputes its activations in the backward pass,
``"dots"`` also keeps the matrix products' outputs (JAX's
``checkpoint_dots``), ``"none"`` keeps everything. The models have no
dropout and no other randomness, so the recomputation gives the same
values and the same loss.
"""
from __future__ import annotations

import functools
import re
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig

from .blocks import block_apply, init_block, init_block_cache
from repro_torch.sharding.partitioning import logical_constraint

from .layers import apply_norm, dense, dtype_of, init_dense, init_embedding, init_norm, mesh_like, on_local_shards

__all__ = [
    "init_params",
    "param_logical_axes",
    "init_caches",
    "cache_logical_axes",
    "splice_cache",
    "forward",
    "model_flops_per_token",
    "params_from_jax",
    "caches_from_jax",
    "tree_map",
    "tree_leaves",
    "tree_unflatten",
]


# ------------------------------------------------------------- trees
def tree_map(fn, tree):
    """``fn`` over every tensor of a nested dict (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict in JAX's leaf order (``jax.tree.leaves``:
    keys sorted at every level; ``None`` is no leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves):
    """A nested dict shaped like ``like`` (its key order kept) whose tensors
    are ``leaves``, taken in :func:`tree_leaves`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        return None if t is None else next(it)

    return build(like)


def _stack(trees):
    """Stack a list of equal nested dicts leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ------------------------------------------------------------------- init
def init_params(seed: int, cfg: ModelConfig, device=None):
    """Parameters of ``cfg`` drawn from ``seed`` on ``device`` (default: the
    CUDA card). Each pattern leaf is drawn whole, ``(n_repeats, ...)``, so a
    full-width model is never held twice. The port's own numbers: the JAX
    package's come across with :func:`params_from_jax`.

    ``device="meta"`` gives the tree's shapes and dtypes only (JAX's
    ``jax.eval_shape`` of this function), as a restore's ``like``; nothing
    is drawn."""
    if str(device) == "meta":
        dev, gen = torch.device("meta"), None
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    params = {}
    if cfg.frontend is None or cfg.frontend == "vision":
        params["embed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, device=dev)
    # audio frontend: inputs arrive as precomputed frame embeddings (stub)
    if cfg.n_repeats > 0:
        params["pattern"] = {
            f"block{i}": init_block(gen, cfg, spec, lead=(cfg.n_repeats,), device=dev)
            for i, spec in enumerate(cfg.pattern)
        }
    if cfg.tail:
        params["tail"] = {f"tail{i}": init_block(gen, cfg, spec, device=dev)
                          for i, spec in enumerate(cfg.tail)}
    params["final_norm"] = init_norm(cfg.d_model, cfg.norm, device=dev)
    if not cfg.tie_embeddings:
        params["head"] = init_dense(gen, cfg.d_model, cfg.vocab_size, dtype=dt, device=dev)
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, by name: two bytes each
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device=None):
    """The JAX package's parameter tree (its leaves as numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) as the port's tensors
    on ``device`` (default: the CUDA card), same dtypes, same shapes: the
    stacked leading ``n_repeats`` axis stays."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def caches_from_jax(tree, device=None):
    """The JAX package's decode caches (numpy leaves: bf16, fp32, int8 and
    int32) as the port's tensors on ``device``, same layout."""
    return params_from_jax(tree, device)


# ------------------------------------------------- logical axes for sharding
_PARAM_AXES_RULES = [
    # (path regex, ndim -> logical axes)
    (r"embed/table", ("vocab", "fsdp")),
    (r"head/kernel", ("fsdp", "vocab")),
    (r"(attn|cross)/(q|k|v)/kernel", ("fsdp", "qkv")),
    (r"(attn|cross)/(q|k|v)/bias", ("qkv",)),
    (r"(attn|cross)/o/kernel", ("qkv", "fsdp")),
    (r"moe/router/kernel", ("fsdp", None)),
    (r"moe/w_(gate|up)", ("expert", "fsdp", "expert_mlp")),
    (r"moe/w_down", ("expert", "expert_mlp", "fsdp")),
    (r"(mlp|shared)/(gate|up)/kernel", ("fsdp", "mlp")),
    (r"(mlp|shared)/down/kernel", ("mlp", "fsdp")),
    (r"mixer/(in_proj|gate_proj|up_proj)/kernel", ("fsdp", "rnn")),
    (r"mixer/(q|k|v|lru_a|lru_x|ifgate)/kernel", (None, "rnn")),
    (r"mixer/rec_proj/kernel", (None, None, "rnn")),  # block-diagonal sLSTM
    (r"mixer/(out_proj|down_proj)/kernel", ("rnn", "fsdp")),
    (r"mixer/conv/kernel", (None, "rnn")),
    (r"mixer/lambda", ("rnn",)),
    (r"in_proj/kernel", ("fsdp", "rnn")),
]

_CACHE_AXES = [
    # kv_heads and kv_dim both map to the model axis; divisibility-aware
    # resolution picks heads when they divide TP, else head_dim (see
    # sharding.partitioning.param_sharding).
    (r"attn/(k|v)$", ("batch", "kv_len", "kv_heads", "kv_dim")),
    (r"attn/(k|v)_scale$", ("batch", "kv_len", "kv_heads")),
    (r"attn/pos$", ("batch", "kv_len")),
    (r"state/(h|c|n|m)$", ("batch", "rnn")),
    (r"state/conv$", ("batch", None, "rnn")),
    (r"state/C$", ("batch", "heads", None, None)),
]


def _annotate(tree, rules, path=()):
    """Logical axes of every leaf of ``tree`` (meta tensors) by the first
    rule whose regex its ``/``-joined path matches, cut or padded with
    ``None`` to the leaf's rank; pattern leaves get a leading ``"stack"``."""
    if isinstance(tree, dict):
        return {k: _annotate(v, rules, path + (str(k),)) for k, v in tree.items()}
    if tree is None:
        return None
    p = "/".join(path)
    stacked = p.startswith("pattern")
    nd = tree.ndim - (1 if stacked else 0)
    axes = (None,) * nd
    for pat, a in rules:
        if re.search(pat, p):
            a = tuple(a)[:nd]
            axes = a + (None,) * (nd - len(a))
            break
    return (("stack",) + axes) if stacked else axes


def param_logical_axes(cfg: ModelConfig):
    """Tree of logical-axis tuples matching :func:`init_params`' structure,
    from meta tensors (no memory at any width). Pattern-stacked leaves get a
    leading ``"stack"`` axis; norms, biases and small vectors replicate."""
    return _annotate(init_params(0, cfg, device="meta"), _PARAM_AXES_RULES)


def cache_logical_axes(cfg: ModelConfig, batch: int, max_len: int):
    """Tree of logical-axis tuples matching :func:`init_caches`' structure
    (meta tensors)."""
    return _annotate(init_caches(cfg, batch, max_len, device="meta"), _CACHE_AXES)


# ----------------------------------------------------------------- caches
def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Decode caches for ``batch`` rows of up to ``max_len`` tokens on
    ``device`` (default: the CUDA card; ``"meta"`` for shapes and dtypes
    only); pattern leaves carry the leading ``n_repeats`` axis."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    caches = {}
    if cfg.n_repeats > 0:
        caches["pattern"] = {
            f"block{i}": init_block_cache(cfg, spec, batch, max_len, lead=(cfg.n_repeats,), device=dev)
            for i, spec in enumerate(cfg.pattern)
        }
    if cfg.tail:
        caches["tail"] = {f"tail{i}": init_block_cache(cfg, spec, batch, max_len, device=dev)
                          for i, spec in enumerate(cfg.tail)}
    return caches


def splice_cache(batched, single, slot: int):
    """A copy of ``batched`` with a batch=1 cache (e.g. from a fresh
    prefill) in row ``slot``. Pattern-stacked leaves carry a leading repeats
    axis, so the batch axis is 1 there and 0 for tail leaves."""
    out = {}
    for part, tree in batched.items():
        def upd(c, n, part=part):
            c = c.clone()
            if part == "pattern":
                c[:, slot] = n[:, 0].to(c.dtype)
            else:
                c[slot] = n[0].to(c.dtype)
            return c

        out[part] = _zip_map(upd, tree, single[part])
    return out


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# ---------------------------------------------------------------- forward
def forward(
    params,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    mode: str = "train",
    caches: Optional[dict] = None,
    cross_ctx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns (logits, new_caches (None in train mode), aux_loss). Runs
    where ``params`` live; the caller's ``caches`` are left as they were."""
    act = dtype_of(cfg.act_dtype)
    if embeds is not None:
        x = embeds.to(act)
    else:
        # on a mesh each rank looks its rows up in the whole table (DTensor
        # cannot shard the lookup's backward on torch 2.11, nor a
        # vocab-sharded lookup's masked partial on 2.13)
        x = on_local_shards(lambda t, table: table[t.long()], [tokens, params["embed"]["table"]],
                            [(0, None), (None, None)], (0, None)).to(act)
    if cfg.emb_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model), device=x.device)).to(act)
    B, S = x.shape[:2]
    if positions is None:
        positions = mesh_like(torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S), x)
    x = logical_constraint(x, "batch", "seq", "embed")
    if cross_ctx is not None:
        cross_ctx = cross_ctx.to(act)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = {}

    if cfg.n_repeats > 0 and mode == "train" and torch.is_grad_enabled():
        # unbind each stacked leaf once: its gradient is then one stack of
        # the repeats' slices, where indexing would scatter every repeat's
        # slice into a zero tensor of the whole stack
        per_r = _unbind(params["pattern"], cfg.n_repeats)

        def repeat_body(x, aux, block_params):
            for i, spec in enumerate(cfg.pattern):
                x, _, a = block_apply(block_params[f"block{i}"], x, cfg, spec, positions,
                                      mode=mode, cross_ctx=cross_ctx)
                aux = aux + a
            return x, aux

        for r in range(cfg.n_repeats):
            if cfg.remat == "none":
                x, aux_total = repeat_body(x, aux_total, per_r[r])
            else:
                x, aux_total = _ckpt.checkpoint(repeat_body, x, aux_total, per_r[r],
                                                use_reentrant=False, **_remat_kwargs(cfg.remat))
    elif cfg.n_repeats > 0:
        per_repeat = []
        for r in range(cfg.n_repeats):
            new_bc = {}
            for i, spec in enumerate(cfg.pattern):
                name = f"block{i}"
                bc = None if not caches else tree_map(lambda t: t[r], caches["pattern"][name])
                x, nc, a = block_apply(tree_map(lambda t: t[r], params["pattern"][name]), x, cfg,
                                       spec, positions, mode=mode, cache=bc, cross_ctx=cross_ctx)
                aux_total = aux_total + a
                if nc is not None:
                    new_bc[name] = nc
            per_repeat.append(new_bc)
        if per_repeat[0]:
            new_caches["pattern"] = _stack(per_repeat)

    for i, spec in enumerate(cfg.tail):
        name = f"tail{i}"
        bc = None if not caches else caches["tail"][name]
        x, nc, a = block_apply(params["tail"][name], x, cfg, spec, positions, mode=mode, cache=bc,
                               cross_ctx=cross_ctx)
        aux_total = aux_total + a
        if nc is not None:
            new_caches.setdefault("tail", {})[name] = nc

    if mode == "prefill" and not cfg.encoder_only:
        # serving prefill only needs next-token logits: slice before the
        # O(S*vocab) head product
        x = x[:, -1:]
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x.to(act), params["embed"]["table"].to(act))
    else:
        logits = dense(params["head"], x, act)
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits.to(torch.float32) / cfg.logit_softcap)
    logits = logical_constraint(logits, "batch", "seq", "vocab")
    return logits, (new_caches if new_caches else None), aux_total


# the matrix products a "dots" remat keeps (JAX's checkpoint_dots): einsum
# and matmul reach autograd as these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(remat: str) -> dict:
    if remat == "full":
        return {}
    if remat == "dots":
        return {"context_fn": functools.partial(_ckpt.create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"remat must be 'full', 'dots' or 'none', got {remat!r}")


def _unbind(tree, n: int) -> list:
    """A stacked tree as ``n`` trees of views, one per repeat."""
    per = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
        for r in range(n):
            per[r][k] = parts[r]
    return per


def model_flops_per_token(cfg: ModelConfig, train: bool = True) -> float:
    """MODEL_FLOPS: 6*N*D per token (dense) / 6*N_active*D (MoE); 2*N for
    forward-only (serving)."""
    n = cfg.active_param_count()
    return (6.0 if train else 2.0) * n


