"""Basic layers as plain functions over nested dicts of tensors: the port of
the JAX package's ``repro/models/layers.py``.

Every layer has an ``init_*(gen, ..., lead=(), device=)`` that draws its
parameters from a ``torch.Generator`` (``lead`` prepends stacked axes: the
model stacks each pattern block's parameters along a leading ``n_repeats``
axis, as the JAX package does with ``jax.vmap``) and an apply function.
The parameters of the JAX package come across with
:func:`repro_torch.models.params_from_jax`; the port's own init draws other
numbers from the same shapes and scales.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.compat import PartitionSpec, dtensor_api, is_dtensor, shard_map

__all__ = [
    "dtype_of",
    "init_dense",
    "dense",
    "init_norm",
    "apply_norm",
    "init_embedding",
    "rope_angles",
    "apply_rope",
    "cross_entropy_loss",
    "mesh_like",
    "on_local_shards",
    "splittable",
    "merge_heads",
]


def mesh_like(t: torch.Tensor, like) -> torch.Tensor:
    """A tensor the model makes itself (positions, rope tables, masks, zero
    states, iotas, one-hots) laid out beside ``like``: when ``like`` is a
    DTensor, ``t`` (the same full value on every rank) becomes a DTensor on
    ``like``'s mesh, replicated, with no communication; otherwise (or when
    ``t`` is a DTensor already) ``t`` as it is, so without a mesh the
    models compute what they always did."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    DTensor, _, Replicate, _, _ = dtensor_api()
    mesh = like.device_mesh
    return DTensor.from_local(t.contiguous(), mesh, [Replicate()] * mesh.ndim, run_check=False)


def on_local_shards(fn, args, dims, out_dims):
    """``fn`` on each rank's local shards, for an op that is independent per
    row (and per head) and that DTensor cannot shard (or, on torch 2.11,
    cannot flatten or differentiate): builds the specs and runs ``fn``
    through :func:`repro_torch.sharding.compat.shard_map`. ``dims[i]`` is
    ``args[i]``'s (row dim, head dim), either ``None``; ``out_dims`` the
    same for each output (one pair for a single output, a list for a
    tuple). Rows stay sharded over each mesh axis that shards ``args[0]``'s
    row dim evenly; heads over each that shards every head dim evenly (so a
    rank's heads meet their own); the rest is replicated first. An argument
    without a row (head) dim is whole on every rank of such an axis, and
    ``shard_map`` sums its gradient over them. Plain arguments are taken as
    replicated; with no DTensor among ``args``, just ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    Shard, Replicate = dtensor_api()[1:3]
    lead, r0 = args[0], dims[0][0]
    heads_in = [(a, h) for a, (_, h) in zip(args, dims) if h is not None]
    placed = lambda a, m: a.placements[m] if is_dtensor(a) else Replicate()
    rows = heads = 1
    row_axes, head_axes = [], []
    for m, (name, size) in enumerate(zip(mesh.mesh_dim_names, mesh.shape)):
        p = placed(lead, m)
        if r0 is not None and isinstance(p, Shard) and p.dim == r0 and lead.shape[r0] % (rows * size) == 0:
            rows *= size
            row_axes.append(name)
        elif heads_in and all(isinstance(placed(a, m), Shard) and placed(a, m).dim == h
                              and a.shape[h] % (heads * size) == 0 for a, h in heads_in):
            heads *= size
            head_axes.append(name)

    def spec(d, output=False):
        """The spec of a tensor with (row, head) dims ``d``; an output must
        have each dim the mesh splits."""
        entries = [None] * (max((x for x in d if x is not None), default=-1) + 1)
        for axes, dim in ((row_axes, d[0]), (head_axes, d[1])):
            if axes and dim is None and output:
                raise ValueError(f"an output with (row, head) dims {d} on a mesh splitting rows over "
                                 f"{row_axes}, heads over {head_axes}")
            if axes and dim is not None:
                entries[dim] = tuple(axes)
        return PartitionSpec(*entries)

    out_specs = tuple(spec(d, True) for d in out_dims) if isinstance(out_dims, list) else spec(out_dims, True)
    return shard_map(fn, mesh, tuple(spec(d) for d in dims), out_specs)(*args)


def splittable(x, dim: int, n: int):
    """``x`` ready to split dimension ``dim`` into ``(n, ...)``: a DTensor
    sharded on it over more ranks than ``n`` divides is replicated along it
    first (DTensor cannot unflatten such a shard; GSPMD pads instead).
    Shards that divide, and plain tensors, stay as they are."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    Shard, Replicate = dtensor_api()[1:3]
    on_dim = [isinstance(p, Shard) and p.dim % x.ndim == dim for p in x.placements]
    ways = 1
    for size, hit in zip(mesh.shape, on_dim):
        ways *= size if hit else 1
    if n % ways == 0:
        return x
    return x.redistribute(mesh, [Replicate() if hit else p for p, hit in zip(x.placements, on_dim)])


class _MergeHeads(torch.autograd.Function):
    """A DTensor's last two dims merged; the gradient is split back
    through :func:`splittable`."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, g.ndim - 1, ctx.shape[-2]).reshape(ctx.shape)


def merge_heads(x):
    """``(..., H, D) -> (..., H*D)``. On a DTensor the gradient's merged dim
    may come back sharded over more ranks than ``H`` divides, which DTensor
    cannot unflatten: the backward replicates it first (:func:`splittable`),
    the mirror of splitting heads forward."""
    return _MergeHeads.apply(x) if is_dtensor(x) else x.reshape(*x.shape[:-2], -1)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def normal(gen: torch.Generator, shape, scale, dtype, device) -> torch.Tensor:
    """Standard normal numbers from ``gen`` in float32, times ``scale``, cast
    to ``dtype`` (the JAX package's ``(normal(key, shape) * scale).astype``)."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def init_dense(gen, in_dim, out_shape, bias=False, scale=None, dtype=torch.float32, lead=(),
               device=None):
    """Dense kernel of shape ``(*lead, in_dim, *out_shape)`` with fan-in init."""
    if isinstance(out_shape, int):
        out_shape = (out_shape,)
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = {"kernel": normal(gen, (*lead, in_dim, *out_shape), scale, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((*lead, *out_shape), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor, act_dtype=None) -> torch.Tensor:
    """x @ kernel (+ bias); contraction over the last axis of x.

    With ``act_dtype`` the kernel is cast to it on every call, as in the JAX
    package (a float32 kernel read, an ``act_dtype`` copy written and read).
    Without it, mixed operands promote as ``jnp`` promotes them."""
    kernel = p["kernel"]
    if act_dtype is not None:
        kernel = kernel.to(act_dtype)
        x = x.to(act_dtype)
    else:
        dt = torch.promote_types(x.dtype, kernel.dtype)
        kernel, x = kernel.to(dt), x.to(dt)
    out_shape = kernel.shape[1:]
    y = (x.reshape(-1, x.shape[-1]) @ kernel.reshape(kernel.shape[0], -1)).reshape(
        *x.shape[:-1], *out_shape
    )
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def init_norm(dim, kind="rmsnorm", lead=(), device=None):
    ones = torch.ones((*lead, dim), dtype=torch.float32, device=device)
    if kind == "layernorm":
        return {"scale": ones, "bias": torch.zeros_like(ones)}
    return {"scale": ones}


def apply_norm(p, x: torch.Tensor, kind="rmsnorm", eps=1e-6) -> torch.Tensor:
    """Normalization in float32 (mixed-precision safe), cast back to x.dtype.
    LayerNorm's variance is the population variance, as ``jnp.var``'s."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    if kind == "layernorm":
        mu = torch.mean(x32, -1, keepdim=True)
        var = torch.var(x32, -1, keepdim=True, correction=0)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = torch.mean(x32 * x32, -1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps)
        scale = p["scale"]
        if kind == "rmsnorm_p1":  # gemma: (1 + w)
            scale = 1.0 + scale
        y = y * scale
    return y.to(dt)


def init_embedding(gen, vocab, dim, dtype=torch.float32, lead=(), device=None):
    return {"table": normal(gen, (*lead, vocab, dim), 0.02, dtype, device)}


# ----------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim, theta=10000.0, fraction=1.0):
    """(B,S) int positions -> (B,S,rot/2) cos/sin tables.

    fraction < 1 rotates only the first rot = fraction*head_dim dims
    (stablelm partial rotary)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = mesh_like(torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device), positions) / rot
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs  # (B,S,rot/2)
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x: torch.Tensor, cos, sin, rot) -> torch.Tensor:
    """x: (B,S,H,D). Rotate first `rot` dims pairwise (interleaved halves)."""
    if rot == 0:
        return x
    xr = x[..., :rot]
    xp = x[..., rot:]
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2, xp], dim=-1)


def cross_entropy_loss(logits, labels, mask=None, z_loss=1e-4) -> torch.Tensor:
    """Mean token cross-entropy in fp32, with optional z-loss regularizer;
    the training loss (``repro_torch.train.loss_fn``), differentiated by
    autograd."""
    logits = logits.to(torch.float32)
    Shard = dtensor_api()[1]
    if is_dtensor(logits) and any(isinstance(p, Shard) and p.dim % logits.ndim == logits.ndim - 1
                                  for p in logits.placements):
        # vocab sharded on a mesh, vocab-parallel: the log-sum-exp from
        # each rank's vocab shard with its max and sum reduced over the
        # shards, and the label's logit as a masked sum (each rank compares
        # its own vocab ids) reduced into lse's layout. DTensor's logsumexp
        # would gather the whole vocab on every rank, and its gather's
        # backward make the zeros and the gradient whole on every rank
        from repro_torch.sharding.partitioning import logical_constraint

        m = logical_constraint(torch.amax(logits.detach(), dim=-1), "batch", "seq")
        lse = torch.log(logical_constraint(torch.sum(torch.exp(logits - m[..., None]), dim=-1), "batch", "seq")) + m
        vocab = logical_constraint(mesh_like(torch.arange(logits.shape[-1], device=logits.device), logits), "vocab")
        hit = labels.long()[..., None] == vocab
        ll = torch.where(hit, logits, torch.zeros((), dtype=logits.dtype, device=logits.device)).sum(-1)
        ll = ll.redistribute(ll.device_mesh, lse.placements)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])
        if is_dtensor(ll):
            ll = ll.redistribute(ll.device_mesh, lse.placements)
        ll = ll[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse**2
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
