"""AdamW with fp32 moments and the warm-up + cosine learning-rate schedule:
the port of the JAX package's ``repro/train/optimizer.py``.

State is a tree mirroring the parameters (``m``, ``v``) plus an int32 0-d
``step``, as in JAX (a checkpoint stores the step as int32). The scalar
arithmetic runs in float32 tensors on the parameters' device, as ``jnp``
computes it (the step, ``b1 ** step``, the warm-up ratio, the cosine), and
every quotient divides by a tensor, never by a Python number, so the card
rounds it as the CPU does. Leaves are visited in JAX's leaf order (sorted
dict keys, :func:`repro_torch.models.tree_leaves`).

On DTensor state (parameters laid out on a ``DeviceMesh``) the moments take
each parameter's layout and the update runs on each rank's local shards
(elementwise, so no DTensor op is dispatched). The gradients are first laid
out as their parameters, before the norm: a replicated parameter's gradient
comes out of the backward pass as a ``Partial`` sum over the batch-sharded
ranks, whose local values are addends, not the leaf. The global gradient
norm then sums each rank's share of every leaf's squares into one
``Partial`` value reduced once.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.models.model import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.compat import dtensor_api, is_dtensor

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at_step", "global_norm"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a float32 0-d tensor beside ``like`` (how ``jnp``
    takes a weakly typed scalar into a float32 expression)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_at_step(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio * lr``; ``step`` is
    a tensor (or a number, taken onto the CPU) and the result a float32 0-d
    tensor beside it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = _f32(cfg.lr, step) * step / _f32(max(cfg.warmup_steps, 1), step)
    prog = torch.clamp(
        (step - _f32(cfg.warmup_steps, step))
        / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1), step),
        0.0,
        1.0,
    )
    # the angle in float32, as jnp forms it; its cosine in float64 rounded
    # once to float32 (torch's float32 cosine is off by an ulp where XLA's
    # is correctly rounded)
    angle = _f32(math.pi, step) * prog
    cos = _f32(cfg.min_lr_ratio, step) + _f32((1 - cfg.min_lr_ratio) * 0.5, step) * (
        1 + torch.cos(angle.to(torch.float64)).to(torch.float32)
    )
    return torch.where(step < cfg.warmup_steps, warm, _f32(cfg.lr, step) * cos)


def _owned_share(x):
    """This rank's share of a DTensor leaf's float32 sum of squares: the
    sum over its local shard where this rank is coordinate 0 of every mesh
    dimension ``x`` is replicated over, else 0, so the shares of all ranks
    add up to the leaf's sum once. A ``Partial`` placement is reduced to
    ``Replicate()`` first (its local values are addends of the leaf)."""
    Replicate, Partial = dtensor_api()[2:4]
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p for p in x.placements])
    local = torch.sum(x.to_local().to(torch.float32) ** 2)
    coord = x.device_mesh.get_coordinate()
    owner = all(c == 0 for c, p in zip(coord, x.placements) if isinstance(p, Replicate))
    return local if owner else torch.zeros_like(local)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (JAX's leaf order) of each leaf's
    float32 sum of squares. DTensor leaves add each rank's share in the
    same order into one ``Partial`` sum, reduced once over the mesh; the
    norm is then a plain tensor, the same on every rank."""
    leaves = tree_leaves(tree)
    if leaves and is_dtensor(leaves[0]):
        total = 0
        for x in leaves:
            total = total + _owned_share(x)
        mesh = leaves[0].device_mesh
        for d in range(mesh.ndim):  # the Partial sum, reduced once over the mesh
            dist.all_reduce(total, group=mesh.get_group(d))
        return torch.sqrt(total)
    total = 0
    for x in leaves:
        total = total + torch.sum(x.to(torch.float32) ** 2)
    return torch.sqrt(total)


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` (where they live, in
    their layout on a mesh) and an int32 0-d step."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def adamw_update(grads, opt_state, params, cfg: OptConfig, in_place: bool = False):
    """Returns ``(new_params, new_opt_state, metrics)``, ``metrics`` holding
    the float32 0-d ``lr`` and ``grad_norm``.

    ``in_place=True`` writes the new values into ``params`` and
    ``opt_state``'s tensors and returns those same trees (the port's form
    of JAX's buffer donation: no second copy of parameters and moments
    exists at once); the arithmetic is the same, leaf by leaf. Weight decay
    applies to leaves with ``ndim >= 2`` only."""
    step = opt_state["step"]
    step = (step.to_local() if is_dtensor(step) else step) + 1
    lr = lr_at_step(cfg, step)
    grads = tree_unflatten(grads, [_laid_out_as(g, p) for p, g in zip(tree_leaves(params), tree_leaves(grads))])
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm), _f32(cfg.grad_clip, gnorm) / torch.maximum(gnorm, _f32(1e-9, gnorm)))

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - _f32(b1, stepf) ** stepf
    bc2 = 1.0 - _f32(b2, stepf) ** stepf

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # decay matrices only (standard AdamW practice)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m_new, v_new

    leaves = [tree_leaves(t) for t in (params, grads, opt_state["m"], opt_state["v"])]
    metrics = {"lr": lr, "grad_norm": gnorm}
    if in_place:
        with torch.no_grad():
            for p, g, m, v in zip(*leaves):
                pl, gl, ml, vl = _locals(p, g, m, v)
                p_new, m_new, v_new = upd(pl, gl, ml, vl)
                pl.copy_(p_new)
                ml.copy_(m_new)
                vl.copy_(v_new)
                del p_new, m_new, v_new
            opt_state["step"].copy_(step)
        return params, opt_state, metrics
    out = [_like(p, upd(*_locals(p, g, m, v))) for p, g, m, v in zip(*leaves)]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, metrics


def _laid_out_as(g, p):
    """A gradient leaf redistributed to its parameter's placements where
    they differ (a ``Partial`` sum is reduced); plain tensors as they are."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _locals(p, g, m, v):
    """The four leaves as this rank's local shards of ``p``'s layout; plain
    tensors as they are. The gradient and the moments must already share
    ``p``'s layout."""
    if not is_dtensor(p):
        return p, g, m, v
    if any(tuple(t.placements) != tuple(p.placements) for t in (g, m, v)):
        raise ValueError(f"gradient and moments laid out as {g.placements} / {m.placements} / {v.placements}, "
                         f"the parameter as {p.placements}")
    return p.to_local(), g.to_local(), m.to_local(), v.to_local()


def _like(p, outs):
    """Local results back as DTensors in ``p``'s layout."""
    if not is_dtensor(p):
        return outs
    DTensor = dtensor_api()[0]
    return tuple(DTensor.from_local(o, p.device_mesh, p.placements, run_check=False, shape=p.shape,
                                    stride=p.stride()) for o in outs)
