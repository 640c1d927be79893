"""AdamW with fp32 moments and the warm-up + cosine learning-rate schedule:
the port of the JAX package's ``repro/train/optimizer.py``.

State is a tree mirroring the parameters (``m``, ``v``) plus an int32 0-d
``step``, as in JAX (a checkpoint stores the step as int32). The scalar
arithmetic runs in float32 tensors on the parameters' device, as ``jnp``
computes it (the step, ``b1 ** step``, the warm-up ratio, the cosine), and
every quotient divides by a tensor, never by a Python number, so the card
rounds it as the CPU does. Leaves are visited in JAX's leaf order (sorted
dict keys, :func:`repro_torch.models.tree_leaves`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.model import tree_leaves, tree_map, tree_unflatten

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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (JAX's leaf order) of each leaf's
    float32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(x.to(torch.float32) ** 2)
    return torch.sqrt(total)


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` (where they live) and
    an int32 0-d step."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
    step = opt_state["step"] + 1
    lr = lr_at_step(cfg, step)
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
                p_new, m_new, v_new = upd(p, g, m, v)
                p.copy_(p_new)
                m.copy_(m_new)
                v.copy_(v_new)
                del p_new, m_new, v_new
            opt_state["step"].copy_(step)
        return params, opt_state, metrics
    out = [upd(p, g, m, v) for p, g, m, v in zip(*leaves)]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}, metrics
