"""train_step: microbatch gradient accumulation + AdamW, the port of the JAX
package's ``repro/train/train_step.py``.

The JAX step scans over the microbatches under ``jax.value_and_grad``; the
port runs the same microbatches in order through autograd, each backward
pass adding its float32 gradients into the leaves' ``.grad`` (the same
additions in the same order as JAX's float32 accumulator, which starts at
zero). The steps run eagerly, as ``ServeEngine``'s do. Metrics are
float32 0-d tensors.

On DTensor parameters (laid out on a ``DeviceMesh``, under ``axis_rules``
and ``set_mesh``) each microbatch comes onto the parameters' mesh sharded
on its batch axis, and after each backward pass the accumulated gradients
are constrained to the parameters' logical axes, as JAX constrains its
accumulator (``_constrain_like_params``); the loss is gathered to a plain
tensor, the same on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, param_logical_axes, tree_leaves, tree_map, tree_unflatten
from repro_torch.models.layers import cross_entropy_loss, dtype_of, mesh_like
from repro_torch.sharding.compat import is_dtensor
from repro_torch.sharding.partitioning import current_rules, logical_constraint

from .optimizer import OptConfig, adamw_init, adamw_update

__all__ = ["loss_fn", "make_train_step", "init_train_state"]


def loss_fn(params, cfg: ModelConfig, batch, cast_params: bool = True):
    """``batch`` keys: ``tokens`` or ``embeds``, ``labels``, optional
    ``cross_ctx`` and ``loss_mask`` (tensors where ``params`` live).
    Returns ``(loss, {"ce", "aux"})``.

    ``cast_params``: cast float32 weight matrices (``ndim >= 2``) to the
    activation dtype before the forward pass, inside the autograd graph, so
    their gradients come back in float32 onto the float32 master weights
    (the transpose of JAX's cast)."""
    act = dtype_of(cfg.act_dtype)
    if cast_params and act != torch.float32:
        params = tree_map(
            lambda p: p.to(act) if (p.dtype == torch.float32 and p.ndim >= 2) else p, params
        )
    kw = {k: batch[k] for k in ("tokens", "embeds", "cross_ctx") if k in batch}
    logits, _, aux = forward(params, cfg, mode="train", **kw)
    ce = cross_entropy_loss(logits, batch["labels"], batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def init_train_state(params):
    return adamw_init(params)


# the logical axes of each batch input's leading dims (the rest replicate)
_BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"), "loss_mask": ("batch", "seq"),
               "embeds": ("batch", "seq", "embed"), "cross_ctx": ("batch", None, "embed")}


def _onto_mesh(micro: dict, like) -> dict:
    """A microbatch (the same full tensors on every rank) beside DTensor
    parameters: replicated on their mesh, then constrained to its batch
    axes (a local cut, no communication)."""
    return {k: logical_constraint(mesh_like(v, like), *_BATCH_AXES.get(k, ("batch",))) for k, v in micro.items()}


def _constrain_like_params(leaves, axes):
    """Each leaf's ``.grad`` laid out as its parameter's logical axes say
    (JAX's accumulator constraint: the data-parallel sum lands in the
    parameter's shard); a no-op without rules."""
    if current_rules() is None:
        return
    for p, a in zip(leaves, axes):
        if p.grad is not None:
            p.grad = logical_constraint(p.grad, *a)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, donate: bool = False):
    """Builds ``train_step(params, opt_state, batch) -> (new_params,
    new_opt_state, metrics)``, ``metrics`` holding ``loss``, ``lr`` and
    ``grad_norm``.

    Gradient accumulation: the batch's leading dim is split into
    ``cfg.grad_accum`` microbatches taken in order, gradients summed in
    float32 and divided by the count, and so is the loss. The batch (numpy
    or tensors) moves to the parameters' device.

    The step leaves its inputs as they were, as JAX's does. ``donate=True``
    writes the new parameters and optimizer state into the given tensors
    instead and returns those trees: the port's form of ``jit``'s
    ``donate_argnums`` (JAX's ``donate`` argument has no effect), which
    saves a second copy of parameters and moments at once."""
    accum = max(1, cfg.grad_accum)
    axes_cache = []

    def leaf_axes():
        if not axes_cache:
            axes_cache.append(tree_leaves(param_logical_axes(cfg)))
        return axes_cache[0]

    def train_step(params, opt_state, batch):
        flat = tree_leaves(params)
        dev = flat[0].device
        meshed = is_dtensor(flat[0])
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}  # as jit moves them
        # aliases of the parameters' storage that autograd may write
        # gradients onto, so the caller's tensors stay as they were
        leaves = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
        live = tree_unflatten(params, leaves)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(accum):
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                     for k, v in batch.items()} if accum > 1 else batch
            if meshed:
                micro = _onto_mesh(micro, flat[0])
            l, _ = loss_fn(live, cfg, micro)
            l.backward()
            if meshed:
                _constrain_like_params(leaves, leaf_axes())
                l = l.full_tensor()
            loss = loss + l.detach()
        grads = [torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
                 if p.grad is None else p.grad.to(torch.float32) for p in leaves]
        if accum > 1:  # the summed .grad buffers are the step's own: divide in place
            n = torch.tensor(float(accum), dtype=torch.float32, device=dev)
            for g in grads:
                g.div_(n)
            loss = loss / n
        for p in leaves:
            p.grad = None
        del live, leaves
        new_params, new_opt, opt_metrics = adamw_update(
            tree_unflatten(params, grads), opt_state, params, opt_cfg, in_place=donate
        )
        return new_params, new_opt, {"loss": loss, **opt_metrics}

    return train_step
