"""Elastic rescaling: restore any checkpoint onto any mesh, the port of the
JAX package's ``repro/checkpoint/elastic.py``.

Checkpoints are mesh-agnostic (full logical arrays), so scaling from N to M
devices is: build the new ``DeviceMesh``, resolve each parameter's logical
axes against it, and read each full leaf on the host and put only this
rank's shard of it onto the mesh (``device_put``). Combined with the auto-resume of ``Trainer`` this
gives restart-with-a-different-topology: drop to a spare-sized mesh,
resume, scale back later.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_params, param_logical_axes, tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding.partitioning import DEFAULT_RULES, NamedSharding, PartitionSpec, device_put, param_sharding
from repro_torch.train.optimizer import adamw_init

from .manager import CheckpointManager

__all__ = ["train_state_shardings", "elastic_restore", "lay_out"]


def train_state_shardings(cfg: ModelConfig, mesh, rules: Optional[dict] = None):
    """``NamedSharding`` trees for ``(params, opt_state)`` on ``mesh`` from
    the logical axes (``m`` and ``v`` as the parameters, ``step``
    replicated)."""
    rules = rules or DEFAULT_RULES
    p_sh = tree_map(lambda a: param_sharding(a, mesh, rules), param_logical_axes(cfg))
    opt_sh = {"m": p_sh, "v": p_sh, "step": NamedSharding(mesh, PartitionSpec())}
    return p_sh, opt_sh


def lay_out(tree, shardings):
    """Each leaf of ``tree`` laid out as the same-shaped ``shardings`` tree
    says (``device_put``: each rank keeps only its shard), leaf by leaf."""
    leaves = tree_leaves(tree)
    sh = tree_leaves(shardings)
    if len(leaves) != len(sh):
        raise ValueError(f"{len(leaves)} leaves for {len(sh)} shardings")
    return tree_unflatten(tree, [device_put(x, s) for x, s in zip(leaves, sh)])


def elastic_restore(
    ckpt: CheckpointManager,
    cfg: ModelConfig,
    mesh,
    step: Optional[int] = None,
    rules: Optional[dict] = None,
):
    """Restore ``(params, opt_state, meta)`` laid out on ``mesh`` (a
    ``DeviceMesh``), as JAX's ``load_pytree(..., shardings)`` does: into
    meta-tensor ``like`` trees, each leaf read on the host and put straight
    onto the mesh as :func:`train_state_shardings` says, so a rank's device
    only ever holds its own shards."""
    like_p = init_params(0, cfg, device="meta")
    like_o = adamw_init(like_p)
    p_sh, o_sh = train_state_shardings(cfg, mesh, rules)
    state, meta = ckpt.restore({"params": like_p, "opt": like_o}, step=step, shardings={"params": p_sh, "opt": o_sh})
    return state["params"], state["opt"], meta
