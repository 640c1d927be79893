"""The shared sharding helper of the JAX package's ``repro/launch/dryrun.py``
(``_shard_tree``, which the train launcher uses as JAX's does). The rest of
the dry-run (lowering every arch x shape x mesh cell, its memory, cost and
roofline terms) is not ported yet (ROADMAP A11d); this module holds only
this function until then.
"""
from __future__ import annotations

from repro_torch.models.model import tree_leaves, tree_unflatten
from repro_torch.sharding.partitioning import param_sharding

__all__ = ["_shard_tree"]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _shard_tree(axes_tree, mesh, rules, shapes_tree=None):
    """A tree of ``NamedSharding`` for a tree of logical-axis tuples on
    ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``); with ``shapes_tree`` (a
    tree of tensors or meta tensors of the same structure) each assignment
    that does not divide its dimension is dropped (``param_sharding``'s
    rule)."""
    flat_axes = tree_leaves(axes_tree)
    if not all(_is_axes(a) for a in flat_axes):
        raise ValueError("axes_tree's leaves must be tuples of logical axis names")
    if shapes_tree is None:
        out = [param_sharding(a, mesh, rules) for a in flat_axes]
    else:
        flat_shapes = tree_leaves(shapes_tree)
        if len(flat_shapes) != len(flat_axes):
            raise ValueError(f"{len(flat_axes)} axes for {len(flat_shapes)} shapes")
        out = [param_sharding(a, mesh, rules, shape=tuple(s.shape)) for a, s in zip(flat_axes, flat_shapes)]
    return tree_unflatten(axes_tree, out)
