"""The active mesh and a hand-written ``shard_map`` over DTensors: the port
of the JAX package's ``repro/sharding/compat.py``.

JAX's shims pick between spellings of ``shard_map`` and ``set_mesh`` that
moved between JAX releases; the port's counterpart is PyTorch's
``torch.distributed.tensor`` (DTensor over a ``DeviceMesh``). Its public
names (``DTensor``, ``Shard``, ``Replicate``, ``Partial``,
``distribute_tensor``; the same path on torch 2.11 and 2.13) are imported
here and only here, so a move between torch releases is mended in one
place. ``shard_map`` is written by hand
(``torch.distributed.tensor.experimental.local_map`` is experimental and
moves between releases):

* each DTensor input is redistributed to its spec's placements, and each
  plain tensor (the same full value on every rank) is cut to them, with no
  communication;
* ``fn`` runs on the local shards;
* each output is wrapped with ``DTensor.from_local`` as its spec says;
* under autograd, an input's gradient is summed over the mesh axes that
  split the work (JAX's transpose of ``shard_map``).

The models' per-row and per-head ops that DTensor cannot shard
(``models/layers.py::on_local_shards``) build their specs and run through
this one function too.

Specs are :class:`PartitionSpec` (a tuple per tensor dimension of a mesh
axis name, a tuple of names or ``None``); a dict tree of specs may stand
for a dict tree of inputs, and one spec for every leaf, as in JAX.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["PartitionSpec", "shard_map", "set_mesh", "get_active_mesh", "dtensor_api", "is_dtensor",
           "spec_placements"]

_state = threading.local()
_api = None


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: per tensor dimension a mesh axis name, a
    tuple of names (one dimension over several axes, major first) or
    ``None`` (replicated). A one-name tuple reads as the name, as in JAX."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def dtensor_api():
    """``(DTensor, Shard, Replicate, Partial, distribute_tensor)``, imported
    at first use (importing this module touches no process group)."""
    global _api
    if _api is None:
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

        _api = (DTensor, Shard, Replicate, Partial, distribute_tensor)
    return _api


def is_dtensor(x) -> bool:
    return isinstance(x, dtensor_api()[0])


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active one on this thread, for
    logical-axis sharding (``logical_constraint``) and the models' own
    tensors; the previous one comes back on exit."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def get_active_mesh():
    """The mesh made active by :func:`set_mesh` on this thread, or ``None``."""
    return getattr(_state, "mesh", None)


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``, a
    tuple ``shape``) or of any mesh with ``axis_names`` and a ``shape``
    mapping (JAX's ``Mesh``, the port's ``MeshShape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def spec_placements(spec, mesh):
    """The DTensor placements (one per mesh dimension) of a partition spec:
    ``Shard(i)`` on each mesh axis that tensor dimension ``i`` names, else
    ``Replicate()``. A tuple entry shards one dimension over several axes,
    major first; DTensor orders them by mesh dimension, so the tuple must
    follow the mesh's axis order, else ``ValueError``. A mesh axis of size 1
    holds every dimension whole, so its placement is ``Replicate()`` (the
    same layout; DTensor will not reshape a size-1 dimension sharded over
    one rank)."""
    _, Shard, Replicate, _, _ = dtensor_api()
    sizes = mesh_axis_sizes(mesh)
    names = list(sizes)
    owner = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {tuple(spec)} shards dim {dim} over {axes}, not in the mesh's axis order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {tuple(spec)} uses mesh axis {a!r} twice")
            owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1 else Replicate() for a in names)


def _tree_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts and tuples; one spec stands
    for every leaf below it (JAX's prefix rule)."""
    if isinstance(specs, PartitionSpec):
        if isinstance(tree, dict):
            return {k: _tree_map(fn, v, specs) for k, v in tree.items()}
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], specs[k]) for k in tree}
    return tuple(_tree_map(fn, t, s) for t, s in zip(tree, specs))


def _specs(tree) -> list:
    """The :class:`PartitionSpec` leaves of a spec tree."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    return [s for t in (tree.values() if isinstance(tree, dict) else tree) for s in _specs(t)]


def to_mesh(x, mesh, placements):
    """``x`` laid out as ``placements`` on ``mesh``: a DTensor is
    redistributed; a plain tensor, the same full value on every rank, is
    taken as replicated and cut locally (no communication)."""
    DTensor, _, Replicate, _, _ = dtensor_api()
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return x.redistribute(mesh, placements)


def _from_local(y, mesh, placements):
    """A rank's local result as a DTensor: its global shape is the local one
    times the ranks that shard each dimension (even shards)."""
    DTensor, Shard = dtensor_api()[:2]
    shape = list(y.shape)
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard):
            shape[p.dim] *= size
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(y.contiguous(), mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def shard_map(fn, mesh, in_specs, out_specs):
    """``fn`` on each rank's local shards: the port of ``jax.shard_map``.

    Returns a function of the same positional inputs as ``fn``; ``in_specs``
    is a tuple (one spec or spec tree per input), ``out_specs`` a spec or a
    tree of them (dicts, tuples) matching ``fn``'s output. Outputs are
    DTensors on ``mesh``.

    Under autograd the transpose is JAX's: on a mesh axis that some spec
    shards (the work is split over it), an input replicated over that axis
    is an addend on every rank of it, so its gradient is summed there
    (``Partial``); on an axis no spec names every rank computes the same
    thing, and the gradient stays replicated."""
    _, _, Replicate, Partial, _ = dtensor_api()
    names = list(mesh_axis_sizes(mesh))
    split = {a for s in _specs(tuple(in_specs)) + _specs(out_specs) for e in s if e is not None
             for a in ((e,) if isinstance(e, str) else e)}

    def local(x, spec):
        placements = spec_placements(spec, mesh)
        grads = [Partial() if isinstance(p, Replicate) and n in split else p for n, p in zip(names, placements)]
        return to_mesh(x, mesh, placements).to_local(grad_placements=grads)

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} inputs for {len(in_specs)} specs")
        out = fn(*[_tree_map(local, a, spec) for a, spec in zip(args, in_specs)])
        return _tree_map(lambda y, s: _from_local(y, mesh, spec_placements(s, mesh)), out, out_specs)

    return wrapped
