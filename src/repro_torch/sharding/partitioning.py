"""Logical-axis sharding rules (MaxText-style) resolved to DTensor
placements: the port of the JAX package's ``repro/sharding/partitioning.py``.

Models annotate activations and parameters with *logical* axis names; a
rules table maps those to physical mesh axes. JAX lowers the result to
``NamedSharding`` + ``with_sharding_constraint`` and lets GSPMD propagate
it; the port lays tensors out as DTensors over a ``DeviceMesh``, whose ops
propagate sharding in the same way, and turns a constraint into
``DTensor.redistribute``. GSPMD pads a dimension that does not divide its
mesh axis; DTensor shards it unevenly (``logical_constraint_padded``).

Usage:
    with axis_rules(DEFAULT_RULES), set_mesh(mesh):
        y = logical_constraint(x, "batch", "seq", "embed")

Spec resolution needs only the mesh's axis names and sizes, so it takes a
``DeviceMesh``, a plain :class:`MeshShape` (the production meshes'
specs are resolved with no process group of that size) or any mesh with
``axis_names`` and a ``shape`` mapping.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch._device import resolve_device

from .compat import PartitionSpec, dtensor_api, get_active_mesh, is_dtensor, mesh_axis_sizes, spec_placements

__all__ = [
    "DEFAULT_RULES",
    "SP_RULES",
    "MeshShape",
    "NamedSharding",
    "PartitionSpec",
    "axis_rules",
    "current_rules",
    "device_put",
    "logical_constraint",
    "logical_constraint_padded",
    "logical_spec",
    "param_sharding",
    "get_abstract_mesh",
]

# logical axis -> physical mesh axis (or tuple of axes, or None = replicate)
DEFAULT_RULES: dict[str, object] = {
    # activations
    "batch": ("pod", "data"),  # data parallel
    "seq": None,  # sequence replicated (see SP_RULES)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",  # EP: experts over the TP axis
    "expert_mlp": "model",  # TP-mode MoE: expert hidden dim over TP axis
    "kv_len": None,
    "kv_dim": "model",  # fallback TP axis for KV caches when heads don't divide
    # params
    "fsdp": ("pod", "data"),  # ZeRO-3 axis for the non-TP param dim
    "conv_k": None,
    "rnn": "model",
    "stack": None,  # scan-stacked layer axis
}

# Megatron-style sequence parallelism for the residual stream: long-context
# prefill shards activations along seq instead of replicating them.
SP_RULES = dict(DEFAULT_RULES, seq=("pod", "data"), batch=None)

_state = threading.local()


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices: enough to resolve
    specs (the 256- and 512-chip production meshes have no process group
    here)."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``). ``placements`` are the
    DTensor placements, one per mesh dimension."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    @property
    def placements(self):
        return spec_placements(self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({mesh_axis_sizes(self.mesh)}, {self.spec!r})"


def _local_shard(x, mesh, placements):
    """This rank's piece of the full tensor ``x`` as DTensor cuts it: along
    each ``Shard`` placement in mesh-dimension order, ``torch.chunk``'s
    piece at this rank's coordinate (empty past the last piece)."""
    Shard = dtensor_api()[1]
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            pieces = torch.chunk(x, mesh.shape[m], dim=p.dim)
            x = pieces[coord[m]] if coord[m] < len(pieces) else x.narrow(p.dim, 0, 0)
    return x


def device_put(x, sharding: NamedSharding):
    """``x`` (the same full tensor on every rank, wherever it lives: a host
    array read from a checkpoint, say) as a DTensor laid out by
    ``sharding`` on its ``DeviceMesh``. Each rank cuts its own shard where
    ``x`` is and moves only that to the mesh's device, with no
    communication, so a leaf never needs its full size on the device
    unless it is replicated. A DTensor is redistributed. Returns ``x``
    unchanged for ``None`` (JAX's unspecified sharding)."""
    if sharding is None:
        return x
    mesh, placements = sharding.mesh, sharding.placements
    if is_dtensor(x):
        return x.redistribute(mesh, placements)
    dev = resolve_device(mesh.device_type)
    x = x.detach()
    local = _local_shard(x, mesh, placements)
    if local is not x or x.device != dev or not x.is_contiguous():  # a piece of x, or x elsewhere: a copy
        local = local.to(dev, copy=True, memory_format=torch.contiguous_format)
    stride = [1] * x.ndim
    for i in range(x.ndim - 2, -1, -1):
        stride[i] = stride[i + 1] * x.shape[i + 1]
    return dtensor_api()[0].from_local(local, mesh, placements, run_check=False, shape=x.shape,
                                       stride=tuple(stride))


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: dict):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def get_abstract_mesh():
    """The active mesh (``set_mesh``), or ``None``."""
    return get_active_mesh()


def logical_spec(
    names: Sequence[Optional[str]],
    rules: Optional[dict] = None,
    shape: Optional[Sequence[int]] = None,
    mesh=None,
) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec under the current rules
    and the active mesh (or ``mesh``).

    With ``shape``, axes whose dimension does not divide the mesh axis are
    dropped (GSPMD would otherwise pad, e.g. 4 kv heads forced onto a
    16-way axis)."""
    rules = rules or current_rules() or {}
    mesh = mesh if mesh is not None else get_abstract_mesh()
    sizes = mesh_axis_sizes(mesh) if mesh is not None else {}
    used: set = set()

    def resolve(i, name):
        if name is None:
            return None
        phys = rules.get(name)
        if phys is None:
            return None
        cand = [phys] if isinstance(phys, str) else list(phys)
        cand = [a for a in cand if a in sizes and a not in used]
        if shape is not None:
            dim = shape[i]
            picked = []
            for a in cand:
                if dim % sizes[a] == 0:
                    picked.append(a)
                    dim //= sizes[a]
            cand = picked
        if not cand:
            return None
        used.update(cand)
        if isinstance(phys, str):
            return cand[0]
        return tuple(cand)

    resolved = [resolve(i, n) for i, n in enumerate(names)]
    # drop trailing Nones for a tidy spec
    while resolved and resolved[-1] is None:
        resolved.pop()
    return PartitionSpec(*resolved)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``. Its gradient comes back in
    ``x``'s layout, as ``DTensor.redistribute``'s does, except on a mesh
    dimension where ``x`` was ``Partial``: there the gradient keeps the
    constraint's placement (the transpose of JAX's
    ``with_sharding_constraint`` constrains the cotangent alike). A
    ``Partial`` gradient left unreduced in the residual stream makes
    DTensor gather whole weights and repeat their products on every rank."""

    @staticmethod
    def forward(ctx, x, placements):
        Partial = dtensor_api()[3]
        ctx.grad_placements = tuple(out if isinstance(p, Partial) else p for p, out in zip(x.placements, placements))
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.grad_placements:
            g = g.redistribute(g.device_mesh, ctx.grad_placements)
        return g, None


def _constrain(x, spec):
    if all(s is None for s in spec):
        return x
    mesh = x.device_mesh
    placements = spec_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return _Constrain.apply(x, placements)


def logical_constraint(x, *names):
    """``with_sharding_constraint`` by logical names: ``x`` redistributed to
    the resolved spec's placements. A no-op without rules and an active
    mesh, or when ``x`` is no DTensor. Divisibility-aware: never shards a
    dimension unevenly."""
    if current_rules() is None or get_abstract_mesh() is None or not is_dtensor(x):
        return x
    return _constrain(x, logical_spec(names, shape=x.shape, mesh=x.device_mesh))


def logical_constraint_padded(x, *names):
    """Like :func:`logical_constraint` but WITHOUT the divisibility check:
    GSPMD pads the dimension, DTensor shards it unevenly. Used for attention
    queries with heads that do not divide the model axis (llama4: 40 heads
    on 16-way TP): sharded heads cost some idle ranks, where unsharded heads
    would contract over head_dim and all-reduce the S^2 logits."""
    if current_rules() is None or get_abstract_mesh() is None or not is_dtensor(x):
        return x
    return _constrain(x, logical_spec(names, mesh=x.device_mesh))


def param_sharding(logical_axes, mesh, rules: Optional[dict] = None, shape=None) -> NamedSharding:
    """NamedSharding for a parameter annotated with logical axes.

    With ``shape``, any assignment whose dimension is not divisible by the
    mesh axes it would claim is dropped (replicated) WITHOUT consuming the
    mesh axis, so a later logical axis can claim it instead: a KV cache
    annotated (batch, kv_len, kv_heads, kv_dim) lands on head-dim TP when
    kv_heads (8) does not divide the 16-way model axis."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axis_sizes(mesh)
    used = set()

    def resolve(i, name):
        if name is None:
            return None
        phys = rules.get(name)
        if phys is None:
            return None
        cand = [phys] if isinstance(phys, str) else list(phys)
        cand = [a for a in cand if a in sizes and a not in used]
        if not cand:
            return None
        if shape is not None:
            dim = shape[i]
            picked = []
            for a in cand:
                n = sizes[a]
                if dim % n == 0 and dim // n >= 1:
                    picked.append(a)
                    dim //= n
            cand = picked
        if not cand:
            return None
        used.update(cand)
        if isinstance(phys, str):
            return cand[0]
        return tuple(cand)

    spec = PartitionSpec(*[resolve(i, n) for i, n in enumerate(logical_axes)])
    spec_placements(spec, mesh)  # raises where a tuple breaks the mesh's axis order
    return NamedSharding(mesh, spec)
