"""Gradient compression for the data-parallel mean: the port of the JAX
package's ``repro/train/grad_compress.py``.

int8 quantize -> integer sum -> dequantize, with one scale shared by every
shard of a leaf (the largest magnitude over all shards / 127, JAX's
``pmax``), so the sum is exact in integer space. Two forms, equal bit for
bit on the same data (integer sums and maxima are exact in any order):

* over a ``DeviceMesh``, JAX's form: the port's ``shard_map`` over the DP
  axes, ``all_reduce(MAX)`` of the scale and ``all_reduce(SUM)`` of the
  int32 codes over each DP axis's group;
* over the port's ``BatchMesh``, which has no collectives (ROADMAP M2): the
  leading axis is split over the mesh's devices, the scale is the maximum of
  the shards' maxima, and the int32 sum is taken on the mesh's first
  device, then divided by the shard count and sent back to every shard's
  rows, gathered on the first device as every mesh dispatch of the port is.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.models.model import tree_map
from repro_torch.sharding.compat import mesh_axis_sizes, shard_map
from repro_torch.sharding.partitioning import PartitionSpec as P

__all__ = ["compressed_mean_grads", "quantize_dequantize_roundtrip"]


def _scale(m: torch.Tensor) -> torch.Tensor:
    return torch.clamp(m / torch.tensor(127.0, device=m.device), min=1e-20)


def _psum_int8(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean of ``shards`` (one per device, in mesh order) through int8:
    ``(sum_i round(g_i / s)) * s / n`` with ``s = max_i max|g_i| / 127``;
    the mean broadcast back to every shard, concatenated on the first
    shard's device."""
    home = shards[0].device
    scale = _scale(torch.stack([torch.max(torch.abs(g)).to(home) for g in shards]).max())
    total = torch.zeros(shards[0].shape, dtype=torch.int32, device=home)
    for g in shards:
        s = scale.to(g.device)
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int32)
        total = total + q.to(home)
    n = torch.tensor(float(len(shards)), device=home)
    mean = (total.to(torch.float32) * scale) / n
    return torch.cat([mean] * len(shards), dim=0)


def _psum_int8_group(g: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """JAX's ``_psum_int8`` on this rank's local gradient: the scale's
    maximum and the codes' sum over each of ``axes``' groups."""
    m = torch.max(torch.abs(g))
    for a in axes:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    scale = _scale(m)
    total = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
    n = 1
    for a in axes:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
        n *= mesh_axis_sizes(mesh)[a]
    return (total.to(torch.float32) * scale) / torch.tensor(float(n), device=g.device)


def compressed_mean_grads(grads, mesh, dp_axes=("pod", "data")):
    """Mean-reduce per-shard grads over the DP axes with int8 compression.

    ``grads``: tree of tensors laid out so that the DP axes are pure
    replicas, JAX's ``P(*axes)``: over a ``DeviceMesh`` DTensors (or each
    rank's same full tensors, cut here), over a ``BatchMesh`` tensors whose
    leading axis is split over its devices. A mesh with none of
    ``dp_axes`` returns ``grads`` as they are."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        axes = tuple(a for a in dp_axes if a in names)
        if not axes:
            return grads
        fn = shard_map(lambda g: tree_map(lambda x: _psum_int8_group(x, mesh, axes), g), mesh,
                       in_specs=(P(*axes),), out_specs=P(*axes))
        return fn(grads)
    axes = tuple(a for a in dp_axes if a in mesh.axis_names)
    if not axes:
        return grads
    nd = mesh.size

    def reduce_leaf(x):
        if x.shape[0] % nd:
            raise ValueError(f"leading axis {x.shape[0]} does not split over {nd} devices")
        shards = [c.to(d) for c, d in zip(torch.chunk(x, nd, dim=0), mesh.devices)]
        return _psum_int8(shards)

    return tree_map(reduce_leaf, grads)


def quantize_dequantize_roundtrip(x, axes_n: int = 1):
    """Reference for tests: the numerical effect of one compress round-trip."""
    scale = _scale(torch.max(torch.abs(x)))
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale
