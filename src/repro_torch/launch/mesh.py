"""Production mesh construction, the port of the JAX package's
``repro/launch/mesh.py``.

Defined as functions (never module-level constants), so importing this
module touches no process group. JAX's ``LATENCY_HIDING_FLAGS`` are XLA TPU
flags and are not carried over (ROADMAP "No TPU constants"); the port's
launches pass none.
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "production_mesh_shape", "dp_size"]


def production_mesh_shape(*, multi_pod: bool = False):
    """The production mesh's axis names and sizes (a ``MeshShape``): 16x16 =
    256 devices per pod, 2 pods = 512 multi-pod. Enough to resolve every
    spec without a process group of that size."""
    from repro_torch.sharding.partitioning import MeshShape

    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh``: ``(16, 16)`` ``("data", "model")``, or
    ``(2, 16, 16)`` with ``pod``. Needs an initialized process group of
    exactly that many ranks, else ``RuntimeError`` naming the size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_mesh_shape(multi_pod=multi_pod)
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if have != shape.size:
        raise RuntimeError(f"the production mesh {shape.sizes} needs a process group of {shape.size} ranks, "
                           f"this process has {have or 'none'}")
    return init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.axis_names)


def dp_size(mesh) -> int:
    """Total data-parallel ways (pod x data)."""
    from repro_torch.sharding.compat import mesh_axis_sizes

    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in ("pod", "data"):
        if a in sizes:
            n *= sizes[a]
    return n
